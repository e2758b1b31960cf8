"""The lookup: which table slot, if any, answers each query 8-mer.

``scan`` is the reference's forward-only merge-join (KmerGutsJava.java
:944-1034) as it is written: queries in (home, value) order, home = value
mod numSigs; with no probe in flight the table stream skips forward to the
next query's home and never back; every query whose home is the slot
being read joins the probes in flight; an empty slot ends them all, a slot
holding a probed value answers every query of that value.

``probe`` answers each query on its own: the first slot from its home on
that holds its value, unless an empty slot comes first. On a table whose
scan never runs off its last slot the two give the same answers: the
scan reaches every query's home before any later one (queries are taken
in home order, and while probes are in flight it reads slot by slot), so
each query is probed from its home, and it stops at the same slot. A probe
that runs past the last slot, where the reference throws EOFException,
raises here: the benchmark's tables keep their last slot empty.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .table import MAX_ENCODED, Table


class ScanPastEnd(RuntimeError):
    pass


def probe(table: Table, values: np.ndarray) -> np.ndarray:
    """The answering slot of each query, -1 where none answers."""
    kmer = table.slots["kmer"]
    values = np.asarray(values, dtype=np.int64)
    at = values % np.int64(table.num_sigs)
    slot = np.full(len(values), -1, dtype=np.int64)
    live = np.arange(len(values))
    while live.size:
        where = at[live]
        if int(where.max()) >= table.num_sigs:
            raise ScanPastEnd("a probe ran past the table's last slot")
        got = kmer[where]
        hit = got == values[live]
        slot[live[hit]] = where[hit]
        live = live[~hit & (got <= MAX_ENCODED)]
        at[live] += 1
    return slot


def scan(table: Table, values: np.ndarray) -> np.ndarray:
    """The same answers by the reference's own scan (slow: for tests)."""
    values = np.asarray(values, dtype=np.int64)
    home = values % np.int64(table.num_sigs)
    order = np.lexsort((values, home))
    vals, homes = values[order].tolist(), home[order].tolist()
    kmer = table.slots["kmer"]
    slot = np.full(len(values), -1, dtype=np.int64)
    in_flight: Dict[int, List[int]] = {}
    cur, qi, nq = 0, 0, len(vals)
    while qi < nq or in_flight:
        needed = cur
        if not in_flight:
            needed = homes[qi]
            in_flight[vals[qi]] = [qi]
            qi += 1
        while qi < nq and homes[qi] == needed:
            in_flight.setdefault(vals[qi], []).append(qi)
            qi += 1
        cur = max(cur, needed)
        if cur >= table.num_sigs:
            raise ScanPastEnd("the scan ran past the table's last slot")
        which = int(kmer[cur])
        if which > MAX_ENCODED:
            in_flight.clear()
        else:
            for q in in_flight.pop(which, ()):
                slot[order[q]] = cur
        cur += 1
    return slot
