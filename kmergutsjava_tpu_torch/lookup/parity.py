"""Exact emulation of the reference's streaming merge-join lookup.

This is the parity oracle: a faithful re-implementation of the reference's
forward-only single-pass scan (lookup, 
KmerGutsJava.java:944-1034), including its edge semantics:

- queries are consumed in ascending (home, value) order, where
  home = value % numSigs (comparator, ref :1082-1094);
- when no probes are in flight the scan jumps forward to the next query's
  home slot; it NEVER rewinds (ref :991-994), so on adversarial table
  layouts it can differ from textbook linear probing — we reproduce the
  scan, not the textbook;
- all queries whose home equals the slot being read join the in-flight set
  (ref :976-989);
- an empty slot (whichKmer > MAX_ENCODED) kills every in-flight probe
  (ref :1000-1001); a value match converts the waiting queries to hits
  (ref :1004-1016);
- reading past the last slot mirrors the reference's EOFException, which
  run() catches to produce a partial report (ref :797-802).

For tables built by our builder the vectorized backends are provably
hit-equivalent (see lookup/xla.py); this module exists to pin down behavior
on arbitrary tables and as the ground truth for differential tests.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ..constants import MAX_ENCODED
from ..formats.kmer_table import KmerTable


class TableTruncatedError(Exception):
    """Raised when the scan runs off the end of the table (Java EOFException).

    The reference prints ``Error: null`` (EOFException has a null message)
    and keeps partial results; callers can do the same via ``.partial``.
    """

    def __init__(self, partial: "LookupHits"):
        super().__init__(None)
        self.partial = partial


@dataclass
class LookupHits:
    """Flat hit records in match (scan) order."""

    cnt_id: np.ndarray
    pos: np.ndarray
    otu: np.ndarray
    avg_from_end: np.ndarray
    fi: np.ndarray
    wt: np.ndarray
    kmers_found: int = 0  # distinct (slot, value) matches (ref kmersFound)

    @staticmethod
    def from_lists(cnt_id, pos, otu, avg, fi, wt, kmers_found=0) -> "LookupHits":
        return LookupHits(
            np.asarray(cnt_id, dtype=np.int64),
            np.asarray(pos, dtype=np.int64),
            np.asarray(otu, dtype=np.int32),
            np.asarray(avg, dtype=np.int32),
            np.asarray(fi, dtype=np.int32),
            np.asarray(wt, dtype=np.float32),
            kmers_found,
        )

    def __len__(self) -> int:
        return len(self.cnt_id)


def sort_queries(values: np.ndarray, cnt_id: np.ndarray, pos: np.ndarray, num_sigs: int):
    """Order query k-mers by (home, value), stably — the reference's
    comparator (ref :1082-1094) applied by updateHashCodeAndSort (ref :1076).
    """
    values = np.asarray(values, dtype=np.int64)
    home = values % np.int64(num_sigs)
    order = np.lexsort((values, home))
    return values[order], np.asarray(cnt_id)[order], np.asarray(pos)[order], home[order]


def lookup_stream(table: KmerTable, values, cnt_id, pos) -> LookupHits:
    """Run the exact reference scan. Queries may be in any order (sorted here)."""
    num_sigs = table.num_sigs
    values, cnt_id, pos, home = sort_queries(values, cnt_id, pos, num_sigs)
    tk = table.slots["kmer"]
    t_otu = table.slots["otu"]
    t_avg = table.slots["avg_from_end"]
    t_fi = table.slots["fi"]
    t_wt = table.slots["wt"]

    nq = len(values)
    r_cnt: List[int] = []
    r_pos: List[int] = []
    r_otu: List[int] = []
    r_avg: List[int] = []
    r_fi: List[int] = []
    r_wt: List[float] = []
    kmers_found = 0

    cur = 0  # next slot index the "stream" will read (ref curHashCode)
    qi = 0
    in_progress: Dict[int, List[int]] = {}
    vals = values.tolist()
    homes = home.tolist()
    while qi < nq or in_progress:
        needed = cur
        if not in_progress:
            v = vals[qi]
            needed = homes[qi]
            in_progress[v] = [qi]
            qi += 1
        while qi < nq and homes[qi] == needed:
            v = vals[qi]
            lst = in_progress.get(v)
            if lst is None:
                in_progress[v] = [qi]
            else:
                lst.append(qi)
            qi += 1
        if needed > cur:
            cur = needed
        # len(tk) < num_sigs for truncated files: reading past the available
        # slots is the reference's EOFException (ref :797-802)
        if cur >= len(tk):
            raise TableTruncatedError(
                LookupHits.from_lists(r_cnt, r_pos, r_otu, r_avg, r_fi, r_wt, kmers_found)
            )
        which = int(tk[cur])
        if which > MAX_ENCODED:
            in_progress.clear()
        else:
            waiting = in_progress.pop(which, None)
            if waiting is not None:
                kmers_found += 1
                for q in waiting:
                    r_cnt.append(int(cnt_id[q]))
                    r_pos.append(int(pos[q]))
                    r_otu.append(int(t_otu[cur]))
                    r_avg.append(int(t_avg[cur]))
                    r_fi.append(int(t_fi[cur]))
                    r_wt.append(float(t_wt[cur]))
        cur += 1
    return LookupHits.from_lists(r_cnt, r_pos, r_otu, r_avg, r_fi, r_wt, kmers_found)
