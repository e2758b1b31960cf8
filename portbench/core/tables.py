"""The benchmark's own table builder: a data directory in the format of
SURVEY 2.1 (``kmer.table.mem_map``, ``function.index``), written with
NumPy alone, so that the program under test never makes the data it is
judged on.

Placement, as the reference's tables and the port's builder place it:
numSigs is the next odd prime above count / load; signatures are placed
in ascending (home, value) order, home = value mod numSigs, each in the
first free slot from its home on (pos[i] = max(home[i], pos[i-1] + 1));
while a chain would reach the last slot, numSigs grows to the next odd
prime above numSigs + max(17, numSigs >> 12). So no probe wraps and the
last slot stays empty. Empty slots hold 2^62.
"""
from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from ..reference.table import (ENTRY_SIZE, FUNCTION_INDEX_FILE, HEADER,
                               MAX_ENCODED, SLOT, TABLE_FILE)

EMPTY = np.int64(2 ** 62)
VERSION = 1


def next_odd_prime(n: int) -> int:
    if n <= 2:
        return 2
    n += 1 - n % 2
    while any(n % p == 0 for p in range(3, int(n ** 0.5) + 1, 2)):
        n += 2
    return n


def place(kmers: np.ndarray, load: float):
    """(numSigs, order, slot): the signatures in placement order and the
    slot of each."""
    n = len(kmers)
    num = next_odd_prime(max(int(n / load) + 1, n + 2, 11))
    while True:
        home = kmers % np.int64(num)
        if num <= 1 << 28:  # (home, value) in one 63-bit key
            order = np.argsort((home << np.int64(35)) | kmers)
        else:
            order = np.lexsort((kmers, home))
        if n > 1 and bool((np.diff(kmers[order]) == 0).any()):
            raise ValueError("duplicate k-mer values")
        home = home[order]
        step = np.arange(n, dtype=np.int64)
        pos = np.maximum.accumulate(home - step) + step
        if n == 0 or pos[-1] < num - 1:
            return num, order, pos
        num = next_odd_prime(num + max(17, num >> 12))


def write_data_dir(data_dir: str, sig: Dict[str, np.ndarray],
                   function_names: Sequence[str], load: float) -> int:
    """Write the table of ``sig`` (kmers, otu, avg_from_end, fi, wt) and
    the function index into ``data_dir``; returns numSigs."""
    kmers = np.ascontiguousarray(sig["kmers"], dtype=np.int64)
    if len(kmers) and (kmers.min() < 0 or kmers.max() > MAX_ENCODED):
        raise ValueError("k-mer value out of range")
    num, order, pos = place(kmers, load)
    write_slots(data_dir, num, pos,
                {key: np.asarray(sig[key])[order] for key in FIELDS},
                function_names)
    return num


# the SLOT field of each signature array
FIELDS = {"kmers": "kmer", "otu": "otu", "avg_from_end": "avg", "fi": "fi",
          "wt": "wt"}


def write_slots(data_dir: str, num: int, pos: np.ndarray,
                placed: Dict[str, np.ndarray],
                function_names: Sequence[str]) -> None:
    """The table file of ``num`` slots holding ``placed`` (signature
    arrays in placement order) at ``pos``, and the function index."""
    slots = np.zeros(num, dtype=SLOT)
    slots["kmer"] = EMPTY
    for key, field in FIELDS.items():
        slots[field][pos] = placed[key]
    head = np.zeros(1, dtype=HEADER)
    head["num_sigs"], head["entry_size"], head["version"] = \
        num, ENTRY_SIZE, VERSION
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, TABLE_FILE), "wb") as fh:
        head.tofile(fh)
        slots.tofile(fh)
        # on the disk before the window opens, so that writing it back
        # does not overlap the measured work
        fh.flush()
        os.fsync(fh.fileno())
    with open(os.path.join(data_dir, FUNCTION_INDEX_FILE), "w") as fh:
        fh.write("".join(f"{i}\t{name}\n"
                         for i, name in enumerate(function_names)))
