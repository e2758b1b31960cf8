"""The signature table file and the function index, as SURVEY 2.1 and the
reference (KmerGutsJava.java:924-942, :995-999, :345-373) define them.

    header: int64le numSigs | int64le entrySize (24) | int64le version
    slot s at byte 24 + 24 * s:
            int64le whichKmer | int32le otuIndex | int32le avgFromEnd
            | int32le functionIndex | float32le functionWt
    empty:  whichKmer > 20^8
"""
from __future__ import annotations

import os
from typing import List, NamedTuple

import numpy as np

MAX_ENCODED = 20 ** 8
ENTRY_SIZE = 24
TABLE_FILE = "kmer.table.mem_map"
FUNCTION_INDEX_FILE = "function.index"
SLOT = np.dtype([("kmer", "<i8"), ("otu", "<i4"), ("avg", "<i4"),
                 ("fi", "<i4"), ("wt", "<f4")])
HEADER = np.dtype([("num_sigs", "<i8"), ("entry_size", "<i8"),
                   ("version", "<i8")])


class Table(NamedTuple):
    num_sigs: int
    slots: np.ndarray  # SLOT records, memory-mapped from the file


def open_table(data_dir: str) -> Table:
    path = os.path.join(data_dir, TABLE_FILE)
    head = np.fromfile(path, dtype=HEADER, count=1)[0]
    if int(head["entry_size"]) != ENTRY_SIZE:
        raise ValueError(f"entry size {int(head['entry_size'])}")
    num = int(head["num_sigs"])
    if os.path.getsize(path) != HEADER.itemsize + ENTRY_SIZE * num:
        raise ValueError(f"{path} does not hold {num} slots")
    slots = np.memmap(path, dtype=SLOT, mode="r", offset=HEADER.itemsize,
                      shape=(num,))
    return Table(num, slots)


def functions(data_dir: str) -> List[str]:
    """The function names by index: lines ``<i>\\t<name>``, ``i`` dense
    from 0; the name is everything after the first tab."""
    names = []
    with open(os.path.join(data_dir, FUNCTION_INDEX_FILE), "rb") as fh:
        for at, line in enumerate(fh.read().decode("latin-1").split("\n")):
            line = line.rstrip("\r")
            if not line:
                continue
            tab = line.index("\t")
            if int(line[:tab]) != at:
                raise ValueError(f"function index not dense at line {at}")
            names.append(line[tab + 1:])
    return names
