"""Out-of-core query k-mer store: bounded-RAM accumulate, spill, merge.

TPU-native counterpart of the reference's external merge sort
(createKmerStorage, KmerGutsJava.java
:822-889; spill/merge :656-740): query k-mers accumulate in RAM up to
``input_size_limit``; overflow chunks are sorted by (home, value) — the
reference's comparator (ref :1082-1094) — and spilled as binary files; a
pairwise merge cascade (ref :717-740) yields one sorted stream.

Differences by design (same capability, columnar instead of record-at-a-time):

- records are numpy batches, spilled as a structured array file and merged
  with vectorized block merges (searchsorted splits) instead of per-record
  Java object streams;
- sortedness is only *required* by the parity backend's streaming scan; the
  vectorized backends are order-independent, so the in-RAM path skips the
  sort unless asked for it.
"""
from __future__ import annotations

import os
import tempfile
from typing import List, Optional

import numpy as np

REC_DTYPE = np.dtype([("value", "<i8"), ("cnt", "<i4"), ("pos", "<i4")])


def sort_records(rec: np.ndarray, num_sigs: int) -> np.ndarray:
    home = rec["value"] % np.int64(num_sigs)
    order = np.lexsort((rec["value"], home))
    return rec[order]


def _lex_split(a_home, a_val, home0, val0, side: str) -> int:
    """Number of leading records of sorted (a_home, a_val) below
    (home0, val0) (side "left") or at most it (side "right")."""
    i1 = int(np.searchsorted(a_home, home0, side="left"))
    i2 = int(np.searchsorted(a_home, home0, side="right"))
    return i1 + int(np.searchsorted(a_val[i1:i2], val0, side=side))


def merge_two_sorted_files(f1: str, f2: str, out: str, num_sigs: int,
                           block: int = 1 << 20) -> None:
    """Streaming merge of two (home, value)-sorted record files; records
    with equal keys keep f1's before f2's. Each round buffers up to
    ``block`` records of each file and merges, with one stable sort, every
    buffered record up to the smaller of the two buffers' last keys, so a
    round drains at least one buffer whole: O(n log block) however finely
    the files interleave."""
    a = np.memmap(f1, dtype=REC_DTYPE, mode="r")
    b = np.memmap(f2, dtype=REC_DTYPE, mode="r")
    ns = np.int64(num_sigs)
    ai = bi = 0
    a_buf = b_buf = np.empty(0, dtype=REC_DTYPE)
    with open(out, "wb") as fh:
        while True:
            if len(a_buf) == 0 and ai < len(a):
                a_buf = np.asarray(a[ai: ai + block])
                ai += len(a_buf)
            if len(b_buf) == 0 and bi < len(b):
                b_buf = np.asarray(b[bi: bi + block])
                bi += len(b_buf)
            if len(a_buf) == 0 or len(b_buf) == 0:
                break  # one file is drained: copy the other's rest
            a_val, b_val = a_buf["value"], b_buf["value"]
            a_home, b_home = a_val % ns, b_val % ns
            if (a_home[-1], a_val[-1]) <= (b_home[-1], b_val[-1]):
                # all of a's buffer, and b's records below its last key (an
                # equal b record waits for a's equal records still unread)
                cut_a = len(a_buf)
                cut_b = _lex_split(b_home, b_val, a_home[-1], a_val[-1],
                                   "left")
            else:
                # all of b's buffer, and a's records up to its last key
                # (b's file holds nothing below it any more)
                cut_b = len(b_buf)
                cut_a = _lex_split(a_home, a_val, b_home[-1], b_val[-1],
                                   "right")
            both = np.concatenate([a_buf[:cut_a], b_buf[:cut_b]])
            order = np.lexsort((both["value"],
                                np.concatenate([a_home[:cut_a],
                                                b_home[:cut_b]])))
            both[order].tofile(fh)  # lexsort is stable: a's ties first
            a_buf, b_buf = a_buf[cut_a:], b_buf[cut_b:]
        for buf, mm, at in ((a_buf, a, ai), (b_buf, b, bi)):
            buf.tofile(fh)
            for s in range(at, len(mm), block):
                np.asarray(mm[s: s + block]).tofile(fh)


class QueryKmerStore:
    """Accumulate (value, container, pos) batches with bounded RAM."""

    def __init__(self, num_sigs: int, input_size_limit: int,
                 temp_dir: Optional[str] = None):
        self.num_sigs = num_sigs
        self.limit = int(input_size_limit)
        self.temp_dir = temp_dir or tempfile.gettempdir()
        self._batches: List[np.ndarray] = []
        self._count = 0
        self._files: List[str] = []
        self._final: Optional[np.ndarray] = None
        self._final_file: Optional[str] = None

    @property
    def total_added(self) -> int:
        return self._count + sum(len(np.memmap(f, dtype=REC_DTYPE, mode="r"))
                                 for f in self._files)

    def add_batch(self, values: np.ndarray, cnt_id: int, pos: np.ndarray) -> None:
        n = len(values)
        if n == 0:
            return
        rec = np.empty(n, dtype=REC_DTYPE)
        rec["value"] = values
        rec["cnt"] = cnt_id
        rec["pos"] = pos
        self._batches.append(rec)
        self._count += n
        if self._count >= self.limit:
            self._spill()

    def _spill(self) -> None:
        if not self._batches:
            return
        os.makedirs(self.temp_dir, exist_ok=True)
        rec = sort_records(np.concatenate(self._batches), self.num_sigs)
        path = os.path.join(self.temp_dir, f"query_kmers_{len(self._files)}.dat")
        rec.tofile(path)
        self._files.append(path)
        self._batches = []
        self._count = 0

    def finalize(self, require_sorted: bool = False) -> np.ndarray:
        """Return all records; sorted by (home, value) if spilled or requested."""
        if self._final is not None:
            return self._final
        if self._files:
            self._spill()
            files = list(self._files)
            gen = len(files)
            while len(files) > 1:
                nxt = []
                while files:
                    f1 = files.pop(0)
                    if files:
                        f2 = files.pop(0)
                        out = os.path.join(self.temp_dir, f"query_kmers_{gen}.dat")
                        gen += 1
                        merge_two_sorted_files(f1, f2, out, self.num_sigs)
                        os.remove(f1)
                        os.remove(f2)
                        nxt.append(out)
                    else:
                        nxt.append(f1)
                files = nxt
            self._final_file = files[0]
            self._final = np.memmap(self._final_file, dtype=REC_DTYPE, mode="r")
        else:
            rec = (np.concatenate(self._batches) if self._batches
                   else np.empty(0, dtype=REC_DTYPE))
            self._batches = []
            if require_sorted and len(rec):
                rec = sort_records(rec, self.num_sigs)
            self._final = rec
        return self._final

    def close(self) -> None:
        self._batches = []
        self._final = None
        if self._final_file and os.path.exists(self._final_file):
            os.remove(self._final_file)
        for f in self._files:
            if os.path.exists(f):
                os.remove(f)
        self._files = []
