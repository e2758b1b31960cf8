"""Prepare phase: FASTA records -> query k-mer stream (protein mode).

Counterpart of the reference's prepareQuery/addKmers
(KmerGutsJava.java:1051-1074, :900-922) and of the JAX package's
``models/prepare.py`` host paths: the native C++ feeder (bulk or per
record) and its numpy twin encode 8-mers on the host and feed
(value, container, pos) records to the lookup front end. One '+/0'
container per protein (ref :1059) defines the hit container ids.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

from ..constants import AA_OFF_LUT, K
from ..formats.fasta import FastaRecord
from ..lookup.store import QueryKmerStore

ContainerKey = Tuple[str, str, int]  # (query_id, strand, frame)


class Prepared:
    """Container bookkeeping for a prepare pass.

    Two construction styles: the record-iterator prepare paths append one
    key per container via new_container; the bulk path registers whole
    records (add_record) and synthesizes the key list LAZILY — container
    ids are dense per record in the fixed reference order (+0 +1 +2 -0 -1
    -2 for DNA, ref :1064-1072; one +0 per protein, ref :1059), so the
    fully-native report path never needs the 6-tuples-per-read list at
    all (it was ~0.5s of pure Python on a 100k-read sweep)."""

    def __init__(self, frames: int = 0) -> None:
        self._containers: List[ContainerKey] = [] if frames == 0 else None
        self._rec_ids: List[str] = [] if frames else None
        self._frames = frames
        self.id_len: Dict[str, int] = {}  # insertion-ordered, re-put keeps slot

    @property
    def containers(self) -> List[ContainerKey]:
        if self._containers is None:
            sf = ([("+", 0)] if self._frames == 1 else
                  [(s, f) for s in ("+", "-") for f in range(3)])
            self._containers = [(qid, s, f)
                                for qid in self._rec_ids for s, f in sf]
        return self._containers

    def new_container(self, key: ContainerKey) -> int:
        c = self.containers
        c.append(key)
        return len(c) - 1

    def num_containers(self) -> int:
        """len(containers) without synthesizing the key list."""
        if self._containers is None:
            return len(self._rec_ids) * self._frames
        return len(self._containers)

    def add_record(self, query_id: str, length: int) -> int:
        """Bulk path: register one record; returns its base container id."""
        if self._containers is not None:
            # the synthesized key list would silently miss this record
            raise RuntimeError("add_record after containers were "
                               "materialized; register all records first")
        base = len(self._rec_ids) * self._frames
        self._rec_ids.append(query_id)
        self.id_len[query_id] = length
        return base


def _seq_to_ascii(seq: str) -> np.ndarray:
    return np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)


def prepare_aa_numpy(records: Iterable[FastaRecord],
                     store: QueryKmerStore,
                     flush_chars: int = 8_000_000) -> Prepared:
    """Host-numpy protein prepare (feeder fast path).

    Proteins are concatenated with K-1 invalid-sentinel separators so one
    sliding-window pass covers a whole batch; windows crossing a separator
    invalidate themselves, and the reference's skip-last-window quirk
    (``i < len - K``, ref :912) is applied by clearing each record's final
    full window explicitly."""
    prep = Prepared()
    seqs: List[np.ndarray] = []
    cids: List[int] = []
    pending_chars = 0

    sep = np.full(K - 1, 21, dtype=np.uint8)  # invalid aa offsets

    def flush():
        nonlocal seqs, cids, pending_chars
        if not seqs:
            return
        lens = np.fromiter((len(s) for s in seqs), dtype=np.int64,
                           count=len(seqs))
        parts = []
        for s in seqs:
            parts.append(AA_OFF_LUT[s])
            parts.append(sep)
        offs = np.concatenate(parts[:-1]) if len(parts) > 1 else parts[0]
        rec_start = np.concatenate([[0], np.cumsum(lens + (K - 1))])[:-1]
        n = len(offs)
        if n >= K:
            # in-place Horner evaluation: integer matmul has no BLAS path
            # and naive temporaries double the memory traffic
            o64 = offs.astype(np.int64)
            w = n - K + 1
            values = o64[:w].copy()
            valid = offs[:w] < 20
            for k in range(1, K):
                seg = o64[k: k + w]
                values *= 20
                values += seg
                valid &= offs[k: k + w] < 20
            # reference quirk: the final full window of each record (start
            # len-K) is skipped
            last = rec_start + lens - K
            ok = lens >= K
            valid[last[ok]] = False
            gstarts = np.nonzero(valid)[0]
            rec_of = np.searchsorted(rec_start, gstarts, side="right") - 1
            local = gstarts - rec_start[rec_of]
            store.add_batch(values[gstarts],
                            np.asarray(cids, dtype=np.int64)[rec_of], local)
        seqs, cids, pending_chars = [], [], 0

    for rec in records:
        cid = prep.new_container((rec.id, "+", 0))
        prep.id_len[rec.id] = len(rec.seq)
        seqs.append(_seq_to_ascii(rec.seq))
        cids.append(cid)
        pending_chars += len(rec.seq)
        if pending_chars >= flush_chars:
            flush()
    flush()
    return prep

def prepare_aa_native(records: Iterable[FastaRecord], store: QueryKmerStore,
                      flush_chars: int = 8_000_000):
    """C++ feeder path (kmergutsjava_tpu/native/feeder.cpp via ctypes).
    Returns None when the native library is unavailable (caller falls back
    to numpy)."""
    from ..utils.native import load_feeder

    lib = load_feeder()
    if lib is None:
        return None
    prep = Prepared()
    seqs: List[np.ndarray] = []
    cid0: List[int] = []
    pending = 0

    def flush():
        nonlocal seqs, cid0, pending
        if not seqs:
            return
        nrec = len(seqs)
        lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=nrec)
        starts = np.concatenate([[0], np.cumsum(lens)])[:-1]
        blob = np.concatenate(seqs) if nrec > 1 else seqs[0]
        blob = np.ascontiguousarray(blob)
        cap = max(int(lens.sum()), 1)
        scratch = np.empty(max(int(lens.max()), 1), dtype=np.uint8)
        out_v = np.empty(cap, dtype=np.int64)
        out_c = np.empty(cap, dtype=np.int32)
        out_p = np.empty(cap, dtype=np.int32)
        n = int(lib.feeder_aa(blob, np.ascontiguousarray(starts),
                              np.ascontiguousarray(lens), nrec,
                              np.asarray(cid0, dtype=np.int64), scratch,
                              out_v, out_c, out_p))
        store.add_batch(out_v[:n], out_c[:n].astype(np.int64), out_p[:n])
        seqs, cid0, pending = [], [], 0

    for rec in records:
        cid0.append(prep.new_container((rec.id, "+", 0)))
        prep.id_len[rec.id] = len(rec.seq)
        seqs.append(_seq_to_ascii(rec.seq))
        pending += len(rec.seq)
        if pending >= flush_chars:
            flush()
    flush()
    return prep


def try_prepare_bulk(query, query_stream, store,
                     flush_chars: int = 8_000_000):
    """Fully-native protein prepare: the bulk FASTA parse result feeds the
    native feeder DIRECTLY — sequence bytes stay in the parser's single
    output buffer (the feeder takes absolute offsets into it), so no
    per-record Python runs at all. Ids are materialized once from the
    buffer (the report needs them); container keys synthesize lazily
    (Prepared.add_record). Returns None — with ``query_stream`` left
    unconsumed — when any native piece is missing or the input isn't
    bulk-capable, so the caller falls back to the record-iterator paths.

    Byte-equivalent to prepare_aa_native over read_fasta: same feeder, same
    container order, same chunk boundaries measured in sequence chars."""
    from ..formats.fasta import read_fasta_bulk_arrays
    from ..utils.native import load_feeder

    lib = load_feeder()
    if lib is None:
        return None
    bulk = read_fasta_bulk_arrays(query if query is not None else query_stream)
    if bulk is None:
        return None
    prep = Prepared(frames=1)
    nrec = bulk.nrec
    if nrec == 0:
        return prep
    text = bulk.buf.tobytes().decode("latin-1")
    id_off = bulk.rec[:, 0]
    id_len = bulk.rec[:, 1]
    s_off = np.ascontiguousarray(bulk.rec[:, 4])
    s_len = np.ascontiguousarray(bulk.rec[:, 5])
    for i in range(nrec):
        o = int(id_off[i])
        prep.add_record(text[o:o + int(id_len[i])], int(s_len[i]))
    blob = np.ascontiguousarray(bulk.buf)
    # chunk by cumulative sequence chars (same budget as prepare_aa_native)
    cum = np.cumsum(s_len)
    scratch = np.empty(max(int(s_len.max()), 2), dtype=np.uint8)
    a = 0
    while a < nrec:
        base = cum[a - 1] if a else 0
        b = int(np.searchsorted(cum, base + flush_chars)) + 1
        b = min(b, nrec)
        cap = max(int(cum[b - 1] - base), 1)
        out_v = np.empty(cap, dtype=np.int64)
        out_c = np.empty(cap, dtype=np.int32)
        out_p = np.empty(cap, dtype=np.int32)
        n = int(lib.feeder_aa(blob, s_off[a:b], s_len[a:b], b - a,
                              np.arange(a, b, dtype=np.int64), scratch,
                              out_v, out_c, out_p))
        store.add_batch(out_v[:n], out_c[:n].astype(np.int64), out_p[:n])
        a = b
    return prep
