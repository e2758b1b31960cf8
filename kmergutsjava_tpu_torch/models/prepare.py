"""Prepare phase: FASTA records -> query k-mer stream.

Counterpart of the reference's prepareQuery/addKmers
(KmerGutsJava.java:1051-1074, :900-922) and of the JAX package's
``models/prepare.py``: the native C++ feeder (bulk or per record) and its
numpy twins encode 8-mers on the host (after 6-frame translation in DNA
mode); ``prepare_aa``/``prepare_dna`` (``--prepare jax``, the JAX package's
name) run the k-mer window kernel's ragged entry on the device
(``ops/kmer_windows.py``): unpadded rows in, only the valid windows back,
compacted on the card. Each feeds (value, container, pos) records to the
lookup front end. Container creation order defines the hit container ids:
per DNA contig +0, +1, +2, -0, -1, -2 (ref :1064-1072); one '+/0'
container per protein (ref :1059).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

from ..constants import (AA_OFF_LUT, CODON_AA_OFF, COMPL_DNA_CODE_LUT,
                         DNA_CODE_LUT, INVALID_AA, K)
from ..formats.fasta import FastaRecord
from ..lookup.store import QueryKmerStore
from ..utils.timing import count, span

ContainerKey = Tuple[str, str, int]  # (query_id, strand, frame)


class Prepared:
    """Container bookkeeping for a prepare pass.

    Two construction styles: the record-iterator prepare paths append one
    key per container via new_container; the bulk path registers whole
    records (add_records) and synthesizes the key list LAZILY — container
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

    def add_records(self, ids: List[str], lengths: List[int]) -> None:
        """Bulk path: register records in file order, as add_record one at
        a time would (a repeated id keeps its first place in id_len and
        takes its last length)."""
        if self._containers is not None:
            raise RuntimeError("add_records after containers were "
                               "materialized; register all records first")
        self._rec_ids.extend(ids)
        self.id_len.update(zip(ids, lengths))


def _seq_to_ascii(seq: str) -> np.ndarray:
    return np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


# the cells (rows x padded width) one launch of the fused step's kernel
# takes (models/spmd.py)
MAX_CELLS = 1 << 22

# the bytes (residues or bases) of the rows one launch of the window
# kernel's ragged entry takes in the device prepare; a longer row is a
# launch of its own
VALUES_LAUNCH_BYTES = 1 << 22


class BucketQueue:
    """Rows queued by power-of-two length bucket (``min_bucket`` and up),
    as the JAX package batches them for the device: ``add`` hands back a
    bucket's batch once it holds ``batch_rows`` rows (or ``max_cells //
    bucket``, at least one, when ``max_cells`` is given); ``drain`` hands
    back the rest in the order their buckets opened. A batch is (keys,
    zero-padded rows u8[b, bucket], lengths), or with ``padded=False``
    (keys, the rows as they came, lengths)."""

    def __init__(self, batch_rows: int, min_bucket: int, max_cells=None,
                 padded: bool = True):
        self.batch_rows, self.min_bucket = batch_rows, min_bucket
        self.max_cells, self.padded = max_cells, padded
        self._pending: Dict[int, List[Tuple[int, np.ndarray]]] = {}

    def add(self, key: int, ascii_u8: np.ndarray):
        bucket = _next_pow2(max(len(ascii_u8), self.min_bucket))
        q = self._pending.setdefault(bucket, [])
        q.append((key, ascii_u8))
        cap = self.batch_rows
        if self.max_cells is not None:
            cap = max(1, min(cap, self.max_cells // bucket))
        return self._batch(bucket) if len(q) >= cap else None

    def drain(self):
        for bucket in list(self._pending):
            yield self._batch(bucket)

    def _batch(self, bucket: int):
        rows = self._pending.pop(bucket)
        if not self.padded:
            return (np.array([k for k, _ in rows], dtype=np.int64),
                    [a for _, a in rows],
                    np.array([len(a) for _, a in rows], dtype=np.int64))
        mat = np.zeros((len(rows), bucket), dtype=np.uint8)
        lens = np.empty(len(rows), dtype=np.int64)
        keys = np.empty(len(rows), dtype=np.int64)
        for r, (key, ascii_u8) in enumerate(rows):
            mat[r, : len(ascii_u8)] = ascii_u8
            lens[r] = len(ascii_u8)
            keys[r] = key
        return keys, mat, lens


class _DeviceValues:
    """The k-mer window kernel's ragged entry on one device, on a stream of
    its own: unpadded rows in (one upload of their bytes and bounds), one
    call (two kernels), and back only the valid windows' values and
    positions and each container's count of them."""

    def __init__(self, device: str):
        from ..lookup.sparse import owned_stream, torch_device

        self.device = torch_device(device)
        self.stream = owned_stream(self.device)

    def __call__(self, rows: List[np.ndarray], aa: bool):
        from ..lookup.sparse import _device_fault, on_stream
        from ..ops.kmer_windows import ragged_values
        from ..parallel.annotate_step import upload

        bounds = np.zeros(len(rows) + 1, dtype=np.int32)
        np.cumsum([len(r) for r in rows], out=bounds[1:])
        data = np.concatenate(rows) if rows else np.zeros(0, np.uint8)
        with on_stream(self.stream), _device_fault("launch",
                                                   "device prepare"):
            b, bd = upload(self.device, data, bounds)
            values, pos, counts = ragged_values(b, bd, aa)
            return (values.cpu().numpy(), pos.cpu().numpy().astype(np.int64),
                    counts.cpu().numpy())


def prepare_aa(records: Iterable[FastaRecord], store: QueryKmerStore,
               batch_rows: int = 512, min_bucket: int = 256,
               device: str = "cuda") -> Prepared:
    """Protein mode on the device. Rows are queued by power-of-two length
    bucket as the JAX package batches them (``batch_rows`` a batch); the
    flushed batches, unpadded, share one launch of the window kernel's
    ragged entry up to VALUES_LAUNCH_BYTES, and its compacted windows are
    cut at the batches' rows, so the ``add_batch`` calls are the JAX
    package's, one for one."""
    prep = Prepared()
    values_of = _DeviceValues(device)
    queue = BucketQueue(batch_rows, min_bucket, padded=False)
    pending: List[Tuple[np.ndarray, List[np.ndarray]]] = []
    size = 0

    def launch() -> None:
        nonlocal pending, size
        if not pending:
            return
        # the reference's window bound is strictly i < len - K (ref :912):
        # the final full window of a protein is skipped (the kernel's aa
        # rule)
        values, pos, counts = values_of(
            [r for _, rows in pending for r in rows], aa=True)
        ends = np.concatenate([[0], np.cumsum(counts)])
        at = 0
        for cnt_ids, rows in pending:
            w0, w1 = ends[at], ends[at + len(rows)]
            store.add_batch(values[w0:w1],
                            np.repeat(cnt_ids, counts[at:at + len(rows)]),
                            pos[w0:w1])
            at += len(rows)
        pending, size = [], 0

    def flush(batch) -> None:
        nonlocal size
        cnt_ids, rows, lens = batch
        n = int(lens.sum())
        if size + n > VALUES_LAUNCH_BYTES:
            launch()
        pending.append((cnt_ids, rows))
        size += n

    for rec in records:
        cid = prep.new_container((rec.id, "+", 0))
        prep.id_len[rec.id] = len(rec.seq)
        batch = queue.add(cid, _seq_to_ascii(rec.seq))
        if batch is not None:
            flush(batch)
    for batch in queue.drain():
        flush(batch)
    launch()
    return prep


def prepare_dna(records: Iterable[FastaRecord], store: QueryKmerStore,
                device: str = "cuda") -> Prepared:
    """DNA mode on the device: six-frame translation and 8-mer packing by
    the window kernel's ragged entry. The JAX package launches once a
    contig; here consecutive contigs share a launch, unpadded, up to
    VALUES_LAUNCH_BYTES bases (a longer contig is a launch of its own).
    One ``add_batch`` a launch, whose rows are the contigs' rows in order,
    each in the JAX order (frame row, then position)."""
    prep = Prepared()
    values_of = _DeviceValues(device)
    pending: List[Tuple[List[int], np.ndarray]] = []
    size = 0

    def launch() -> None:
        nonlocal pending, size
        if not pending:
            return
        values, pos, counts = values_of([a for _, a in pending], aa=False)
        cids = np.array([c for c, _ in pending], dtype=np.int64).reshape(-1)
        store.add_batch(values, np.repeat(cids, counts), pos)
        pending, size = [], 0

    for rec in records:
        ascii_u8 = _seq_to_ascii(rec.seq)
        cids = [prep.new_container((rec.id, s, f))
                for s in ("+", "-") for f in range(3)]
        prep.id_len[rec.id] = len(ascii_u8)
        if size + len(ascii_u8) > VALUES_LAUNCH_BYTES:
            launch()
        pending.append((cids, ascii_u8))
        size += len(ascii_u8)
    launch()
    return prep


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

def prepare_dna_numpy(records: Iterable[FastaRecord],
                      store: QueryKmerStore,
                      flush_chars: int = 8_000_000) -> Prepared:
    """Host-numpy DNA prepare (feeder fast path).

    All six translated frame rows of a batch of contigs are concatenated
    with K-1 terminator sentinels and k-merized in one sliding pass, the
    right shape for metagenome read streams (millions of short contigs).
    Unlike aa mode there is no skip-last-window quirk: every full window of
    a frame row is a valid start (the reference's bound ``i < L - K`` over
    its len/3+1 buffer equals the row's full window count)."""
    prep = Prepared()
    seqs: List[np.ndarray] = []
    cid_rows: List[List[int]] = []  # [6] container ids per record
    pending_chars = 0
    # separator: >= K-1 invalid codons (21 bases) between records, padded so
    # every record block stays 3-aligned and global stride-3 slicing lines
    # up with per-record frames
    BASE_SEP = 3 * (K - 1)

    def flush():
        nonlocal seqs, cid_rows, pending_chars
        if not seqs:
            return
        nrec = len(seqs)
        lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=nrec)
        pads = BASE_SEP + ((3 - lens % 3) % 3)
        block_starts = np.concatenate([[0], np.cumsum(lens + pads)])[:-1]
        start_cod = block_starts // 3
        total = int((lens + pads).sum())
        fwd = np.full(total + 3, 4, dtype=np.uint8)  # invalid base everywhere
        rc = np.full(total + 3, 4, dtype=np.uint8)
        for i, s in enumerate(seqs):
            b = int(block_starts[i])
            fwd[b: b + len(s)] = DNA_CODE_LUT[s]
            rc[b: b + len(s)] = COMPL_DNA_CODE_LUT[s][::-1]
        cid_arr = np.asarray(cid_rows, dtype=np.int64)  # [nrec, 6]
        ncod = total // 3
        for strand, codes in ((0, fwd), (1, rc)):
            c32 = codes.astype(np.int32)
            for f in range(3):
                c1 = c32[f: f + 3 * ncod: 3]
                c2 = c32[f + 1: f + 1 + 3 * ncod: 3]
                c3 = c32[f + 2: f + 2 + 3 * ncod: 3]
                ok = (c1 < 4) & (c2 < 4) & (c3 < 4)
                offs = np.where(
                    ok, CODON_AA_OFF[np.where(ok, c1 * 16 + c2 * 4 + c3, 0)],
                    INVALID_AA).astype(np.uint8)
                w = ncod - K + 1
                if w <= 0:
                    continue
                o64 = offs.astype(np.int64)
                values = o64[:w].copy()
                valid = offs[:w] < 20
                for k in range(1, K):
                    values *= 20
                    values += o64[k: k + w]
                    valid &= offs[k: k + w] < 20
                gstarts = np.nonzero(valid)[0]
                row_of = np.searchsorted(start_cod, gstarts, side="right") - 1
                local = gstarts - start_cod[row_of]
                store.add_batch(values[gstarts],
                                cid_arr[row_of, strand * 3 + f], local)
        seqs, cid_rows, pending_chars = [], [], 0

    for rec in records:
        cids = [prep.new_container((rec.id, s, f))
                for s in ("+", "-") for f in range(3)]
        prep.id_len[rec.id] = len(rec.seq)
        seqs.append(_seq_to_ascii(rec.seq))
        cid_rows.append(cids)
        pending_chars += 2 * len(rec.seq)
        if pending_chars >= flush_chars:
            flush()
    flush()
    return prep


def feed_chunk(lib, aa: bool, blob: np.ndarray, starts: np.ndarray,
               lens: np.ndarray, first_cid: int, store) -> None:
    """One chunk through the native feeder (``native/feeder.cpp``): the
    records ``blob[starts[r]:starts[r] + lens[r]]``, record r's containers
    from ``first_cid + frames * r``. The count pass sizes the chunk's three
    int64 columns (value, container, position); they come from the
    store's ``query_columns(n)`` where it has one (memory the front end
    owns and reuses), else fresh; the write pass fills them, and the store
    takes them as they are."""
    nrec = len(lens)
    with span("prepare.encode"):
        counts = np.empty(nrec, dtype=np.int64)
        n = int(lib.feeder_count(aa, blob, starts, lens, nrec, counts))
        if n == 0:
            return
        lend = getattr(store, "query_columns", None)
        cols = (lend(n) if lend is not None else
                tuple(np.empty(n, dtype=np.int64) for _ in range(3)))
        if [len(c) for c in cols] != [n] * 3:
            raise ValueError(f"columns of {[len(c) for c in cols]} rows "
                             f"for {n} queries")
        if lib.feeder_write(aa, blob, starts, lens, nrec, counts, first_cid,
                            *cols) != n:
            raise RuntimeError("the feeder's write pass wrote other than "
                               "its count pass counted")
    count("prepare.direct_queries", n if lend is not None else 0)
    store.add_batch(*cols)


def _prepare_native(records: Iterable[FastaRecord], store: QueryKmerStore,
                    aa: bool, flush_chars: int = 8_000_000):
    """C++ feeder path (native/feeder.cpp via ctypes).
    Returns None when the native library is unavailable (no g++, or
    KMER_NO_NATIVE_FEEDER; the caller falls back to numpy)."""
    from ..utils.native import load_feeder

    lib = load_feeder()
    if lib is None:
        return None
    prep = Prepared()
    seqs: List[np.ndarray] = []
    first_cid = 0
    pending = 0

    def flush():
        nonlocal seqs, pending
        if not seqs:
            return
        lens = np.fromiter((len(s) for s in seqs), dtype=np.int64,
                           count=len(seqs))
        starts = np.concatenate([[0], np.cumsum(lens)])[:-1]
        blob = np.ascontiguousarray(np.concatenate(seqs))
        feed_chunk(lib, aa, blob, starts, lens, first_cid, store)
        seqs, pending = [], 0

    keys = ([("+", 0)] if aa else
            [(s, f) for s in ("+", "-") for f in range(3)])
    for rec in records:
        cids = [prep.new_container((rec.id, s, f)) for s, f in keys]
        if not seqs:
            first_cid = cids[0]
        prep.id_len[rec.id] = len(rec.seq)
        seqs.append(_seq_to_ascii(rec.seq))
        pending += len(rec.seq)
        if pending >= flush_chars:
            flush()
    flush()
    return prep


def prepare_aa_native(records, store):
    return _prepare_native(records, store, aa=True)


def prepare_dna_native(records, store):
    return _prepare_native(records, store, aa=False)


def try_prepare_bulk(query, query_stream, store, aa: bool,
                     flush_chars: int = 8_000_000):
    """Fully-native prepare: the bulk FASTA parse result feeds the native
    feeder DIRECTLY — sequence bytes stay in the parser's single output
    buffer (the feeder takes absolute offsets into it), and no Python runs
    per record: the ids are split from the buffer at once and registered
    in one call (``prepare.register``), container keys synthesize lazily
    (Prepared.add_records), and each chunk is counted, then written once
    into its columns (``feed_chunk``, ``prepare.encode``). Returns None —
    with ``query_stream`` left unconsumed — when any native piece is
    missing or the input isn't bulk-capable, so the caller falls back to
    the record-iterator paths.

    Byte-equivalent to prepare_{aa,dna}_native over read_fasta: same
    feeder, same container order, same chunk boundaries measured in
    sequence chars."""
    from ..formats.fasta import bulk_ids, read_fasta_bulk_arrays
    from ..utils.native import load_feeder

    lib = load_feeder()
    if lib is None:
        return None
    with span("prepare.parse"):
        bulk = read_fasta_bulk_arrays(query if query is not None
                                      else query_stream)
    if bulk is None:
        return None
    frames = 1 if aa else 6
    prep = Prepared(frames=frames)
    nrec = bulk.nrec
    if nrec == 0:
        return prep
    s_off = np.ascontiguousarray(bulk.rec[:, 4])
    s_len = np.ascontiguousarray(bulk.rec[:, 5])
    with span("prepare.register"):
        prep.add_records(bulk_ids(bulk), s_len.tolist())
    blob = np.ascontiguousarray(bulk.buf)
    # chunk by cumulative sequence chars (same budget as _prepare_native)
    cum = np.cumsum(s_len)
    a = 0
    while a < nrec:
        base = cum[a - 1] if a else 0
        b = int(np.searchsorted(cum, base + flush_chars)) + 1
        b = min(b, nrec)
        feed_chunk(lib, aa, blob, s_off[a:b], s_len[a:b], frames * a, store)
        a = b
    return prep
