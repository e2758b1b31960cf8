"""Dense stream probe (the port of the TPU stream kernel): the hand-written
CUDA kernel's wrapper, its plain PyTorch twin, and the lookups around it.

Replaces the Pallas TPU kernel ``_stream_block_kernel`` of
``kmergutsjava_tpu/lookup/pallas_stream.py`` (launched there by
``stream_probe_blocks``); ``StreamLookup`` and ``StreamingStreamLookup``
are the counterparts of its ``PallasStreamLookup`` and
``StreamingStreamLookup``. The regime is dense query sets (a read set or a
genome against a table of comparable size): instead of one window gather
per query, queries are scattered by home slot into a dense tile
``tiles[c, s]`` (the fingerprint of the c-th distinct query whose home is
slot ``s``, up to C channels; the rare extras take the exact full-window
scan), and one pass over the whole fingerprint plane answers them all. For
each slot and channel the kernel returns the raw first fingerprint-match
offset in the ``w``-slot window (``w`` if none), four channels packed per
int32. Stop-at-empty needs no query data, so it is applied per query from a
per-slot empty-distance plane; candidates are verified against the full
k-mer values and unresolved queries take the exact full-window scan.

``StreamLookup`` keeps a pass's per-query stages in device memory: the
plane, the empty-distance plane and the k-mer column stay resident from the
build; each chunk's values go up and one kernel scatters them into the
pass's device tiles (``lookup/stream_tiles.py``); after the plane pass a
second kernel resolves every query to its table slot, the hits are
compacted on the card in query order, and only their query index and slot
come back, for the host to build the hit columns. The sharded lookup
(``parallel/stream_shards.py``) keeps the host scatter and decode of the
JAX package (``scatter_chunk``, ``resolve_slots`` + ``emit_hits``), on host
tiles.

Layout: plane u16 ``[S + w]`` (S = the slot count padded to a multiple of
4, then at least ``w`` FP_EMPTY slots), tiles u16 ``[C, S]``, output
int32 ``[C/4, S]``: one contiguous plane per channel (the sharded
lookup's native scatter, ``scatter_chunk``, produces it with ``rows=1,
block=S``). The TPU layout's overlapped ``[nsuper, ROWS, BLOCK + HALO]``
rows and its bf16 form are Mosaic workarounds and are not carried.

The kernel (``csrc/stream_probe.cu``) keeps the TPU kernel's output bit for
bit but not its method: the TPU kernel compares every cell with every
window offset, which on the H100 is bound by the integer pipe. Each work
item of the port (a span of ``SPAN`` slots) marks the fingerprints its plane
values hold in a shared-memory bitmap, answers ``w`` at once for every cell
whose fingerprint is absent (most of them), and lists the rest, which scan
their windows, one listed cell a thread. It is compiled with nvcc for sm_90a into
a plain-C shared library on first use and loaded with ctypes; nothing is
built or imported for CUDA when this module is imported.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np
import torch

from ..formats.kmer_table import KmerTable
from ..utils.timing import count, span
from .parity import LookupHits
from .sparse import (FP_EMPTY, HostWindow, _device_fault, fingerprint_plane,
                     on_stream, owned_stream, torch_device)
from .stream_tiles import resolve_tiles, scatter_tiles
from .tilejoin import KernelError, _widen, build_cuda_library

CHANNELS = 4      # query channels per slot (home-collision capacity)
MAX_WINDOW = 64   # offsets pack bytewise; the kernel's compile-time cap
SLOT_ALIGN = 4    # slots padded to a multiple of 4 (the kernel's vector
                  # path; it takes any count)
SPAN = 1024       # slots a CTA of the kernel owns (kSpan in the source)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "stream_probe.cu")

# kernel launches since import (or since a caller reset it to 0); counted
# only where the wrapper launches the CUDA kernel, never for the twin
launches = 0
# launches of the timing entry ``stream_probe_reps``, counted apart
reps_launches = 0
MAX_REPS = 65535  # the launch grid's y limit

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load_kernel() -> ctypes.CDLL:
    """Build (once per process, and only when the source is newer than the
    library) and load the kernel library. Raises KernelError."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_cuda_library(SOURCE)
        fn = lib.stream_probe
        fn.restype = ctypes.c_int
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                       p, p]
        fn = lib.stream_probe_reps
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                       ctypes.c_int32, p, p]
        _lib = lib
        return lib


def stream_probe_reference(fp: torch.Tensor, qfp_tiles: torch.Tensor, w: int,
                           channels: int = CHANNELS,
                           chunk: int = 1 << 22) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (and of the TPU kernel's i32 form):
    for each slot, a reverse scan of the window with overwrite on match
    (the first match wins), on int32, in slot chunks. Returns the packed
    int32 ``[channels/4, S]`` on fp's device."""
    slots = qfp_tiles.shape[1]
    out = torch.empty((channels // 4, slots), dtype=torch.int32,
                      device=fp.device)
    plane = _widen(fp)
    for s in range(0, slots, chunk):
        e = min(s + chunk, slots)
        q = _widen(qfp_tiles[:, s:e])
        first = torch.full_like(q, w)
        for l in reversed(range(w)):
            first.masked_fill_(plane[s + l:e + l] == q, l)
        f = first.view(channels // 4, 4, e - s)
        out[:, s:e] = (f[:, 0] | (f[:, 1] << 8) | (f[:, 2] << 16)
                       | (f[:, 3] << 24))
    return out


def _check(fp, qfp_tiles, w, channels) -> None:
    if not isinstance(w, int) or not 1 <= w <= MAX_WINDOW:
        raise KernelError(f"window {w!r} outside [1, {MAX_WINDOW}]")
    if not isinstance(channels, int) or channels < 4 or channels % 4:
        raise KernelError(f"channels {channels!r} is not a multiple of 4")
    for name, t, dims in (("fp", fp, 1), ("qfp_tiles", qfp_tiles, 2)):
        if t.dtype != torch.uint16 or t.dim() != dims \
                or not t.is_contiguous():
            raise KernelError(f"{name} must be a contiguous {dims}-D uint16 "
                              f"tensor, got {t.dtype} {tuple(t.shape)}")
    if qfp_tiles.device != fp.device:
        raise KernelError(f"qfp_tiles is on {qfp_tiles.device}, fp on "
                          f"{fp.device}")
    if qfp_tiles.shape[0] != channels:
        raise KernelError(f"{qfp_tiles.shape[0]} tile rows for {channels} "
                          "channels")
    if fp.numel() < qfp_tiles.shape[1] + w:
        raise KernelError(f"plane of {fp.numel()} slots is shorter than "
                          f"{qfp_tiles.shape[1]} slots + window {w}")


def _run(fp, qfp_tiles, w, channels, reps: Optional[int], out=None):
    """The twin for CPU tensors; else one launch of the ``stream_probe``
    entry (``reps`` None) or of ``stream_probe_reps``, into ``out`` where
    given. Returns (out, launched)."""
    if fp.device.type == "cpu":
        got = stream_probe_reference(fp, qfp_tiles, w, channels)
        return (got if out is None else out.copy_(got)), False
    if fp.device.type != "cuda":
        raise KernelError(f"no stream kernel for device {fp.device}")
    slots = qfp_tiles.shape[1]
    if out is None:
        out = torch.empty((channels // 4, slots), dtype=torch.int32,
                          device=fp.device)
    if slots == 0:
        return out, False
    lib = load_kernel()
    stream = torch.cuda.current_stream(fp.device).cuda_stream
    head = (fp.data_ptr(), qfp_tiles.data_ptr(), slots, channels, w)
    rc = (lib.stream_probe(*head, out.data_ptr(), stream) if reps is None
          else lib.stream_probe_reps(*head, reps, out.data_ptr(), stream))
    if rc != 0:
        raise KernelError(f"stream kernel launch failed: CUDA error {rc}")
    return out, True


def stream_probe(fp: torch.Tensor, qfp_tiles: torch.Tensor, w: int,
                 channels: int = CHANNELS,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw first fingerprint-match offset of every (channel, slot) tile cell
    in the ``w``-slot window from that slot (``w`` if none), packed four
    channels per int32: int32 ``[channels/4, S]`` on the inputs' device,
    written into ``out`` where given (a contiguous tensor of that shape
    and device). CPU tensors run the plain twin; CUDA tensors launch the
    kernel on the current stream (or raise KernelError). fp: u16
    ``[>= S + w]``, qfp_tiles: u16 ``[channels, S]``."""
    global launches
    _check(fp, qfp_tiles, w, channels)
    if out is not None and (
            out.dtype != torch.int32 or not out.is_contiguous()
            or tuple(out.shape) != (channels // 4, qfp_tiles.shape[1])
            or out.device != fp.device):
        raise KernelError(f"out must be a contiguous int32 "
                          f"{(channels // 4, qfp_tiles.shape[1])} tensor on "
                          f"{fp.device}, got {out.dtype} "
                          f"{tuple(out.shape)} on {out.device}")
    out, launched = _run(fp, qfp_tiles, w, channels, None, out)
    if launched:
        with _lock:
            launches += 1
    return out


def stream_probe_reps(fp: torch.Tensor, qfp_tiles: torch.Tensor, w: int,
                      channels: int = CHANNELS, reps: int = 1
                      ) -> torch.Tensor:
    """``stream_probe`` repeated ``reps`` times in one launch (a timing
    harness: every rep rewrites the same output, so the result is
    ``stream_probe``'s). CPU tensors run the plain twin once; CUDA tensors
    launch the kernel (or raise KernelError). Counted in
    ``reps_launches``, not ``launches``."""
    global reps_launches
    _check(fp, qfp_tiles, w, channels)
    if not isinstance(reps, int) or not 1 <= reps <= MAX_REPS:
        raise KernelError(f"reps {reps!r} outside [1, {MAX_REPS}]")
    out, launched = _run(fp, qfp_tiles, w, channels, reps)
    if launched:
        with _lock:
            reps_launches += 1
    return out


class PassSet:
    """The buffers of one plane pass on the lookup's device (plain tensors
    on the CPU): the tiles u16 ``[C, S]`` and occupancy u8 ``[S]`` that the
    scatter kernel fills, the probe's answers int32 ``[C/4, S]``, and the
    resolve's counts int64 ``[3]`` (overflow, fallback, hits). Each chunk's
    values and results are device tensors of their own, held with the
    chunk. The reset is issued on the lookup's ``stream``, in order with
    the passes.

    Tiles and occupancy are all zero whenever a set is free; ``dirty``
    marks a set scattered into since its last reset."""

    def __init__(self, channels: int, slots: int, device: torch.device,
                 stream, pooled: bool):
        self.pooled = pooled
        self.stream = stream
        self.dirty = False
        with on_stream(stream), _device_fault("upload", "stream probe"):
            self.tiles = torch.zeros((channels, slots), dtype=torch.uint16,
                                     device=device)
            self.occ = torch.zeros(slots, dtype=torch.uint8, device=device)
            self.answers = torch.empty((channels // 4, slots),
                                       dtype=torch.int32, device=device)
            self.counts = torch.zeros(3, dtype=torch.int64, device=device)

    def zero(self) -> None:
        with span("stream.reset"), on_stream(self.stream), \
                _device_fault("reset", "stream probe"):
            self.tiles.view(torch.int16).zero_()
            self.occ.zero_()
            self.counts.zero_()
        self.dirty = False


class PassSetPool:
    """A lookup's two pass sets, made and zeroed once when it is built.

    ``take`` hands out a free set, or, where none is free (two live front
    ends, or a one-shot lookup during a stream), a fresh plain set
    (``stream.fresh_sets``), which is dropped when given back. A taker
    gives its set back zeroed."""

    def __init__(self, make, size: int = 2):
        self._make = make
        self._lock = threading.Lock()
        self.sets = [make(pooled=True) for _ in range(size)]
        self._free = list(self.sets)

    def take(self) -> PassSet:
        with self._lock:
            if self._free:
                count("stream.fresh_sets", 0)
                return self._free.pop()
        count("stream.fresh_sets", 1)
        return self._make(pooled=False)

    def give_back(self, s: PassSet) -> None:
        if s.pooled:
            with self._lock:
                self._free.append(s)


class ColumnPool:
    """Host columns a stream front end lends the prepare to write a chunk's
    queries into: value, container and position, int64 each, page-locked
    values on CUDA (the upload then needs no staging copy). A buffer comes
    back once the pass that holds its chunk is decoded, and is lent again,
    so in the steady state no chunk allocates host memory. Capacities are
    powers of two; ``take`` lends the smallest free buffer that holds the
    chunk, else a fresh one (counted in ``stream.fresh_columns``); at most
    ``KEEP`` free buffers are kept, the largest."""

    KEEP = 8

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self._lock = threading.Lock()
        self._free: list = []

    def take(self, n: int) -> tuple:
        with self._lock:
            fits = [i for i, b in enumerate(self._free) if len(b[0]) >= n]
            if fits:
                count("stream.fresh_columns", 0)
                return self._free.pop(
                    min(fits, key=lambda i: len(self._free[i][0])))
        count("stream.fresh_columns", 1)
        cap = 1 << max(n - 1, 1).bit_length()
        values = torch.empty(cap, dtype=torch.int64,
                             pin_memory=self.pinned).numpy()
        return (values, np.empty(cap, dtype=np.int64),
                np.empty(cap, dtype=np.int64))

    def give_back(self, bufs) -> None:
        with self._lock:
            self._free.extend(b for b in bufs if b is not None)
            self._free.sort(key=lambda b: -len(b[0]))
            del self._free[self.KEEP:]


class StreamLookup:
    """Dense-regime lookup: slot-major query tiles against one pass over the
    device-resident fingerprint plane. Same exact-result contract as the
    sparse lookup (differentially tested against ``lookup/parity.py``).

    All device work is issued on one CUDA stream the lookup owns; a torch
    RuntimeError from upload, launch or read-back becomes a KernelError.
    A pass runs on a set of ``_sets``, the lookup's pool of two, and keeps
    its per-query stages on the lookup's device: a chunk's values go up
    (``_scatter_into``), the scatter and resolve kernels run beside the
    plane pass (``_pass``), and the host builds the hit columns from the
    compacted hits that come back (``_decode``). The sharded lookup
    (``parallel/stream_shards.py``) overrides these three with its host
    stages, and has no ``columns`` to lend.
    """

    columns: Optional[ColumnPool] = None

    def __init__(self, table: KmerTable, probe_window: Optional[int] = None,
                 device: str = "cuda", channels: int = CHANNELS):
        if channels % 4:
            raise ValueError("channels must be a multiple of 4 (bytewise "
                             "int32 packing)")
        self.channels = channels
        if table.max_probe is None:
            table.compute_max_probe()
        self.table = table
        self.num_sigs = s = table.num_sigs
        # offsets pack into a byte and the kernel caps w at 64; the scans
        # of the cells that can match grow with w, so round to a multiple
        # of 8, not a power of 2
        self.w = min(max(8, -(-table.max_probe // 8) * 8), MAX_WINDOW)
        if table.max_probe > MAX_WINDOW:
            raise ValueError(
                "max_probe exceeds the packed-offset budget (64); rebuild "
                "the table at a lower load factor or use the xla backend")
        with span("lookup.build.plane"):
            # exact path: verification column + full-window fallback
            self._exact = HostWindow(table, probe_window)
            self.slots = -(-s // SLOT_ALIGN) * SLOT_ALIGN
            fp = fingerprint_plane(table, self.slots + self.w)
            # Per-slot distance to the first empty slot at or after it,
            # capped at w: stop-at-empty depends only on the table, so it
            # is computed here once and applied per query. (The padded
            # tail is all empty, so every slot has a next empty.)
            n = len(fp)
            e_idx = np.where(fp == FP_EMPTY, np.arange(n, dtype=np.int64),
                             np.int64(2 * n))
            nxt = np.minimum.accumulate(e_idx[::-1])[::-1]
            self.fe_plane = np.minimum(nxt - np.arange(n, dtype=np.int64),
                                       self.w).astype(np.uint8)
        with span("lookup.build.upload"):
            self._place_plane(fp, device)
        self._sets = PassSetPool(self._new_set)

    def _place_plane(self, fp: np.ndarray, device: str) -> None:
        """Upload the plane, the empty-distance plane and the k-mer column
        to ``device``, on a stream the lookup owns."""
        self.device = torch_device(device)
        self._stream = owned_stream(self.device)
        with on_stream(self._stream), _device_fault("upload", "stream probe"):
            self.fp = torch.from_numpy(fp).to(self.device)
            self.fe = torch.from_numpy(self.fe_plane).to(self.device)
            self.hk = torch.from_numpy(self._exact.host_kmer).to(self.device)
        self.columns = ColumnPool(pinned=self.device.type == "cuda")

    def _new_set(self, pooled: bool) -> PassSet:
        """A zeroed pass set on the lookup's device."""
        return PassSet(self.channels, self.slots, self.device, self._stream,
                       pooled)

    def _probe(self, s: PassSet):
        """The plane pass over the set's tiles, into its answers, on the
        current stream: the packed int32 ``[channels/4, S]``."""
        return stream_probe(self.fp, s.tiles, self.w, self.channels,
                            out=s.answers)

    def _staged(self, n: int, dtype) -> torch.Tensor:
        """Host memory for a copy to or from the device: page-locked (torch's
        caching host allocator, which holds a block until the copies that
        use it are done) on CUDA."""
        return torch.empty(n, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def _scatter_into(self, s: PassSet, values: np.ndarray) -> tuple:
        """Scatter one chunk's queries into set ``s``: the columns its pass
        needs besides (values, cnt, pos): the values sent up without
        blocking (``stream.upload``; first staged in page-locked memory
        unless they are there already, ``stream.staged_queries``) and one
        scatter launch; returns (device values, device results, each
        query's channel until the pass resolves it)."""
        s.dirty = True
        with span("stream.scatter"), on_stream(self._stream), \
                _device_fault("scatter", "stream scatter"):
            with span("stream.upload"):
                dv = torch.from_numpy(values)
                if self.device.type == "cuda":
                    staged = not dv.is_pinned()
                    count("stream.staged_queries", len(values) * staged)
                    if staged:
                        dv = self._staged(len(values), torch.int64).copy_(dv)
                    dv = dv.to(self.device, non_blocking=True)
            res = torch.empty(len(values), dtype=torch.int32,
                              device=self.device)
            scatter_tiles(dv, s.tiles, s.occ, res, self.num_sigs)
        return dv, res

    def _pass(self, s: PassSet, chunks, n: int):
        """One plane pass over the ``n`` queries of ``chunks`` scattered into
        set ``s``, counted, and the set reset: the probe, a resolve launch
        a chunk, the hits compacted in query order, their query index and
        table slot back into page-locked memory with the counts, the reset
        issued, and the copies waited for (``stream.readback``); returns
        int32 ``[2, hits]`` on the host."""
        with on_stream(self._stream), _device_fault("pass", "stream probe"):
            with span("stream.readback"):
                answers = self._probe(s)
                for c in chunks:
                    resolve_tiles(c[3], c[4], answers, self.fe, self.hk,
                                  self.num_sigs, self.w,
                                  self._exact.full_window, s.counts)
                res = torch.cat([c[4] for c in chunks])
                at = torch.nonzero(res >= 0).squeeze(1)
                hits = self._staged(2 * len(at), torch.int32).view(
                    2, len(at))
                hits.copy_(torch.stack([at.to(torch.int32), res[at]]),
                           non_blocking=True)
                tally = self._staged(3, torch.int64)
                tally.copy_(s.counts, non_blocking=True)
                done = None
                if self._stream is not None:
                    done = torch.cuda.Event()
                    done.record(self._stream)
                s.zero()
                if done is not None:
                    done.synchronize()
        over, fell, k = tally.tolist()
        if k != hits.shape[1]:
            raise KernelError(f"the resolve counted {k} hits, its slots "
                              f"{hits.shape[1]}")
        self._count_pass(n, 8 * n, hits.nbytes + tally.nbytes)
        count("stream.overflow_queries", over)
        count("stream.fallback_queries", fell)
        return hits.numpy()

    def _count_pass(self, queries: int, up: int, down: int) -> None:
        count("stream.passes", 1)
        count("stream.queries", queries)
        count("stream.bytes_up", up)
        count("stream.bytes_down", down)

    def lookup(self, values: np.ndarray, cnt_id, pos: np.ndarray,
               progress=None, compute_kmers_found: bool = True
               ) -> LookupHits:
        """One-shot lookup of a buffered query batch: scatter into a set of
        the pool, one plane pass, decode, and the set given back zeroed."""
        values = np.ascontiguousarray(values, dtype=np.int64)
        n = len(values)
        if n == 0:
            z = np.zeros(0)
            return LookupHits.from_lists(z, z, z, z, z, z, 0)
        cnt = np.ascontiguousarray(
            np.broadcast_to(np.asarray(cnt_id, dtype=np.int64), (n,)))
        pos = np.ascontiguousarray(pos, dtype=np.int64)
        s = self._sets.take()
        try:
            chunks = [(values, cnt, pos, *self._scatter_into(s, values))]
            with span("stream.pass"):
                out = self._pass(s, chunks, n)
                return self._decode(out, chunks, n, progress,
                                    compute_kmers_found)
        finally:
            if s.dirty:
                s.zero()
            self._sets.give_back(s)

    def _decode(self, out, chunks, n_total: int, progress,
                compute_kmers_found: bool, want_values: bool = False):
        """The hits of one pass, in query order, from what ``_pass``
        returned. ``chunks`` is the pass's list of per-chunk columns
        (values, cnt, pos, then ``_scatter_into``'s). With ``want_values``
        returns (hits, hit values): the multi-pass front end merges
        kmers-found across passes from the values. Without the native
        library (no g++, or ``KMER_NO_NATIVE_SCATTER``) numpy gathers the
        columns."""
        from ..utils.native import load_scatter

        lib = load_scatter()
        with span("stream.decode"):
            t_otu, t_avg, t_fi, t_wt = self._exact._table_cols()
            at, slots = out
            k = len(at)
            o_cnt = np.empty(k, dtype=np.int64)
            o_pos = np.empty(k, dtype=np.int64)
            o_otu = np.empty(k, dtype=np.int32)
            o_avg = np.empty(k, dtype=np.int32)
            o_fi = np.empty(k, dtype=np.int32)
            o_wt = np.empty(k, dtype=np.float32)
            o_val = np.empty(k, dtype=np.int64)
            # the hits are in query order: each chunk's are one range
            base, j = 0, 0
            for v, c, p, *_ in chunks:
                e = int(np.searchsorted(at, base + len(v)))
                if lib is not None:
                    lib.emit_hits_at(
                        v, c, p, at[j:e], slots[j:e], e - j, base, t_otu,
                        t_avg, t_fi, t_wt, o_cnt[j:], o_pos[j:], o_otu[j:],
                        o_avg[j:], o_fi[j:], o_wt[j:], o_val[j:])
                else:
                    i, sl = at[j:e] - base, slots[j:e]
                    for o, col in ((o_cnt, c[i]), (o_pos, p[i]),
                                   (o_otu, t_otu[sl]), (o_avg, t_avg[sl]),
                                   (o_fi, t_fi[sl]), (o_wt, t_wt[sl]),
                                   (o_val, v[i])):
                        o[j:e] = col
                base, j = base + len(v), e
            if progress is not None:
                progress.update(n_total, k)
            hits = LookupHits(
                cnt_id=o_cnt, pos=o_pos, otu=o_otu, avg_from_end=o_avg,
                fi=o_fi, wt=o_wt,
                kmers_found=(int(np.unique(o_val).size)
                             if compute_kmers_found else -1))
        return (hits, o_val) if want_values else hits


class StreamingStreamLookup:
    """Feed-as-you-parse front end for the stream kernel.

    Duck-types the query store's ``add_batch`` so the prepare phase scatters
    each chunk of query k-mers straight into a pass set's tiles (a per-slot
    channel-occupancy counter carries collision ranks across chunks, and a
    home's taken channels dedup its values), and ``finish()`` runs the last
    plane pass. Bounded memory (the reference's inputSizeLimit, ref
    KmerGutsJava.java:822-889): every ``flush_limit`` queries, one pass
    probes, decodes and keeps only the hits. Each pass is exact on its own
    queries; extra passes re-stream the plane.

    Three threads. The caller parses and feeds. A worker scatters each
    chunk in feed order (``_scatter_into``: on the lookup's device, its
    values up and one kernel launch, issued on the lookup's stream without
    waiting; the sharded lookup's native host scatter, a ctypes call that
    releases the GIL); at a flush it hands the full set to the pass thread
    and scatters on into the lookup's other set. The pass thread runs the
    passes in order (probe, resolve, read-back and the set's reset, then the
    decode). All tile and chunk state is the worker's until it is joined.
    ``finish()`` runs the tail pass beside the pass thread, merges the
    passes' hits in pass order, stops the pass thread and gives the sets
    back; ``close()`` does the same for a front end that did not finish.

    Memory stays within what one pass in flight and the feed's
    ``FEED_CHUNKS`` queued chunks hold: a chunk scattered while a pass is
    in flight keeps its place among those until no pass is in flight.

    Over a lookup with ``columns`` (the single-card one) the front end
    lends the prepare each chunk's host columns (``query_columns``) and
    gives them back to the lookup's pool once the chunk's pass is decoded;
    over the sharded lookup it lends none.
    """

    _FLUSH = object()  # queue marker: run one bounded-memory pass
    FEED_CHUNKS = 4

    def __init__(self, lk: StreamLookup, compute_kmers_found: bool = False,
                 flush_limit: Optional[int] = None):
        import queue

        self.lk = lk
        self.compute_kmers_found = compute_kmers_found
        self.flush_limit = flush_limit
        self._set: Optional[PassSet] = lk._sets.take()  # being scattered
        self._owned = [self._set]  # every set this front end took
        self._chunks: list = []   # per chunk: (v, cnt, pos, *_scatter_into)
        self._bufs: list = []     # per chunk: its lent columns, or None
        self._lent: dict = {}     # values' address -> columns not yet fed
        if lk.columns is None:  # the sharded lookup: the prepare's own
            self.query_columns = None
        self._pending = 0         # queries scattered into _set
        self._results: list = []  # per pass handed off: its Future
        self.passes = 0           # plane passes run
        self._since_flush = 0     # feed-side trigger counter
        self.total_fed = 0
        self._worker_error: Optional[BaseException] = None
        self._abort = False
        # a chunk takes a feed slot when fed and frees it when the worker
        # takes it up, or, scattered beside a pass in flight, once no pass
        # is in flight
        self._slots = threading.Semaphore(self.FEED_CHUNKS)
        self._lock = threading.Lock()
        self._in_flight = 0
        self._held = 0
        self._spare = queue.Queue()  # own sets the pass thread has zeroed
        self._pass_q = queue.Queue()
        self._passer = threading.Thread(target=self._pass_loop, daemon=True)
        self._passer.start()
        self._start_worker()

    def _start_worker(self) -> None:
        import queue

        self._queue = queue.Queue()

        def drain():
            while True:
                item = self._queue.get()
                if item is None:
                    return
                if self._abort:
                    continue
                try:
                    if item is StreamingStreamLookup._FLUSH:
                        self._flush_now()
                    else:
                        self._scatter_chunk(*item)
                except BaseException as ex:  # surfaced at finish()
                    self._worker_error = ex
                    return

        self._worker = threading.Thread(target=drain, daemon=True)
        self._worker.start()

    def _scatter_chunk(self, values, cnt, pos, buf) -> None:
        if self._set is None:
            self._set = self._next_set()
        with self._lock:
            beside = self._in_flight > 0
            self._held += beside
        if not beside:
            self._slots.release()
        self._chunks.append(
            (values, cnt, pos, *self.lk._scatter_into(self._set, values)))
        self._bufs.append(buf)
        self._pending += len(values)
        count("stream.overlap_queries", len(values) if beside else 0)

    def _next_set(self) -> PassSet:
        """The set to scatter into after a hand-off: the lookup's other one
        while this front end holds one, else its own back from the pass
        thread once zeroed."""
        if len(self._owned) < 2:
            s = self.lk._sets.take()
            self._owned.append(s)
            return s
        with span("stream.set_wait"):
            return self._spare.get()

    def _flush_now(self) -> None:
        """One bounded-memory pass over everything scattered since the
        last: the set goes to the pass thread, and the next chunk takes
        another."""
        if self._pending:
            self._hand_off()

    def _hand_off(self) -> None:
        from concurrent.futures import Future

        done = Future()
        with self._lock:
            self._in_flight += 1
        self._results.append(done)
        self._pass_q.put((self._set, self._chunks, self._bufs, self._pending,
                          done))
        self.passes += 1
        self._set, self._chunks, self._bufs, self._pending = None, [], [], 0

    def _run_pass(self, s: PassSet, chunks, n: int):
        """One plane pass over the ``n`` queries of ``chunks`` in set
        ``s``: (hits, the hits' distinct values or None)."""
        with span("stream.pass"):
            out = self.lk._pass(s, chunks, n)
            if not self.compute_kmers_found:
                return self.lk._decode(out, chunks, n, None, False), None
            hits, vals = self.lk._decode(out, chunks, n, None, False,
                                         want_values=True)
            return hits, np.unique(vals)

    def _pass_loop(self) -> None:
        """The pass thread: each pass handed off, in order (the pass resets
        its set), then the set back to the worker and, once decoded, its
        chunks' columns back to the pool."""
        while True:
            job = self._pass_q.get()
            if job is None:
                return
            s, chunks, bufs, n, done = job
            try:
                got = self._run_pass(s, chunks, n)
                self._give_back(bufs)
                done.set_result(got)
            except BaseException as ex:  # surfaced at finish()
                done.set_exception(ex)
            finally:
                self._pass_ended()
                if s.dirty:
                    s.zero()
                self._spare.put(s)
                job = chunks = bufs = None  # the chunks' buffers

    def _give_back(self, bufs=None) -> None:
        """A decoded pass's lent columns (the tail pass's without
        ``bufs``), back to the lookup's pool: its values went up before its
        pass ended, and its hits are copies."""
        if bufs is None:
            bufs, self._bufs = self._bufs, []
        if self.lk.columns is not None:
            self.lk.columns.give_back(bufs)

    def _pass_ended(self) -> None:
        """A pass is decoded: once none is in flight, the chunks scattered
        beside it free their feed slots."""
        with self._lock:
            self._in_flight -= 1
            free = 0 if self._in_flight else self._held
            self._held -= free
        if free:
            self._slots.release(free)

    def _release(self) -> None:
        """Once the worker is joined: stop the pass thread after the passes
        queued before it, and give every set back to the lookup, zeroing
        one that a failed pass left dirty."""
        if self._passer.is_alive():
            self._pass_q.put(None)
            self._passer.join()
        for s in self._owned:
            if s.dirty:
                s.zero()
            self.lk._sets.give_back(s)
        self._owned = []

    def _put_checked(self, item) -> None:
        """Take a feed slot, then queue the chunk; a dead worker frees no
        slot, so its error is re-checked while none is free. Its time is
        the feed's wait on the worker, ``prepare.feed_wait``."""
        with span("prepare.feed_wait"):
            while True:
                if self._worker_error is not None:
                    raise self._worker_error
                if self._slots.acquire(timeout=1.0):
                    break
        self._queue.put(item)

    def query_columns(self, n: int) -> tuple:
        """Three int64 columns of ``n`` rows (value, container, position)
        for the prepare to write a chunk into and then feed through
        ``add_batch``, which takes them with no copy: buffers of the
        lookup's pool (``ColumnPool``), the values page-locked on CUDA."""
        buf = self.lk.columns.take(n)
        cols = tuple(c[:n] for c in buf)
        self._lent[cols[0].ctypes.data] = buf
        return cols

    def add_batch(self, values: np.ndarray, cnt_id, pos: np.ndarray) -> None:
        values = np.ascontiguousarray(values, dtype=np.int64)
        n = len(values)
        if n == 0:
            return
        cnt = np.ascontiguousarray(
            np.broadcast_to(np.asarray(cnt_id, dtype=np.int64), (n,)))
        pos = np.ascontiguousarray(pos, dtype=np.int64)
        self.total_fed += n
        self._since_flush += n
        self._put_checked((values, cnt, pos,
                           self._lent.pop(values.ctypes.data, None)))
        if self.flush_limit and self._since_flush >= self.flush_limit:
            # the pass queues behind the pending chunks: the pass thread
            # probes and decodes while the worker scatters on and this
            # thread keeps parsing and feeding
            self._since_flush = 0
            self._queue.put(StreamingStreamLookup._FLUSH)

    def _join_worker(self, raise_error: bool = True) -> None:
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join()
            self._worker = None
            self._queue = None
        if raise_error and self._worker_error is not None:
            raise self._worker_error

    def partial_hits(self) -> LookupHits:
        """Nothing is probed before finish(); an error mid-prepare has found
        no hits yet (the reference reports whatever was found,
        ref :797-802)."""
        z = np.zeros(0)
        return LookupHits.from_lists(z, z, z, z, z, z,
                                     0 if self.compute_kmers_found else -1)

    def finish(self, progress=None) -> LookupHits:
        try:
            with span("engine.worker_wait"):
                self._join_worker()
            if not self._results:
                if not self.total_fed:
                    return self.partial_hits()
                with span("stream.pass"):
                    out = self.lk._pass(self._set, self._chunks,
                                        self._pending)
                    self.passes += 1
                    hits = self.lk._decode(out, self._chunks, self._pending,
                                           progress, self.compute_kmers_found)
                self._give_back()
                return hits
            # several passes: the tail beside the pass thread, then every
            # pass's hits in pass order
            tail = []
            if self._pending:
                self.passes += 1
                tail.append(self._run_pass(self._set, self._chunks,
                                           self._pending))
                self._give_back()
            with span("engine.worker_wait"):
                done = [d.result() for d in self._results] + tail
        finally:
            self._release()
        passes = [hits for hits, _ in done]
        kf = (int(np.unique(np.concatenate([v for _, v in done])).size)
              if self.compute_kmers_found else -1)
        merged = LookupHits(
            cnt_id=np.concatenate([p.cnt_id for p in passes]),
            pos=np.concatenate([p.pos for p in passes]),
            otu=np.concatenate([p.otu for p in passes]),
            avg_from_end=np.concatenate([p.avg_from_end for p in passes]),
            fi=np.concatenate([p.fi for p in passes]),
            wt=np.concatenate([p.wt for p in passes]),
            kmers_found=kf)
        if progress is not None:
            progress.update(self.total_fed, len(merged))
        return merged

    def close(self) -> None:
        """Stop the threads and give the sets back, where finish() has not
        (a failed prepare drops what is queued)."""
        if self._worker is not None:
            self._abort = True
            self._join_worker(raise_error=False)
        self._release()
