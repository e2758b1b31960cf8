"""Dense stream probe (the port of the TPU stream kernel): the hand-written
CUDA kernel's wrapper, its plain PyTorch twin, and the lookups around it.

Replaces the Pallas TPU kernel ``_stream_block_kernel`` of
``kmergutsjava_tpu/lookup/pallas_stream.py`` (launched there by
``stream_probe_blocks``); ``StreamLookup`` and ``StreamingStreamLookup``
are the counterparts of its ``PallasStreamLookup`` and
``StreamingStreamLookup``. The regime is dense query sets (a read set or a
genome against a table of comparable size): instead of one window gather
per query, queries are scattered on the host by home slot into a dense tile
``tiles[c, s]`` (the fingerprint of the c-th distinct query whose home is
slot ``s``, up to C channels; the rare extras take the exact host pass),
and one pass over the whole fingerprint plane answers them all. For each
slot and channel the kernel returns the raw first fingerprint-match offset
in the ``w``-slot window (``w`` if none), four channels packed per int32.
Stop-at-empty needs no query data, so the host applies it from a per-slot
empty-distance plane; candidates are verified against the full k-mer values
and unresolved queries take the exact full-window pass (the JAX package's
native decode, ``resolve_slots`` + ``emit_hits``).

Layout: plane u16 ``[S + w]`` (S = the slot count padded to a multiple of
4, then at least ``w`` FP_EMPTY slots), tiles u16 ``[C, S]``, output
int32 ``[C/4, S]``: one contiguous plane per channel. The native scatter
(``scatter_chunk``) produces it with ``rows=1, block=S``. The TPU layout's
overlapped ``[nsuper, ROWS, BLOCK + HALO]`` rows and its bf16 form are
Mosaic workarounds and are not carried.

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
from .parity import LookupHits
from .sparse import (FP_EMPTY, FP_MOD, HostWindow, _device_fault,
                     fingerprint_plane, on_stream, owned_stream, torch_device)
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


def _run(fp, qfp_tiles, w, channels, reps: Optional[int]):
    """The twin for CPU tensors; else one launch of the ``stream_probe``
    entry (``reps`` None) or of ``stream_probe_reps``. Returns (out,
    launched)."""
    if fp.device.type == "cpu":
        return stream_probe_reference(fp, qfp_tiles, w, channels), False
    if fp.device.type != "cuda":
        raise KernelError(f"no stream kernel for device {fp.device}")
    slots = qfp_tiles.shape[1]
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
                 channels: int = CHANNELS) -> torch.Tensor:
    """Raw first fingerprint-match offset of every (channel, slot) tile cell
    in the ``w``-slot window from that slot (``w`` if none), packed four
    channels per int32: int32 ``[channels/4, S]`` on the inputs' device.
    CPU tensors run the plain twin; CUDA tensors launch the kernel on the
    current stream (or raise KernelError). fp: u16 ``[>= S + w]``,
    qfp_tiles: u16 ``[channels, S]``."""
    global launches
    _check(fp, qfp_tiles, w, channels)
    out, launched = _run(fp, qfp_tiles, w, channels, None)
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


class StreamLookup:
    """Dense-regime lookup: slot-major query tiles against one pass over the
    device-resident fingerprint plane. Same exact-result contract as the
    sparse lookup (differentially tested against ``lookup/parity.py``).

    All device work is issued on one CUDA stream the lookup owns; a torch
    RuntimeError from upload, launch or read-back becomes a KernelError.
    """

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
        # exact path: host verification column + full-window fallback
        self._exact = HostWindow(table, probe_window)
        self.slots = -(-s // SLOT_ALIGN) * SLOT_ALIGN
        fp = fingerprint_plane(table, self.slots + self.w)
        # Per-slot distance to the first empty slot at or after it, capped
        # at w: stop-at-empty depends only on the table, so it is computed
        # here once and applied on the host. (The padded tail is all empty,
        # so every slot has a next empty.)
        n = len(fp)
        e_idx = np.where(fp == FP_EMPTY, np.arange(n, dtype=np.int64),
                         np.int64(2 * n))
        nxt = np.minimum.accumulate(e_idx[::-1])[::-1]
        self.fe_plane = np.minimum(nxt - np.arange(n, dtype=np.int64),
                                   self.w).astype(np.uint8)
        self._place_plane(fp, device)

    def _place_plane(self, fp: np.ndarray, device: str) -> None:
        """Upload the plane to ``device``, on a stream the lookup owns."""
        self.device = torch_device(device)
        self._stream = owned_stream(self.device)
        with on_stream(self._stream), _device_fault("upload", "stream probe"):
            self.fp = torch.from_numpy(fp).to(self.device)

    def new_tiles(self) -> np.ndarray:
        return np.zeros((self.channels, self.slots), dtype=np.uint16)

    def _probe(self, tiles: np.ndarray) -> np.ndarray:
        """Upload the tiles, run one plane pass, read the packed answer
        back: int32 ``[channels/4, S]``. The read-back synchronizes the
        lookup's stream, so the caller may reuse ``tiles`` on return."""
        with on_stream(self._stream), \
                _device_fault("pass", "stream probe"):
            t = torch.from_numpy(tiles).to(self.device)
            out = stream_probe(self.fp, t, self.w, self.channels)
            return out.cpu().numpy()

    def _scatter(self, values: np.ndarray, tiles: Optional[np.ndarray] = None,
                 occ: Optional[np.ndarray] = None):
        """Bucket queries into the ``[C, S]`` tile.

        Returns (tiles, homes, flat, shift), the columns full query length:
        ``flat`` is the element index into the flattened kernel output
        ``[C/4, S]`` and ``shift`` the bit shift of the query's packed
        byte, or -1 where the query found its home slot's C channels taken
        (decode routes those to the exact fallback). With ``tiles``/``occ``
        given (the streaming front end), scatters into the caller's tile
        and advances the per-slot channel occupancy."""
        from ..utils.native import load_scatter

        lib = load_scatter()
        if lib is not None:
            return self._scatter_native(lib, values, tiles, occ)
        return self._scatter_numpy(values, tiles, occ)

    def _scatter_numpy(self, values, tiles=None, occ=None):
        """numpy twin of ``scatter_chunk``: duplicate values share one tile
        cell (equal values have equal homes and fingerprints), and a home's
        distinct values take channels in value order."""
        values = np.asarray(values, dtype=np.int64)
        homes = values % np.int64(self.num_sigs)
        uniq, inv = np.unique(values, return_inverse=True)
        nu = len(uniq)
        h_u = uniq % np.int64(self.num_sigs)
        order = np.argsort(h_u, kind="stable")
        h_s = h_u[order]
        rank = np.arange(nu) - np.searchsorted(h_s, h_s)
        if occ is not None:
            rank = rank + occ[h_s]
            uh, counts = np.unique(h_s, return_counts=True)
            occ[uh] = np.minimum(occ[uh].astype(np.int64) + counts,
                                 255).astype(occ.dtype)
        ok = rank < self.channels
        h_ok = h_s[ok]
        rk = rank[ok]
        tiles = self.new_tiles() if tiles is None else tiles
        tiles[rk, h_ok] = (uniq[order[ok]] % FP_MOD).astype(np.uint16)
        flat_u = np.zeros(nu, dtype=np.int64)
        shift_u = np.full(nu, -1, dtype=np.int32)
        flat_u[order[ok]] = (rk >> 2) * self.slots + h_ok
        shift_u[order[ok]] = 8 * (rk & 3)
        return tiles, homes, flat_u[inv], shift_u[inv]

    def _scatter_native(self, lib, values, tiles=None, occ=None):
        """C++ scatter (``native/scatter.cpp``) in the
        ``rows=1, block=S`` layout: cell (c, h) at ``c*S + h``, output
        element ``(c//4)*S + h``. Dedup is by (home, fingerprint) against
        the tile itself, so it holds across streaming chunks; channel ranks
        follow encounter order (another valid overflow split than the
        numpy twin's, with identical hits)."""
        values = np.ascontiguousarray(values, dtype=np.int64)
        n = len(values)
        tiles = self.new_tiles() if tiles is None else tiles
        if occ is None:
            occ = np.zeros(self.num_sigs, dtype=np.uint8)
        homes = np.empty(n, dtype=np.int64)
        flat = np.empty(n, dtype=np.int64)
        shift = np.empty(n, dtype=np.int32)
        lib.scatter_chunk(values, n, self.num_sigs, self.channels,
                          self.slots, 1, FP_MOD, tiles.reshape(-1), occ,
                          homes, flat, shift)
        return tiles, homes, flat, shift

    def lookup(self, values: np.ndarray, cnt_id, pos: np.ndarray,
               progress=None, compute_kmers_found: bool = True
               ) -> LookupHits:
        """One-shot lookup of a buffered query batch: scatter, one plane
        pass, decode."""
        values = np.ascontiguousarray(values, dtype=np.int64)
        n = len(values)
        if n == 0:
            z = np.zeros(0)
            return LookupHits.from_lists(z, z, z, z, z, z, 0)
        tiles, homes, flat, shift = self._scatter(values)
        out = self._probe(tiles)
        cnt = np.ascontiguousarray(
            np.broadcast_to(np.asarray(cnt_id, dtype=np.int64), (n,)))
        pos = np.ascontiguousarray(pos, dtype=np.int64)
        return self._decode(out, [(values, cnt, pos, homes, flat, shift)],
                            n, progress, compute_kmers_found)

    def _decode(self, out, chunks, n_total: int, progress,
                compute_kmers_found: bool, want_values: bool = False):
        """Resolve the kernel output into hits: stop-at-empty gating,
        verification of fingerprint candidates against the full k-mer
        values, the exact full-window pass for unresolved and overflowed
        queries, and hit compaction. ``chunks`` is a list of full-length
        query column tuples (v, cnt, pos, homes, flat, shift). With
        ``want_values`` returns (hits, hit values): the multi-pass front
        end merges kmers-found across passes from the values."""
        from ..utils.native import load_scatter

        lib = load_scatter()
        if lib is not None:
            return self._decode_native(lib, out, chunks, n_total, progress,
                                       compute_kmers_found, want_values)
        return self._decode_numpy(out, chunks, n_total, progress,
                                  compute_kmers_found, want_values)

    def _decode_native(self, lib, out, chunks, n_total: int, progress,
                       compute_kmers_found: bool, want_values: bool = False):
        """Two native passes (``resolve_slots`` + ``emit_hits``, both
        thread-parallel): the first returns the exact hit count, so the hit
        columns are allocated at their final size."""
        t_otu, t_avg, t_fi, t_wt = self._exact._table_cols()
        hk = self._exact.host_kmer
        out_flat = np.ascontiguousarray(out.reshape(-1))
        slots = []
        k_total = 0
        for v, c, p, h, fl, sh in chunks:
            s = np.empty(len(v), dtype=np.int64)
            k_total += lib.resolve_slots(
                v, h, fl, sh, len(v), out_flat, self.fe_plane, hk, len(hk),
                self.w, self._exact.full_window, s)
            slots.append(s)
        o_cnt = np.empty(k_total, dtype=np.int64)
        o_pos = np.empty(k_total, dtype=np.int64)
        o_otu = np.empty(k_total, dtype=np.int32)
        o_avg = np.empty(k_total, dtype=np.int32)
        o_fi = np.empty(k_total, dtype=np.int32)
        o_wt = np.empty(k_total, dtype=np.float32)
        o_val = np.empty(k_total, dtype=np.int64)
        k = 0
        for (v, c, p, _, _, _), s in zip(chunks, slots):
            k += lib.emit_hits(
                v, c, p, s, len(v), t_otu, t_avg, t_fi, t_wt,
                o_cnt[k:], o_pos[k:], o_otu[k:], o_avg[k:], o_fi[k:],
                o_wt[k:], o_val[k:])
        if progress is not None:
            progress.update(n_total, k)
        hits = LookupHits(
            cnt_id=o_cnt, pos=o_pos, otu=o_otu, avg_from_end=o_avg,
            fi=o_fi, wt=o_wt,
            kmers_found=(int(np.unique(o_val).size)
                         if compute_kmers_found else -1))
        return (hits, o_val) if want_values else hits

    def _decode_numpy(self, out, chunks, n_total: int, progress,
                      compute_kmers_found: bool, want_values: bool = False):
        def cat(k):
            if not chunks:
                return np.zeros(0, dtype=np.int64)
            return np.concatenate([ch[k] for ch in chunks])

        av, ac, ap, ah, aflat, ashift = (cat(k) for k in range(6))
        sel = ashift >= 0
        pv, pc, pp, ph = av[sel], ac[sel], ap[sel], ah[sel]
        packed = out.reshape(-1)[aflat[sel]] >> ashift[sel]
        off = (packed & 0xFF).astype(np.int64)  # first fp match, w if none
        fe = self.fe_plane[ph].astype(np.int64)
        # a candidate counts only strictly before the first empty slot;
        # off == w (no match) can't pass, since fe <= w
        has_cand = off < fe
        empty_any = fe < self.w
        host_kmer = self._exact.host_kmer
        cand_slot = np.minimum(ph + off, len(host_kmer) - 1)
        verified = has_cand & (host_kmer[cand_slot] == pv)
        unresolved = (~verified & has_cand) | (~has_cand & ~empty_any)
        over = ~sel
        tv = np.concatenate([pv[unresolved], av[over]])
        tc = np.concatenate([pc[unresolved], ac[over]])
        tp = np.concatenate([pp[unresolved], ap[over]])
        th = np.concatenate([ph[unresolved], ah[over]])
        if len(tv):
            # the fallback outcome depends only on the value: probe each
            # distinct value once
            uv, inv = np.unique(tv, return_inverse=True)
            fu, ou = self._exact._host_full_window(
                uv, (uv % np.int64(self.num_sigs)).astype(np.int32),
                np.arange(len(uv), dtype=np.int64))
            f2, o2 = fu[inv], ou[inv]
        else:
            f2 = np.zeros(0, dtype=bool)
            o2 = np.zeros(0, dtype=np.int64)
        slots = np.concatenate([
            cand_slot[verified],
            np.minimum(th[f2] + o2[f2], self.num_sigs - 1)])
        hit_v = np.concatenate([pv[verified], tv[f2]])
        t = self.table.slots
        if progress is not None:
            progress.update(n_total, len(slots))
        hits = LookupHits(
            cnt_id=np.concatenate([pc[verified], tc[f2]]).astype(np.int64),
            pos=np.concatenate([pp[verified], tp[f2]]).astype(np.int64),
            otu=t["otu"][slots].copy(),
            avg_from_end=t["avg_from_end"][slots].copy(),
            fi=t["fi"][slots].copy(), wt=t["wt"][slots].copy(),
            kmers_found=(int(np.unique(hit_v).size)
                         if compute_kmers_found else -1))
        return (hits, hit_v) if want_values else hits


class StreamingStreamLookup:
    """Feed-as-you-parse front end for the stream kernel.

    Duck-types the query store's ``add_batch`` so the prepare phase scatters
    each chunk of query k-mers straight into the persistent tiles (a
    per-slot channel-occupancy counter carries collision ranks across
    chunks), and ``finish()`` runs the plane pass. Bounded memory (the
    reference's inputSizeLimit, ref KmerGutsJava.java:822-889): every
    ``flush_limit`` queries, one pass probes, decodes, keeps only the hits
    and resets the tiles and occupancy. Each pass is exact on its own
    queries; extra passes re-stream the plane.

    One worker thread runs the native scatter (a ctypes call that releases
    the GIL) and the passes, in feed order, while the caller keeps parsing;
    all tile, chunk and pass state is the worker's until the final join.
    """

    _FLUSH = object()  # queue marker: run one bounded-memory pass

    def __init__(self, lk: StreamLookup, compute_kmers_found: bool = False,
                 flush_limit: Optional[int] = None):
        self.lk = lk
        self.compute_kmers_found = compute_kmers_found
        self.flush_limit = flush_limit
        self.qfp_tiles = lk.new_tiles()
        self._occ = np.zeros(lk.num_sigs, dtype=np.uint8)
        self._chunks: list = []   # per chunk: (v, cnt, pos, homes, flat, shift)
        self._passes: list = []   # completed passes' LookupHits
        self._pass_values: list = []  # per pass: unique hit values (debug)
        self._pending = 0         # queries scattered but not yet probed
        self.passes = 0           # plane passes run
        self._since_flush = 0     # feed-side trigger counter
        self.total_fed = 0
        self._worker_error: Optional[BaseException] = None
        self._start_worker()

    def _start_worker(self) -> None:
        import queue

        self._queue = queue.Queue(maxsize=4)

        def drain():
            while True:
                item = self._queue.get()
                if item is None:
                    return
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

    def _scatter_chunk(self, values, cnt, pos) -> None:
        _, homes, flat, shift = self.lk._scatter(
            values, tiles=self.qfp_tiles, occ=self._occ)
        self._chunks.append((values, cnt, pos, homes, flat, shift))
        self._pending += len(values)

    def _flush_now(self) -> None:
        """One bounded-memory pass over everything scattered so far: probe,
        decode, keep only the hits, reset the tiles and occupancy (the
        probe's read-back has synchronized the upload by then)."""
        if not self._pending:
            return
        out = self.lk._probe(self.qfp_tiles)
        self.passes += 1
        if self.compute_kmers_found:
            hits, vals = self.lk._decode(out, self._chunks, self._pending,
                                         None, False, want_values=True)
            self._pass_values.append(np.unique(vals))
        else:
            hits = self.lk._decode(out, self._chunks, self._pending, None,
                                   False)
        self._passes.append(hits)
        self._chunks = []
        self._pending = 0
        self.qfp_tiles.fill(0)
        self._occ.fill(0)

    def _put_checked(self, item) -> None:
        """Bounded put that can't deadlock on a dead worker: re-check the
        worker error whenever the queue stays full."""
        import queue

        while True:
            if self._worker_error is not None:
                raise self._worker_error
            try:
                self._queue.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

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
        self._put_checked((values, cnt, pos))
        if self.flush_limit and self._since_flush >= self.flush_limit:
            # the pass queues behind the pending chunks: the worker probes
            # and decodes while this thread keeps parsing and feeding
            self._since_flush = 0
            self._put_checked(StreamingStreamLookup._FLUSH)

    def _join_worker(self) -> None:
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join()
            self._worker = None
            self._queue = None
            if self._worker_error is not None:
                raise self._worker_error

    def partial_hits(self) -> LookupHits:
        """Nothing is probed before finish(); an error mid-prepare has found
        no hits yet (the reference reports whatever was found,
        ref :797-802)."""
        z = np.zeros(0)
        return LookupHits.from_lists(z, z, z, z, z, z,
                                     0 if self.compute_kmers_found else -1)

    def finish(self, progress=None) -> LookupHits:
        self._join_worker()
        if not self._passes:
            if not self.total_fed:
                return self.partial_hits()
            out = self.lk._probe(self.qfp_tiles)
            self.passes += 1
            return self.lk._decode(out, self._chunks, self._pending,
                                   progress, self.compute_kmers_found)
        # multi-pass: flush the tail, then merge the per-pass hits
        self._flush_now()
        passes = self._passes
        kf = (int(np.unique(np.concatenate(self._pass_values)).size)
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
