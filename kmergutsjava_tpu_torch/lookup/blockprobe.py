"""Window probe with the TPU block probe's encoding (the port of the kernel
behind the ``pallas`` backend): the hand-written CUDA kernel's wrapper, its
plain PyTorch twin, and ``BlockProbeLookup`` around them.

Replaces the Pallas TPU kernel ``_probe_block_kernel`` of
``kmergutsjava_tpu/lookup/pallas_kernel.py`` (launched there by
``probe_blocks``); ``BlockProbeLookup`` is the counterpart of its
``PallasLookup``. For each query the kernel reports, in the ``w``-slot
window of the fingerprint plane from its home slot, the first fingerprint
candidate and whether an empty slot comes first or anywhere (see
``csrc/block_probe.cu`` for the exact encoding, which is not the tile-join
kernel's). Candidates are verified on the host against the full k-mer
values; fingerprint collisions that fail verification and windows with
neither a candidate nor an empty slot take the exact backend, the sparse
lookup (``lookup/sparse.py``) on the same device.

Layout: a flat plane u16 ``[num_sigs + 128]`` (slots past the table hold
FP_EMPTY, so a window never wraps) and the queries' fingerprints and homes
in the caller's order. The TPU kernel merges home-sorted queries into
2048-slot plane blocks (overlapped ``[nblocks, 1, 2176]`` rows and
2176-query tiles, for Mosaic's BlockSpec); on the H100 one thread a query
reads its own window as aligned 16-byte vectors, so nothing is sorted and
nothing has a capacity, and each answer lands at its query's position.

The kernel is compiled with nvcc for sm_90a into a plain-C shared library
on first use and loaded with ctypes; nothing is built or imported for CUDA
when this module is imported.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.kmer_table import KmerTable
from .parity import LookupHits
from .sparse import (FP_EMPTY, FP_MOD, SparseLookup, _check_int32_homes,
                     _device_fault, _round_up_pow2, fingerprint_plane,
                     on_stream, owned_stream)
from .tilejoin import KernelError, _widen, build_cuda_library

HALO = 128  # slots past the table: the largest window

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "block_probe.cu")

# kernel launches since import (or since a caller reset it to 0); counted
# only where the wrapper launches the CUDA kernel, never for the twin
launches = 0

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
        fn = lib.block_probe
        fn.restype = ctypes.c_int
        p = ctypes.c_void_p
        i64 = ctypes.c_int64
        fn.argtypes = [p, i64, p, p, i64, ctypes.c_int32, p, p, p]
        _lib = lib
        return lib


def block_probe_reference(fp: torch.Tensor, q_fp: torch.Tensor,
                          homes: torch.Tensor, w: int,
                          chunk: int = 1 << 18
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: a chunked [n, w] gather, compare
    and min. A window that runs off the plane (home < 0 or home + w >
    len(fp)) is unresolved (off 0, state 0). Returns (off u8, state u8) in
    the queries' order on fp's device."""
    n = homes.numel()
    dev = fp.device
    off = torch.zeros(n, dtype=torch.uint8, device=dev)
    state = torch.zeros(n, dtype=torch.uint8, device=dev)
    plane = fp.view(torch.int16)
    rel = torch.arange(w, dtype=torch.int64, device=dev)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        h = homes[s:e].to(torch.int64)
        valid = (h >= 0) & (h + w <= fp.numel())
        idx = (torch.where(valid, h, 0)[:, None] + rel).clamp_(
            max=max(fp.numel() - 1, 0))
        win = plane[idx].to(torch.int32) & 0xFFFF
        fc = torch.where(win == _widen(q_fp[s:e])[:, None], rel, w).min(
            dim=1).values
        fe = torch.where(win == FP_EMPTY, rel, w).min(dim=1).values
        cand_any = valid & (fc < w)
        empty_any = valid & (fe < w)
        has_cand = cand_any & (~empty_any | (fc < fe))
        off[s:e] = torch.where(cand_any, fc, 0).to(torch.uint8)
        state[s:e] = has_cand.to(torch.uint8) + 2 * empty_any.to(torch.uint8)
    return off, state


def _check(fp, q_fp, homes, w) -> None:
    if not isinstance(w, int) or not 1 <= w <= HALO:
        raise KernelError(f"window {w!r} outside [1, {HALO}]")
    for name, t, dt in (("fp", fp, torch.uint16), ("q_fp", q_fp, torch.uint16),
                        ("homes", homes, torch.int32)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise KernelError(f"{name} must be a contiguous 1-D {dt} tensor, "
                              f"got {t.dtype} {tuple(t.shape)}")
        if t.device != fp.device:
            raise KernelError(f"{name} is on {t.device}, fp on {fp.device}")
    if q_fp.numel() != homes.numel():
        raise KernelError(f"{q_fp.numel()} fingerprints for "
                          f"{homes.numel()} homes")
    if -(-homes.numel() // 256) >= 1 << 31:  # grid.x of 256-thread blocks
        raise KernelError("too many queries for one launch's grid")


def block_probe(fp: torch.Tensor, q_fp: torch.Tensor, homes: torch.Tensor,
                w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window probe with the block probe's encoding: (off u8, state u8) in
    the queries' order, on the inputs' device. CPU tensors run the plain
    twin; CUDA tensors launch the kernel on the current stream (or raise
    KernelError). fp: u16 plane; q_fp: u16 [n] and homes: int32 [n], in
    any order."""
    global launches
    _check(fp, q_fp, homes, w)
    if fp.device.type == "cpu":
        return block_probe_reference(fp, q_fp, homes, w)
    if fp.device.type != "cuda":
        raise KernelError(f"no block-probe kernel for device {fp.device}")
    n = homes.numel()
    off = torch.empty(n, dtype=torch.uint8, device=fp.device)
    state = torch.empty(n, dtype=torch.uint8, device=fp.device)
    if n == 0:
        return off, state
    lib = load_kernel()
    stream = torch.cuda.current_stream(fp.device).cuda_stream
    rc = lib.block_probe(fp.data_ptr(), fp.numel(), q_fp.data_ptr(),
                         homes.data_ptr(), n, w, off.data_ptr(),
                         state.data_ptr(), stream)
    if rc != 0:
        raise KernelError(f"block-probe kernel launch failed: CUDA error {rc}")
    with _lock:
        launches += 1
    return off, state


class BlockProbeLookup:
    """Window-probe lookup with the block probe's encoding: one launch for
    the whole query set against the device-resident fingerprint plane. Same exact-result contract as the
    other lookups (differentially tested against ``PallasLookup`` and
    ``lookup/parity.py``).

    All device work is issued on one CUDA stream the lookup owns; a torch
    RuntimeError from upload, launch or read-back becomes a
    KernelError.
    """

    def __init__(self, table: KmerTable, probe_window: Optional[int] = None,
                 chunk: Optional[int] = None, device: str = "cuda"):
        _check_int32_homes(table.num_sigs)
        if table.max_probe is None:
            table.compute_max_probe()
        self.table = table
        self.num_sigs = s = table.num_sigs
        self.w = min(max(8, _round_up_pow2(table.max_probe)), HALO)
        if table.max_probe > HALO:
            raise ValueError("max_probe exceeds kernel halo; rebuild table at "
                             "lower load factor or use the xla backend")
        # the exact backend for fingerprint collisions and windows with
        # neither a candidate nor an empty slot
        self._exact = SparseLookup(table, probe_window=probe_window,
                                   chunk=chunk, device=device)
        self.device = self._exact.device
        fp = fingerprint_plane(table, s + HALO)
        self._stream = owned_stream(self.device)
        with on_stream(self._stream), _device_fault("upload", "block probe"):
            self.fp = torch.from_numpy(fp).to(self.device)

    def _probe(self, q_fp: np.ndarray, homes: np.ndarray):
        """Upload the queries, run one launch and read the answer back in
        the queries' order: (off, state) numpy u8 arrays."""
        with on_stream(self._stream), _device_fault("pass", "block probe"):
            q = torch.from_numpy(q_fp).to(self.device)
            h = torch.from_numpy(homes).to(self.device)
            off, state = block_probe(self.fp, q, h, self.w)
            return off.cpu().numpy(), state.cpu().numpy()

    def lookup(self, values: np.ndarray, cnt_id, pos: np.ndarray,
               progress=None, compute_kmers_found: bool = True
               ) -> LookupHits:
        """Hits in the queries' input order: one launch, host
        verification, then the exact backend for the unresolved rest, whose
        metadata overwrites that of its hits."""
        values = np.ascontiguousarray(values, dtype=np.int64)
        n = len(values)
        if n == 0:
            z = np.zeros(0)
            return LookupHits.from_lists(z, z, z, z, z, z, 0)
        s = self.num_sigs
        homes = values % np.int64(s)
        off, state = self._probe((values % FP_MOD).astype(np.uint16),
                                 homes.astype(np.int32))
        off = off.astype(np.int64)
        has_cand = (state & 1) != 0
        empty_any = (state & 2) != 0
        # host-side verification of fingerprint candidates
        cand_slot = np.minimum(homes + off, s - 1)
        found = has_cand & (self._exact.host_kmer[cand_slot] == values)
        todo = np.nonzero((has_cand & ~found) | (~has_cand & ~empty_any))[0]
        hit_idx = np.zeros(0, dtype=np.int64)
        sub = None
        if len(todo):
            sub = self._exact.lookup(values[todo], np.arange(len(todo)),
                                     np.zeros(len(todo)),
                                     compute_kmers_found=False)
            hit_idx = todo[sub.cnt_id]
            found[hit_idx] = True

        mask = found
        slots = np.minimum(homes[mask] + off[mask], s - 1)
        t_otu, t_avg, t_fi, t_wt = self._exact._table_cols()
        otu, avg, fi, wt = t_otu[slots], t_avg[slots], t_fi[slots], t_wt[slots]
        if len(hit_idx):
            # the exact backend's hits: their off is not the hit's offset
            at = (np.cumsum(mask) - 1)[hit_idx]
            otu[at], avg[at], fi[at], wt[at] = (sub.otu, sub.avg_from_end,
                                                sub.fi, sub.wt)
        if progress is not None:
            progress.update(n, int(mask.sum()))
        cnt = np.broadcast_to(np.asarray(cnt_id, dtype=np.int64), (n,))
        return LookupHits(
            cnt_id=cnt[mask].copy(),
            pos=np.asarray(pos)[mask].astype(np.int64),
            otu=otu, avg_from_end=avg, fi=fi, wt=wt,
            kmers_found=(int(np.unique(values[mask]).size)
                         if compute_kmers_found else -1))
