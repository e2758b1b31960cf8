"""Block-streamed merge-join probe (the port of the TPU block probe behind
the ``pallas`` backend): the hand-written CUDA kernel's wrapper, its plain
PyTorch twin, and ``BlockProbeLookup`` around them.

Replaces the Pallas TPU kernel ``_probe_block_kernel`` of
``kmergutsjava_tpu/lookup/pallas_kernel.py`` (launched there by
``probe_blocks``); ``BlockProbeLookup`` is the counterpart of its
``PallasLookup``. The regime is the reference's sequential table scan:
queries sorted by home slot are merged into one pass over the fingerprint
plane, cut into blocks of 2048 slots. For each query the kernel reports, in
its ``w``-slot window, the first fingerprint candidate and whether an empty
slot comes first or anywhere (see ``csrc/block_probe.cu`` for the exact
encoding, which is not the tile-join kernel's). Candidates are verified on
the host against the full k-mer values; fingerprint collisions that fail
verification and windows with neither a candidate nor an empty slot take
the exact backend, the sparse lookup (``lookup/sparse.py``) on the same
device.

Layout: a flat plane u16 ``[nblocks * 2048 + 128]`` (slots past the table
hold FP_EMPTY, so a window never wraps) and queries sorted by home with a
start offset for each block (CSR). The TPU layout's overlapped
``[nblocks, 1, 2176]`` rows and its 2176-query tiles exist for Mosaic's
BlockSpec and equal-shape gather; nothing here has a capacity, so nothing
overflows to the exact backend. The sort runs on the device, and the kernel
writes each answer at its query's input position.

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
                     _device_fault, _round_up_pow2, on_stream, owned_stream)
from .tilejoin import KernelError, _widen, build_cuda_library

BLOCK = 2048  # plane slots a kernel block stages
HALO = 128    # slots past a block's end: the largest window

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
        fn.argtypes = [p, i64, p, p, p, i64, p, i64, ctypes.c_int32, p, p, p]
        _lib = lib
        return lib


def block_starts(h_sorted: torch.Tensor, nblocks: int) -> torch.Tensor:
    """CSR over home-sorted int32 homes: int64 ``[nblocks + 1]``, the queries
    of block b are ``[starts[b], starts[b + 1])``."""
    bounds = (torch.arange(nblocks + 1, dtype=torch.int64,
                           device=h_sorted.device) * BLOCK).clamp_(
        max=(1 << 31) - 1).to(torch.int32)
    return torch.searchsorted(h_sorted, bounds)


def sorted_args(q_fp: torch.Tensor, homes: torch.Tensor, nblocks: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """The kernel's query arguments from u16 fingerprints and int32 homes in
    input order, on their device: (q_sorted, h_sorted, starts, order), the
    queries stably sorted by home, the CSR of ``block_starts`` and each
    sorted query's input position."""
    h_sorted, order = torch.sort(homes, stable=True)
    q_sorted = q_fp.view(torch.int16)[order].view(torch.uint16)
    return q_sorted, h_sorted, block_starts(h_sorted, nblocks), order


def block_probe_reference(fp: torch.Tensor, q_fp: torch.Tensor,
                          homes: torch.Tensor, starts: torch.Tensor,
                          order: torch.Tensor, w: int,
                          chunk: int = 1 << 18
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: a chunked [n, w] gather, compare
    and min. Sorted query i belongs to the block b with starts[b] <= i <
    starts[b + 1]; its answer goes to position order[i]. A query whose home
    lies outside its block's 2048 slots is unresolved (state 0); positions
    no query writes stay 0. Returns (off u8, state u8) on fp's device."""
    n = homes.numel()
    nblocks = starts.numel() - 1
    dev = fp.device
    off = torch.zeros(n, dtype=torch.uint8, device=dev)
    state = torch.zeros(n, dtype=torch.uint8, device=dev)
    if n == 0 or nblocks <= 0:
        return off, state
    plane = fp.view(torch.int16)
    rel = torch.arange(w, dtype=torch.int64, device=dev)
    inner = starts[1:].contiguous()
    lo = max(int(starts[0]), 0)
    hi = min(int(starts[-1]), n)
    for s in range(lo, hi, chunk):
        e = min(s + chunk, hi)
        p = torch.arange(s, e, dtype=torch.int64, device=dev)
        blk = torch.searchsorted(inner, p, right=True).clamp_(max=nblocks - 1)
        h = homes[s:e].to(torch.int64)
        local = h - blk * BLOCK
        valid = (local >= 0) & (local < BLOCK)
        idx = torch.where(valid, h, 0)[:, None] + rel
        win = plane[idx].to(torch.int32) & 0xFFFF
        fc = torch.where(win == _widen(q_fp[s:e])[:, None], rel, w).min(
            dim=1).values
        fe = torch.where(win == FP_EMPTY, rel, w).min(dim=1).values
        cand_any = fc < w
        empty_any = fe < w
        has_cand = cand_any & (~empty_any | (fc < fe))
        o = torch.where(valid & cand_any, fc, 0).to(torch.uint8)
        st = torch.where(valid, has_cand.to(torch.uint8)
                         + 2 * empty_any.to(torch.uint8), 0).to(torch.uint8)
        at = order[s:e]
        ok = (at >= 0) & (at < n)
        off[at[ok]] = o[ok]
        state[at[ok]] = st[ok]
    return off, state


def _check(fp, q_fp, homes, starts, order, w) -> None:
    if not isinstance(w, int) or not 1 <= w <= HALO:
        raise KernelError(f"window {w!r} outside [1, {HALO}]")
    for name, t, dt in (("fp", fp, torch.uint16), ("q_fp", q_fp, torch.uint16),
                        ("homes", homes, torch.int32),
                        ("starts", starts, torch.int64),
                        ("order", order, torch.int64)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise KernelError(f"{name} must be a contiguous 1-D {dt} tensor, "
                              f"got {t.dtype} {tuple(t.shape)}")
        if t.device != fp.device:
            raise KernelError(f"{name} is on {t.device}, fp on {fp.device}")
    n = homes.numel()
    if q_fp.numel() != n or order.numel() != n:
        raise KernelError(f"{q_fp.numel()} fingerprints and {order.numel()} "
                          f"output positions for {n} homes")
    nblocks = starts.numel() - 1
    if nblocks < 0 or nblocks >= 1 << 31:
        raise KernelError(f"{starts.numel()} block starts")
    if fp.numel() < nblocks * BLOCK + HALO:
        raise KernelError(f"plane of {fp.numel()} slots is shorter than "
                          f"{nblocks} blocks of {BLOCK} + {HALO}")


def block_probe(fp: torch.Tensor, q_fp: torch.Tensor, homes: torch.Tensor,
                starts: torch.Tensor, order: torch.Tensor, w: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge-join probe of home-sorted queries against the plane's blocks:
    (off u8, state u8) with sorted query i's answer at position order[i],
    on the inputs' device. CPU tensors run the plain twin; CUDA tensors
    launch the kernel on the current stream (or raise KernelError).
    fp: u16 ``[>= nblocks * 2048 + 128]``; q_fp: u16 [n] and homes: int32
    [n] in home order; starts: int64 ``[nblocks + 1]``, nondecreasing;
    order: int64 [n], a permutation (``sorted_args`` forms the four)."""
    global launches
    _check(fp, q_fp, homes, starts, order, w)
    if fp.device.type == "cpu":
        return block_probe_reference(fp, q_fp, homes, starts, order, w)
    if fp.device.type != "cuda":
        raise KernelError(f"no block-probe kernel for device {fp.device}")
    n = homes.numel()
    nblocks = starts.numel() - 1
    off = torch.zeros(n, dtype=torch.uint8, device=fp.device)
    state = torch.zeros(n, dtype=torch.uint8, device=fp.device)
    if n == 0 or nblocks == 0:
        return off, state
    lib = load_kernel()
    stream = torch.cuda.current_stream(fp.device).cuda_stream
    rc = lib.block_probe(fp.data_ptr(), fp.numel(), q_fp.data_ptr(),
                         homes.data_ptr(), starts.data_ptr(), nblocks,
                         order.data_ptr(), n, w, off.data_ptr(),
                         state.data_ptr(), stream)
    if rc != 0:
        raise KernelError(f"block-probe kernel launch failed: CUDA error {rc}")
    with _lock:
        launches += 1
    return off, state


class BlockProbeLookup:
    """Merge-join lookup: the home-sorted query stream against one pass over
    the device-resident fingerprint plane. Same exact-result contract as the
    other lookups (differentially tested against ``PallasLookup`` and
    ``lookup/parity.py``).

    All device work is issued on one CUDA stream the lookup owns; a torch
    RuntimeError from upload, sort, launch or read-back becomes a
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
        self.nblocks = -(-s // BLOCK)
        fp = np.full(self.nblocks * BLOCK + HALO, FP_EMPTY, dtype=np.uint16)
        occ = table.occupied
        fp[:s][occ] = (table.slots["kmer"][occ] % FP_MOD).astype(np.uint16)
        self._stream = owned_stream(self.device)
        with on_stream(self._stream), _device_fault("upload", "block probe"):
            self.fp = torch.from_numpy(fp).to(self.device)

    def _probe(self, q_fp: np.ndarray, homes: np.ndarray):
        """Upload the queries, sort them by home on the device, run one
        plane pass and read the answer back in the queries' order: (off,
        state) numpy u8 arrays."""
        with on_stream(self._stream), _device_fault("pass", "block probe"):
            q = torch.from_numpy(q_fp).to(self.device)
            h = torch.from_numpy(homes).to(self.device)
            off, state = block_probe(self.fp,
                                     *sorted_args(q, h, self.nblocks), self.w)
            return off.cpu().numpy(), state.cpu().numpy()

    def lookup(self, values: np.ndarray, cnt_id, pos: np.ndarray,
               progress=None, compute_kmers_found: bool = True
               ) -> LookupHits:
        """Hits in the queries' input order: one plane pass, host
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
