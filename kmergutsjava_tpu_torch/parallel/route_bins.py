"""Routing bins (B13): the hand-written CUDA kernels that bin a source
shard's queries by their owner shard and gather the answers back, their
plain PyTorch twins, and the wrappers that pick between them by the
tensors' device.

Replaces the binning and un-binning of the JAX package's device program
``parallel/routed_lookup.py`` ``_routed_step`` (its lines 57-81 and
119-133). On a source shard with ``n`` queries, of which the first
``n_valid`` are real: each real query's owner is ``clip(home // s_loc, 0,
T - 1)``, a padded one's is ``T``; its rank is its place among its owner's
queries in a STABLE sort by owner; ``bins(...)`` lays the queries out in
``[T, cap]`` bins of fingerprints (``FP_EMPTY`` in a cell no query takes)
and homes (0 there), and each query's ``cell`` (``owner * cap + rank``, or
-1 for an overflow: a rank of ``cap`` or more, or a padded query). Row t of
the bins goes to shard t; the owner's answers come back in the same cells
as a back buffer ``[T, 2, cap]`` (a row of offsets and a row of states for
each owner, so one exchange carries both), and ``unbin(...)`` writes each
query's answer in the host's layout: one u8 buffer ``[3, ld]`` (``ld`` =
``row_stride(n)``) of offsets, states and overflow flags (1 where the cell
is -1, whose offset and state are 0), which the host reads back in one
copy. Cell for cell, the bins equal ``_routed_step``'s.

The kernels (``csrc/route_bins.cu``) are compiled with nvcc for sm_90a into
a plain-C shared library on first use and loaded with ctypes; nothing is
built or imported for CUDA when this module is imported.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from ..lookup.tilejoin import FP_EMPTY, KernelError, build_cuda_library

MAX_SHARDS = 256  # the kernel's shared-memory table of owners
TILE = 1024       # queries a tile of the kernel (kTile in the source)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "route_bins.cu")

# launches of the binning entry and of the un-binning entry since import
# (or since a caller reset them to 0); counted only where a wrapper
# launches the CUDA kernels, never for the twins
launches = 0
unbin_launches = 0

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
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.route_bins.restype = ctypes.c_int
        lib.route_bins.argtypes = [p, p, i64, i64, i64, ctypes.c_int32, i64,
                                   p, p, p, p, p, p]
        lib.route_unbin.restype = ctypes.c_int
        lib.route_unbin.argtypes = [p, i64, p, i64, p, p]
        _lib = lib
        return lib


def counts_size(n: int, n_shards: int) -> int:
    """Entries of the binning's count scratch: each tile's count of every
    owner (T + 1 owners, ceil(n / TILE) tiles), then each owner's total."""
    return (-(-n // TILE) + 1) * (n_shards + 1)


def bins_reference(q_fp: torch.Tensor, homes: torch.Tensor, n_valid: int,
                   s_loc: int, n_shards: int, cap: int):
    """Plain PyTorch twin of the binning: a stable argsort by owner, each
    query's rank in its run, and a scatter. Returns (bin_qfp u16 [T, cap],
    bin_home int32 [T, cap], cell int32 [n])."""
    n = homes.numel()
    dev = homes.device
    owner = torch.div(homes.to(torch.int64), s_loc,
                      rounding_mode="floor").clamp_(0, n_shards - 1)
    owner[n_valid:] = n_shards  # padded queries park on owner T
    order = torch.argsort(owner, stable=True)
    by_owner = owner[order]
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = (torch.arange(n, device=dev)
                   - torch.searchsorted(by_owner, by_owner, side="left"))
    over = (rank >= cap) | (owner >= n_shards)
    cell = torch.where(over, -1, owner * cap + rank)
    bin_qfp = torch.full((n_shards * cap,), FP_EMPTY - 65536,
                         dtype=torch.int16, device=dev)
    bin_home = torch.zeros(n_shards * cap, dtype=torch.int32, device=dev)
    ok = ~over
    bin_qfp[cell[ok]] = q_fp.view(torch.int16)[ok]
    bin_home[cell[ok]] = homes[ok]
    return (bin_qfp.view(torch.uint16).view(n_shards, cap),
            bin_home.view(n_shards, cap), cell.to(torch.int32))


def row_stride(n: int) -> int:
    """The row stride of the un-binning's output for ``n`` queries: ``n``
    rounded up to 16, so that every row starts at a 16-byte boundary and
    the kernel's 2-byte stores are aligned in every row."""
    return -(-n // 16) * 16


def unbin_reference(cell: torch.Tensor, back: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the un-binning: u8 [3, row_stride(n)] of each
    query's offset, state and overflow flag, 0 past n."""
    n = cell.numel()
    cap = back.shape[2]
    out = torch.zeros((3, row_stride(n)), dtype=torch.uint8,
                      device=cell.device)
    ok = cell >= 0
    c = torch.where(ok, cell, 0).to(torch.int64)
    at = c + torch.div(c, cap, rounding_mode="floor") * cap
    flat = back.reshape(-1)
    zero = torch.zeros((), dtype=torch.uint8, device=cell.device)
    out[0, :n] = torch.where(ok, flat[at], zero)
    out[1, :n] = torch.where(ok, flat[at + cap], zero)
    out[2, :n] = (~ok).to(torch.uint8)
    return out


def _check_1d(name, t, dt, device) -> None:
    if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
        raise KernelError(f"{name} must be a contiguous 1-D {dt} tensor, "
                          f"got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise KernelError(f"{name} is on {t.device}, not {device}")


def bins(q_fp: torch.Tensor, homes: torch.Tensor, n_valid: int, s_loc: int,
         n_shards: int, cap: int):
    """(bin_qfp u16 [T, cap], bin_home int32 [T, cap], cell int32 [n]) of
    one source shard's queries, on their device. CPU tensors run the plain
    twin; CUDA tensors launch the kernels on the current stream (or raise
    KernelError)."""
    global launches
    dev = homes.device
    _check_1d("homes", homes, torch.int32, dev)
    _check_1d("q_fp", q_fp, torch.uint16, dev)
    n = homes.numel()
    if q_fp.numel() != n:
        raise KernelError(f"{q_fp.numel()} fingerprints for {n} homes")
    if not 1 <= n_shards <= MAX_SHARDS or s_loc < 1 or cap < 1 \
            or n_shards * cap >= 1 << 31 or n >= 1 << 31:
        raise KernelError(f"no bins for {n} queries over {n_shards} shards "
                          f"of {s_loc} slots at cap {cap}")
    n_valid = min(max(n_valid, 0), n)
    if dev.type == "cpu":
        return bins_reference(q_fp, homes, n_valid, s_loc, n_shards, cap)
    if dev.type != "cuda":
        raise KernelError(f"no routing kernel for device {dev}")
    bin_qfp = torch.empty((n_shards, cap), dtype=torch.uint16, device=dev)
    bin_home = torch.empty((n_shards, cap), dtype=torch.int32, device=dev)
    cell = torch.empty(n, dtype=torch.int32, device=dev)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(counts_size(n, n_shards), dtype=torch.int32,
                         device=dev)
    lib = load_kernel()
    rc = lib.route_bins(q_fp.data_ptr(), homes.data_ptr(), n, n_valid,
                        s_loc, n_shards, cap,
                        bin_qfp.data_ptr(), bin_home.data_ptr(),
                        cell.data_ptr(), rank.data_ptr(), counts.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"routing bins kernel launch failed: CUDA error "
                          f"{rc}")
    with _lock:
        launches += 1
    return bin_qfp, bin_home, cell


def unbin(cell: torch.Tensor, back: torch.Tensor) -> torch.Tensor:
    """Each query's answer from its cell of ``back`` (u8 [T, 2, cap]: each
    owner's offsets, then its states), in the host's layout: u8 [3,
    row_stride(n)] of offsets, states and overflow flags (an overflow's
    offset and state are 0; columns past n are 0). CPU tensors run the
    plain twin; CUDA tensors launch the kernel (or raise KernelError)."""
    global unbin_launches
    dev = cell.device
    _check_1d("cell", cell, torch.int32, dev)
    if back.dtype != torch.uint8 or back.dim() != 3 or back.shape[1] != 2 \
            or not back.is_contiguous() or back.device != dev:
        raise KernelError(f"back must be a contiguous uint8 tensor [T, 2, "
                          f"cap] on {dev}, got {back.dtype} "
                          f"{tuple(back.shape)} on {back.device}")
    n, cap = cell.numel(), back.shape[2]
    if n >= 1 << 31 or not 1 <= cap < 1 << 31:
        raise KernelError(f"no un-binning of {n} queries at cap {cap}")
    if dev.type == "cpu":
        return unbin_reference(cell, back)
    if dev.type != "cuda":
        raise KernelError(f"no routing kernel for device {dev}")
    if cell.data_ptr() % 8:
        raise KernelError("cell must start at an 8-byte boundary")
    out = torch.empty((3, row_stride(n)), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    lib = load_kernel()
    rc = lib.route_unbin(cell.data_ptr(), n, back.data_ptr(), cap,
                         out.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"routing unbin kernel launch failed: CUDA error "
                          f"{rc}")
    with _lock:
        unbin_launches += 1
    return out
