"""Shard probe (B12): the hand-written CUDA kernel of one table shard's
probe, its plain PyTorch twin, and the wrapper that picks between them by
the tensors' device.

Replaces the device program that the JAX package writes in XLA for the
TPU, ``parallel/sharded_lookup.py`` ``_local_probe``: a table shard owns
the slots ``[lo, lo + s_loc)`` and holds them with a halo of ``w`` slots
(``plane``, u16 ``[s_loc + w]``, global slots ``[lo, lo + s_loc + w)``).
For each query whose home it owns, the answer is the global slot + 1 of
the first slot of the ``w``-slot window from the home that holds the
query's u16 fingerprint, empty slots or not; 0 for a query it does not own
or with no match. Summed over the table axis (``mesh.psum``) every query
has its owner's answer, which the host verifies
(``sharded_lookup.verify_candidates``). This is not the sparse probe's
(B1, ``lookup/tilejoin.py``) first-event contract, which stops at an empty
slot: the two answer differently where an empty slot comes first.

The kernel (``csrc/shard_probe.cu``) is compiled with nvcc for sm_90a into a
plain-C shared library on first use and loaded with ctypes; nothing is
built or imported for CUDA when this module is imported.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from ..lookup.tilejoin import KernelError, _widen, build_cuda_library

MAX_WINDOW = 128  # the sharded lookup's largest window

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "shard_probe.cu")

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
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.shard_probe.restype = ctypes.c_int
        lib.shard_probe.argtypes = [p, i64, p, p, i64, i64, i64,
                                    ctypes.c_int32, p, p]
        _lib = lib
        return lib


def shard_probe_reference(plane: torch.Tensor, q_fp: torch.Tensor,
                          homes: torch.Tensor, lo: int, s_loc: int, w: int,
                          chunk: int = 1 << 18) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (the JAX program's arithmetic): a
    chunked [n, w] gather from each owned home, compare, and the least
    matching offset. Returns int32 [n] on plane's device."""
    n = homes.numel()
    out = torch.empty(n, dtype=torch.int32, device=plane.device)
    slots = _widen(plane)
    rel = torch.arange(w, dtype=torch.int64, device=plane.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        local = homes[s:e].to(torch.int64) - lo
        mine = (local >= 0) & (local < s_loc)
        base = torch.where(mine, local, 0)
        match = slots[base[:, None] + rel] == _widen(q_fp[s:e])[:, None]
        off = torch.where(match, rel, w).min(dim=1).values
        found = (off < w) & mine
        out[s:e] = torch.where(found, lo + base + off + 1, 0).to(torch.int32)
    return out


def check_shard(plane, lo, s_loc, w) -> None:
    """The shard's window, slot range and plane slice, as the kernels take
    them (this one and the fused step's shard entry)."""
    if not isinstance(w, int) or not 1 <= w <= MAX_WINDOW:
        raise KernelError(f"window {w!r} outside [1, {MAX_WINDOW}]")
    if lo < 0 or s_loc < 0 or plane.numel() < s_loc + w:
        raise KernelError(f"a plane slice of {plane.numel()} slots cannot "
                          f"hold {s_loc} owned slots from {lo} and a halo "
                          f"of {w}")
    if lo + s_loc + w >= 1 << 31:  # the answer rides as int32
        raise KernelError(f"slots past {lo + s_loc + w} do not fit int32")


def _check(plane, q_fp, homes, lo, s_loc, w) -> None:
    check_shard(plane, lo, s_loc, w)
    for name, t, dt in (("plane", plane, torch.uint16),
                        ("q_fp", q_fp, torch.uint16),
                        ("homes", homes, torch.int32)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise KernelError(f"{name} must be a contiguous 1-D {dt} tensor, "
                              f"got {t.dtype} {tuple(t.shape)}")
        if t.device != plane.device:
            raise KernelError(f"{name} is on {t.device}, plane on "
                              f"{plane.device}")
    if q_fp.numel() != homes.numel():
        raise KernelError(f"{q_fp.numel()} fingerprints for "
                          f"{homes.numel()} homes")


def shard_probe(plane: torch.Tensor, q_fp: torch.Tensor, homes: torch.Tensor,
                lo: int, s_loc: int, w: int) -> torch.Tensor:
    """The shard's answer to each query: int32 [n] on the inputs' device
    (global slot + 1 of its first fingerprint match, or 0). CPU tensors run
    the plain twin; CUDA tensors launch the kernel on the current stream
    (or raise KernelError)."""
    global launches
    _check(plane, q_fp, homes, lo, s_loc, w)
    dev = plane.device
    if dev.type == "cpu":
        return shard_probe_reference(plane, q_fp, homes, lo, s_loc, w)
    if dev.type != "cuda":
        raise KernelError(f"no shard probe kernel for device {dev}")
    n = homes.numel()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = load_kernel()
    rc = lib.shard_probe(plane.data_ptr(), plane.numel(), q_fp.data_ptr(),
                         homes.data_ptr(), n, lo, s_loc, w, out.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"shard probe kernel launch failed: CUDA error "
                          f"{rc}")
    with _lock:
        launches += 1
    return out
