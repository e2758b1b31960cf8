"""Lane-gather tile-join probe (the port of the TPU sweep's ``tjgather``
experiment): the hand-written CUDA kernel's wrapper and its plain PyTorch
twin.

Replaces the Pallas TPU kernel ``kernel`` of ``scripts/sweep.py``
``section_tjgather.make_probe``: queries packed into cells
(``qfp << 14 | row << 7 | off``) are probed against transposed 128x128
plane tiles grouped ``TPG`` to a super-tile, and each cell gets its
unpacked first-event key in a ``W``-slot window (``2 * rel`` for a
fingerprint candidate, ``2 * rel + 1`` for an empty slot, ``2 * W`` for
neither; see ``csrc/tjgather.cu``, which fixes the same two constants). It is a timing experiment, driven by
``kmergutsjava_tpu_torch/scripts/sweep.py``; no lookup runs it.

The kernel is compiled with nvcc for sm_90a into a plain-C shared library
on first use and loaded with ctypes; nothing is built or imported for CUDA
when this module is imported.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from .tilejoin import FP_EMPTY, KernelError, build_cuda_library

TILE = 128        # rows (and window offsets) of a plane tile
TPG = 8           # tiles a super-tile (the TPU tile join's default)
W = 16            # the sweep's probe window

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "tjgather.cu")

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
        fn = lib.tjgather_probe
        fn.restype = ctypes.c_int
        p = ctypes.c_void_p
        i32 = ctypes.c_int32
        fn.argtypes = [p, ctypes.c_int64, p, ctypes.c_int64, p, i32, p, p]
        _lib = lib
        return lib


def tjgather_reference(plane3: torch.Tensor, ids: torch.Tensor,
                       packed: torch.Tensor, chunk: int = 1 << 18
                       ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: per chunk of cells, a ``[n, W]``
    gather of the cells' tile columns, compare and min over the key. A
    super-tile whose id names no tile gives ``2 * W``. Returns int32 of
    ``packed``'s shape on its device."""
    dev = packed.device
    tiles = plane3.shape[0]
    flat = packed.reshape(-1)
    key = torch.empty(flat.numel(), dtype=torch.int32, device=dev)
    per_sup = flat.numel() // max(ids.numel(), 1)
    per_tile = per_sup // TPG
    plane = plane3.reshape(-1).view(torch.int16)
    rel = torch.arange(W, dtype=torch.int64, device=dev)
    big2 = 2 * W
    for s in range(0, flat.numel(), chunk):
        e = min(s + chunk, flat.numel())
        i = torch.arange(s, e, dtype=torch.int64, device=dev)
        tile = ids.to(torch.int64)[i // per_sup] * TPG + (i // per_tile) % TPG
        valid = (tile >= 0) & (tile < tiles)
        p = flat[s:e]
        rr = ((p >> 7) & 127).to(torch.int64)
        o = (p & 127).to(torch.int64)[:, None] + rel  # [n, W] tile offsets
        in_w = o < TILE
        idx = ((torch.where(valid, tile, 0)[:, None] * TILE
                + o.clamp(max=TILE - 1)) * TILE + rr[:, None])
        v = plane[idx].to(torch.int32) & 0xFFFF
        k = torch.where(in_w & (v == (p >> 14)[:, None]), rel * 2,
                        torch.where(in_w & (v == FP_EMPTY), rel * 2 + 1,
                                    big2))
        key[s:e] = torch.where(valid, k.min(dim=1).values, big2).to(
            torch.int32)
    return key.view(packed.shape)


def _check(plane3, ids, packed) -> None:
    for name, t, dt, dims in (("plane3", plane3, torch.uint16, 3),
                              ("ids", ids, torch.int32, 1),
                              ("packed", packed, torch.int32, 4)):
        if t.dtype != dt or t.dim() != dims or not t.is_contiguous():
            raise KernelError(f"{name} must be a contiguous {dims}-D {dt} "
                              f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != packed.device:
            raise KernelError(f"{name} is on {t.device}, packed on "
                              f"{packed.device}")
    if tuple(plane3.shape[1:]) != (TILE, TILE):
        raise KernelError(f"plane tiles of shape {tuple(plane3.shape[1:])}, "
                          f"not ({TILE}, {TILE})")
    if packed.shape[0] != ids.numel() or packed.shape[1] != TPG \
            or packed.shape[3] != TILE:
        raise KernelError(f"packed {tuple(packed.shape)} is not "
                          f"[{ids.numel()}, {TPG}, cap/128, {TILE}]")
    if -(-packed.numel() // 256) >= 1 << 31:  # grid.x of 256-thread blocks
        raise KernelError("too many cells for one launch's grid")


def tjgather_probe(plane3: torch.Tensor, ids: torch.Tensor,
                   packed: torch.Tensor) -> torch.Tensor:
    """First-event key of every packed cell against its super-tile's
    transposed plane tiles: int32 of ``packed``'s shape, on the inputs'
    device. CPU tensors run the plain twin; CUDA tensors launch the kernel
    on the current stream (or raise KernelError). plane3: u16 ``[tiles,
    128, 128]`` ([tile, off, row]); ids: int32 ``[nsup]``; packed: int32
    ``[nsup, TPG, cap/128, 128]``."""
    global launches
    _check(plane3, ids, packed)
    if packed.device.type == "cpu":
        return tjgather_reference(plane3, ids, packed)
    if packed.device.type != "cuda":
        raise KernelError(f"no lane-gather kernel for device {packed.device}")
    key = torch.empty_like(packed)
    if packed.numel() == 0:
        return key
    lib = load_kernel()
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    rc = lib.tjgather_probe(plane3.data_ptr(), plane3.shape[0],
                            ids.data_ptr(), ids.numel(), packed.data_ptr(),
                            packed.shape[2], key.data_ptr(), stream)
    if rc != 0:
        raise KernelError(f"lane-gather kernel launch failed: CUDA error {rc}")
    with _lock:
        launches += 1
    return key
