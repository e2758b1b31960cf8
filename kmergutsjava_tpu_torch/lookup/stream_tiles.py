"""The stream lookup's per-query stages in device memory: the scatter of a
chunk's query values into a pass's tiles, and the resolve of every query
after the plane pass. Each is a hand-written CUDA kernel
(``csrc/stream_tiles.cu``) with its plain PyTorch twin here; CPU tensors
run the twin, CUDA tensors launch the kernel on the current stream or
raise KernelError.

Both work on the tensors of one pass (``lookup/stream.py`` ``PassSet``):
tiles u16 ``[C, S]`` and occupancy u8 ``[S]`` (zero before a pass's first
chunk), the probe's answers int32 ``[C/4, S]``, and a query's int32 result,
which the scatter sets to its channel (-1: its home's C channels were
taken by other values) and the resolve to its table slot (-1: a miss).

The twin's channel split is another valid one than the kernel's (a home's
new distinct fingerprints take channels in fingerprint order; the kernel's
threads race for them): any split is exact as long as every placed query's
cell holds its fingerprint.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from .sparse import FP_MOD
from .tilejoin import KernelError, build_cuda_library

MAX_CHANNELS = 64  # the occupancy byte's count bits, with room to spare

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "stream_tiles.cu")

# kernel launches since import (or since a caller reset them to 0); counted
# only where a wrapper launches the CUDA kernel, never for the twins
scatter_launches = 0
resolve_launches = 0

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
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        fn = lib.stream_scatter
        fn.restype = ctypes.c_int
        fn.argtypes = [p, i64, i64, i64, i32, p, p, p, p]
        fn = lib.stream_resolve
        fn.restype = ctypes.c_int
        fn.argtypes = [p, i64, i64, i64, p, p, p, i64, i32, i32, p, p, p]
        _lib = lib
        return lib


def _as_i16(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 65535] as the int16 that shares their u16 bits."""
    return torch.where(x >= 32768, x - 65536, x).to(torch.int16)


def scatter_reference(values: torch.Tensor, tiles: torch.Tensor,
                      occ: torch.Tensor, res: torch.Tensor,
                      num_sigs: int) -> None:
    """Plain PyTorch twin of ``stream_scatter``: a query whose fingerprint
    sits in one of its home's taken channels shares that cell; a home's new
    distinct fingerprints take its next channels (in fingerprint order), up
    to C; the rest are overflow. Mutates tiles and occ; writes res."""
    channels = tiles.shape[0]
    dev = values.device
    homes = values % num_sigs
    fps = values % FP_MOD
    live = occ[homes].to(torch.int64)
    cells = tiles.view(torch.int16)[:, homes].to(torch.int64) & 0xFFFF
    taken = torch.arange(channels, device=dev)[:, None] < live[None, :]
    match = (cells == fps[None, :]) & taken
    shared = match.any(0)
    res.copy_(torch.where(shared, match.to(torch.int32).argmax(0), -1))
    rest = ~shared
    keys, inv = torch.unique(homes[rest] * FP_MOD + fps[rest],
                             return_inverse=True)
    if not len(keys):
        return
    kh, kf = keys // FP_MOD, keys % FP_MOD
    first = torch.searchsorted(kh, kh)  # keys sort by home first
    ch = occ[kh].to(torch.int64) + torch.arange(len(keys), device=dev) \
        - first
    ok = ch < channels
    tiles.view(torch.int16)[ch[ok], kh[ok]] = _as_i16(kf[ok])
    uh, per = torch.unique_consecutive(kh, return_counts=True)
    occ[uh] = torch.clamp(occ[uh].to(torch.int64) + per,
                          max=channels).to(torch.uint8)
    res[rest] = torch.where(ok, ch, -1)[inv].to(torch.int32)


def resolve_reference(values: torch.Tensor, res: torch.Tensor,
                      answers: torch.Tensor, fe: torch.Tensor,
                      hk: torch.Tensor, num_sigs: int, w: int, full_w: int,
                      counts: torch.Tensor) -> None:
    """Plain PyTorch twin of ``stream_resolve`` (and of the host decode's
    ``resolve_one``): res (channels in) becomes each query's table slot or
    -1; counts gains the overflow, fallback and hit counts."""
    slots = answers.shape[1]
    homes = values % num_sigs
    ch = res.to(torch.int64)
    placed = ch >= 0
    c = ch.clamp(min=0)
    packed = answers.reshape(-1)[(c >> 2) * slots + homes].to(torch.int64)
    off = (packed >> (8 * (c & 3))) & 0xFF
    f = fe[homes].to(torch.int64)
    cand = placed & (off < f)
    at = homes + off
    verified = cand & (at < len(hk)) & (hk[at.clamp(max=len(hk) - 1)]
                                         == values)
    fallback = ~placed | (cand & ~verified) | (placed & ~cand & (f >= w))
    slot = torch.where(verified, at, -1)
    todo = fallback.nonzero().squeeze(1)
    if len(todo):
        h, v = homes[todo], values[todo]
        found = torch.full_like(h, -1)
        for l in reversed(range(full_w)):  # overwrite: the first match
            i = h + l
            hit = (i < len(hk)) & (hk[i.clamp(max=len(hk) - 1)] == v)
            found = torch.where(hit, i, found)
        slot[todo] = found
    res.copy_(slot)
    counts += torch.stack([(~placed).sum(), fallback.sum(),
                           (slot >= 0).sum()]).to(counts.dtype)


def _launched(rc: int, what: str) -> None:
    if rc != 0:
        raise KernelError(f"stream {what} kernel launch failed: CUDA error "
                          f"{rc}")


def _check(name: str, t: torch.Tensor, dtype, device, shape=None) -> None:
    if t.dtype != dtype or not t.is_contiguous() or t.device != device \
            or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise KernelError(f"{name} must be a contiguous {dtype} tensor"
                          f"{'' if shape is None else f' of {tuple(shape)}'}"
                          f" on {device}, got {t.dtype} {tuple(t.shape)} on "
                          f"{t.device}")


def scatter_tiles(values: torch.Tensor, tiles: torch.Tensor,
                  occ: torch.Tensor, res: torch.Tensor,
                  num_sigs: int) -> None:
    """Place one chunk's queries (int64 ``[n]``) into a pass's tiles (u16
    ``[C, S]``) and occupancy (u8 ``[S]``); res (int32 ``[n]``) gets each
    query's channel, or -1 for overflow."""
    global scatter_launches
    dev = values.device
    channels, slots = tiles.shape
    if not 1 <= channels <= MAX_CHANNELS or slots % 4 \
            or not 1 <= num_sigs <= slots:
        raise KernelError(f"{channels} channels, {slots} slots and "
                          f"{num_sigs} signatures do not make a pass's tiles")
    _check("values", values, torch.int64, dev)
    _check("tiles", tiles, torch.uint16, dev)
    _check("occ", occ, torch.uint8, dev, (slots,))
    _check("res", res, torch.int32, dev, values.shape)
    if dev.type == "cpu":
        return scatter_reference(values, tiles, occ, res, num_sigs)
    if dev.type != "cuda":
        raise KernelError(f"no stream scatter kernel for device {dev}")
    if not len(values):
        return
    lib = load_kernel()
    _launched(lib.stream_scatter(
        values.data_ptr(), len(values), num_sigs, slots, channels,
        tiles.data_ptr(), occ.data_ptr(), res.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "scatter")
    with _lock:
        scatter_launches += 1


def resolve_tiles(values: torch.Tensor, res: torch.Tensor,
                  answers: torch.Tensor, fe: torch.Tensor, hk: torch.Tensor,
                  num_sigs: int, w: int, full_w: int,
                  counts: torch.Tensor) -> None:
    """Resolve one chunk's queries after the plane pass: res (each query's
    channel) becomes its table slot, or -1 for a miss; counts (int64
    ``[3]``) gains the chunk's overflow, fallback and hit counts. answers:
    the probe's int32 ``[C/4, S]``; fe: u8 ``[S + w]``; hk: the k-mer
    column int64, padded past ``num_sigs`` by ``full_w`` empty slots."""
    global resolve_launches
    dev = values.device
    slots = answers.shape[1]
    if not 1 <= num_sigs <= slots or len(hk) < num_sigs + full_w \
            or len(fe) < slots + w or w < 1 or full_w < 1:
        raise KernelError(f"answers of {slots} slots, fe of {len(fe)}, a "
                          f"column of {len(hk)} and windows {w}/{full_w} do "
                          f"not fit {num_sigs} signatures")
    _check("values", values, torch.int64, dev)
    _check("res", res, torch.int32, dev, values.shape)
    _check("answers", answers, torch.int32, dev)
    _check("fe", fe, torch.uint8, dev)
    _check("hk", hk, torch.int64, dev)
    _check("counts", counts, torch.int64, dev, (3,))
    if dev.type == "cpu":
        return resolve_reference(values, res, answers, fe, hk, num_sigs, w,
                                 full_w, counts)
    if dev.type != "cuda":
        raise KernelError(f"no stream resolve kernel for device {dev}")
    if not len(values):
        return
    lib = load_kernel()
    _launched(lib.stream_resolve(
        values.data_ptr(), len(values), num_sigs, slots, answers.data_ptr(),
        fe.data_ptr(), hk.data_ptr(), len(hk), w, full_w, res.data_ptr(),
        counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
        "resolve")
    with _lock:
        resolve_launches += 1
