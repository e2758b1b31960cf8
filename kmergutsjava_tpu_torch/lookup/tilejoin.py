"""Sparse first-event probe (the port of the TPU tile join): the
hand-written CUDA kernel, its plain PyTorch twin, and the wrapper that picks
between them by the tensors' device.

Replaces the Pallas TPU kernel ``_tilejoin_kernel`` of
``kmergutsjava_tpu/lookup/pallas_tilejoin.py`` (launched there by
``tilejoin_probe``). Both compute, for every query, the first event in the
``w``-slot window of the u16 fingerprint plane that starts at its home slot
(``lookup/xla.py`` ``_first_event``): ``(off, state)`` with state 1 = a
fingerprint candidate at ``off``, 2 = an empty slot first (a miss), 0 =
neither (the host's exact pass decides).

The kernel (``csrc/tilejoin.cu``) is bound by device-memory bytes: 6 bytes
in and 2 out per query, plus the plane sector its window starts in
(windows end early at the tables' load factors). Those sectors lie at
random in the plane, and random reads of device memory are what bound it
on the card: each thread takes four queries in the caller's order, with
no sort, and reads each window as 16-byte vectors from the one that holds
its home, comparing two slots a word. The TPU kernel's tile join (queries
sorted by home, every tile of the plane staged in fast memory) reads the
whole plane per launch and was measured slower on the H100 (see the
source note in ``csrc/tilejoin.cu``). Its layout (overlapped 128-lane rows, transposed
tiles, capped bins, byte-packed codes) is not carried: nothing here has a
bin capacity, so nothing overflows to the host pass.

A probe's answer is one u8 buffer (``probe_answer``): ``off`` at ``[0, n)``
and ``state`` from the next 16-byte boundary (``answer_views``), so the
engine reads it back in one copy.

The kernel is compiled with nvcc for sm_90a into a plain-C shared library
on first use and loaded with ctypes; nothing is built or imported for CUDA
when this module is imported.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional, Tuple

import torch

FP_EMPTY = 65535
MAX_WINDOW = 256  # window offsets travel as u8

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "tilejoin.cu")
# headers the kernel sources include: a newer one rebuilds every library
HEADERS = tuple(os.path.join(_PKG_DIR, "csrc", h) for h in (
    "probe_common.cuh", "probe_answers.cuh", "kmer_common.cuh",
    "async_copy.cuh"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# kernel launches since import (or since a caller reset it to 0); counted
# only where the wrapper launches the CUDA kernel, never for the twin
launches = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelError(RuntimeError):
    """The tile-join kernel could not be built, was handed inputs it does
    not take, or its launch or device read-back failed. Never a ValueError:
    the engine must not mistake it for a table it cannot serve."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build_cuda_library(source: str) -> ctypes.CDLL:
    """Compile ``source`` with nvcc for sm_90a into ``lib<name>.so`` in the
    host libraries' build directory (``utils/native.py`` ``BUILD_DIR``: the
    package's ``build/``, or the per-user cache where that is not writable;
    only when the source or a header in ``HEADERS`` is newer than the
    library) and load it. Raises KernelError. Callers hold their own lock
    and cache the result."""
    from ..utils.native import BUILD_DIR, compile_to, stale

    name = os.path.splitext(os.path.basename(source))[0]
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    try:
        if stale(so, (source, *HEADERS)):
            compile_to([_nvcc(), *NVCC_FLAGS, source, "-o"], so)
        return ctypes.CDLL(so)
    except OSError as ex:
        raise KernelError(f"cannot build or load {so}: {ex}") from ex
    except Exception as ex:  # CalledProcessError: show nvcc's stderr
        detail = getattr(ex, "stderr", "") or ""
        raise KernelError(f"nvcc failed on {source}: {ex}\n{detail}") \
            from ex


def load_kernel() -> ctypes.CDLL:
    """Build (once per process, and only when the source is newer than the
    library) and load the kernel library. Raises KernelError."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_cuda_library(SOURCE)
        fn = lib.tilejoin_first_event
        fn.restype = ctypes.c_int
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int64, p, p, ctypes.c_int64,
                       ctypes.c_int32, p, p, p]
        _lib = lib
        return lib


def _widen(x: torch.Tensor) -> torch.Tensor:
    """u16 storage -> int32 values (uint16 has few torch operators)."""
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def _new_answer(n: int, device) -> torch.Tensor:
    return torch.empty(-(-n // 16) * 16 + n, dtype=torch.uint8,
                       device=device)


def answer_views(answer, n: int):
    """(off, state): the two views of one probe's answer buffer (a tensor
    or a numpy array) to ``n`` queries. State starts at the 16-byte
    boundary after off, so that the kernel writes both as 4-byte words."""
    s = -(-n // 16) * 16
    return answer[:n], answer[s:s + n]


def first_event_reference(fp: torch.Tensor, q_fp: torch.Tensor,
                          homes: torch.Tensor, w: int,
                          chunk: int = 1 << 18, out=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: a chunked [n, w] gather, compare and
    min over key = 2*rel (candidate) | 2*rel+1 (empty). A home whose window
    runs off the plane (home < 0 or home + w > len(fp)) is unresolved, as in
    the kernel. Returns (off u8, state u8) on fp's device: ``out`` when
    given, else the views of a new answer buffer, as the kernel's are."""
    n = homes.numel()
    dev = fp.device
    off, state = out if out is not None else answer_views(
        _new_answer(n, dev), n)
    plane = fp.view(torch.int16)
    rel = torch.arange(w, dtype=torch.int64, device=dev)
    big2 = 2 * w
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        h = homes[s:e].to(torch.int64)
        valid = (h >= 0) & (h + w <= fp.numel())
        idx = (torch.where(valid, h, 0)[:, None] + rel).clamp_(
            max=max(fp.numel() - 1, 0))
        win = plane[idx].to(torch.int32) & 0xFFFF
        key = torch.where(win == _widen(q_fp[s:e])[:, None], rel * 2,
                          torch.where(win == FP_EMPTY, rel * 2 + 1, big2))
        fst = torch.where(valid, key.min(dim=1).values, big2)
        hit = fst < big2
        cand = hit & ((fst & 1) == 0)
        off[s:e] = torch.where(cand, fst >> 1, 0).to(torch.uint8)
        state[s:e] = cand.to(torch.uint8) + 2 * (hit & ~cand).to(torch.uint8)
    return off, state


def _check(fp, q_fp, homes, w) -> None:
    if not isinstance(w, int) or not 1 <= w <= MAX_WINDOW:
        raise KernelError(f"window {w!r} outside [1, {MAX_WINDOW}]")
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


def probe_answer(fp: torch.Tensor, q_fp: torch.Tensor, homes: torch.Tensor,
                 w: int) -> torch.Tensor:
    """First-event probe of ``w`` slots from each home, as one u8 answer
    buffer on the inputs' device (``answer_views`` gives its off and
    state, in the queries' order). CPU tensors run the plain twin; CUDA
    tensors launch the kernel on the current stream (or raise
    KernelError). fp: u16 plane, q_fp: u16 [n], homes: int32 [n]."""
    global launches
    _check(fp, q_fp, homes, w)
    n = homes.numel()
    answer = _new_answer(n, fp.device)
    off, state = answer_views(answer, n)
    if fp.device.type == "cpu":
        first_event_reference(fp, q_fp, homes, w, out=(off, state))
        return answer
    if fp.device.type != "cuda":
        raise KernelError(f"no tile-join kernel for device {fp.device}")
    if n == 0:
        return answer
    lib = load_kernel()
    stream = torch.cuda.current_stream(fp.device).cuda_stream
    rc = lib.tilejoin_first_event(
        fp.data_ptr(), fp.numel(), q_fp.data_ptr(), homes.data_ptr(), n, w,
        off.data_ptr(), state.data_ptr(), stream)
    if rc != 0:
        raise KernelError(f"tile-join kernel launch failed: CUDA error {rc}")
    with _lock:
        launches += 1
    return answer


def tilejoin_probe(fp: torch.Tensor, q_fp: torch.Tensor, homes: torch.Tensor,
                   w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-event probe of ``w`` slots from each home: (off u8, state u8)
    in the queries' order, on the inputs' device: the views of
    ``probe_answer``'s buffer."""
    return answer_views(probe_answer(fp, q_fp, homes, w), homes.numel())
