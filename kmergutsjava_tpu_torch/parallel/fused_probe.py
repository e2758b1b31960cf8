"""The fused step's kernel: k-mer windows from ASCII rows and their probe of
the u16 fingerprint plane in one launch (``csrc/fused_probe.cu``), its
plain PyTorch twin, and the wrappers that pick between them by the tensors'
device.

Replaces the device programs that the JAX package writes in XLA for the
TPU: ``parallel/annotate_step.py`` ``_encode_and_probe`` and
``_dna_encode_and_probe`` with the probe they end in
(``parallel/sharded_lookup.py`` ``_local_probe``), and
``parallel/seq_windows.py`` ``_window_probe`` (a long contig's windows). The
windows are ``ops/kmer_windows.py`` ``windows_reference``'s; each window's
home and fingerprint stay on the card's registers and go straight into
the probe, so they never reach device memory. Two entries:

- ``first_event``: the sparse probe B1's answer (``lookup/tilejoin.py``)
  to every window at window ``w`` on the whole plane, as one u8 answer
  buffer (``tilejoin.answer_views`` gives off and state): the fused step
  on one device, whose answer ``annotate_step.read_candidates`` reads;
- ``shard_first_match``: the shard probe B12's answer
  (``parallel/shard_probe.py``) to every window for the table shard that
  owns the slots ``[lo, lo + s_loc)``, on its plane slice (with its halo
  of ``w`` slots): int32, the global slot + 1 of the first fingerprint
  match, 0 for a window that is not valid, not owned or has none; the
  fused step at a mesh position, summed over the table axis.

Each takes protein rows ``uint8[B, Lpad]`` with ``num_starts[B]``
(windows ``[B, Lpad - 7]``) or contig rows with ``lengths[B]`` and, for a
long contig's windows, ``row_map``, ``own_start`` and ``own_end`` ``[B,
6]`` (windows ``[B, 6, Lpad//3 - 7]``); answers are flat in the windows'
order. The twin of each is the composition of the twins that exist
already: ``kmer_windows.windows_reference``, then
``tilejoin.first_event_reference`` or
``shard_probe.shard_probe_reference``.

The kernel is compiled with nvcc for sm_90a into a plain-C shared library on
first use and loaded with ctypes; nothing is built or imported for CUDA when
this module is imported.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from ..constants import K
from ..lookup import tilejoin
from ..lookup.tilejoin import KernelError, build_cuda_library
from ..ops import kmer_windows
from . import shard_probe

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "fused_probe.cu")

# kernel launches since import (or since a caller reset it to 0), of both
# entries; counted only where a wrapper launches the CUDA kernel, never for
# the twin
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
        _lib = bind(build_cuda_library(SOURCE))
        return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type the two C entries of a built library of the kernel."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    rows = [p, ctypes.c_int, p, i64, i64, p, p, p, p, i64, ctypes.c_uint64,
            p, i64]
    lib.fused_first_event.restype = ctypes.c_int
    lib.fused_first_event.argtypes = rows + [i32, p, p, p]
    lib.fused_shard_probe.restype = ctypes.c_int
    lib.fused_shard_probe.argtypes = rows + [i64, i64, i32, p, p]
    return lib


def _windows(ascii_u8, counts, aa, num_sigs, extra):
    """The twin's flat homes and fingerprints."""
    homes, fps = kmer_windows.windows_reference(ascii_u8, counts, aa,
                                                num_sigs, *extra)
    return homes.reshape(-1), fps.reshape(-1)


def first_event_reference(plane, ascii_u8, counts, aa: bool, num_sigs: int,
                          w: int, row_map=None, own_start=None,
                          own_end=None) -> torch.Tensor:
    """Plain PyTorch twin of the first-event entry: ``windows_reference``,
    then B1's twin, into one answer buffer."""
    homes, fps = _windows(ascii_u8, counts, aa, num_sigs,
                          (row_map, own_start, own_end))
    n = homes.numel()
    answer = tilejoin._new_answer(n, plane.device)
    tilejoin.first_event_reference(plane, fps, homes, w,
                                   out=tilejoin.answer_views(answer, n))
    return answer


def shard_first_match_reference(plane, ascii_u8, counts, aa: bool,
                                num_sigs: int, lo: int, s_loc: int, w: int,
                                row_map=None, own_start=None, own_end=None
                                ) -> torch.Tensor:
    """Plain PyTorch twin of the shard entry: ``windows_reference``, then
    B12's twin."""
    homes, fps = _windows(ascii_u8, counts, aa, num_sigs,
                          (row_map, own_start, own_end))
    return shard_probe.shard_probe_reference(plane, fps, homes, lo, s_loc, w)


def _check(plane, ascii_u8, counts, aa, num_sigs, extra) -> None:
    if aa and extra:
        raise KernelError("row_map is for contig rows only")
    if extra and len(extra) != 3:
        raise KernelError("row_map needs own_start and own_end")
    kmer_windows._check(ascii_u8, counts, num_sigs,
                        tuple(zip(("row_map", "own_start", "own_end"),
                                  extra)))
    if (plane.dtype != torch.uint16 or plane.dim() != 1
            or not plane.is_contiguous()):
        raise KernelError(f"plane must be a contiguous 1-D uint16 tensor, "
                          f"got {plane.dtype} {tuple(plane.shape)}")
    if plane.device != ascii_u8.device:
        raise KernelError(f"plane is on {plane.device}, ascii on "
                          f"{ascii_u8.device}")
    if ascii_u8.shape[1] >= 1 << 30:
        raise KernelError(f"rows of {ascii_u8.shape[1]} bytes: at most "
                          f"2^30 - 1")
    if _n_windows(ascii_u8, aa) >= 1 << 31:
        raise KernelError("2^31 windows or more in one launch")


def _extra(row_map, own_start, own_end) -> tuple:
    given = [t for t in (row_map, own_start, own_end) if t is not None]
    if given and row_map is None:
        raise KernelError("own_start and own_end need row_map")
    return tuple(given)


def _n_windows(ascii_u8, aa) -> int:
    b, lpad = ascii_u8.shape
    w = max((lpad if aa else lpad // 3) - K + 1, 0)
    return b * w * (1 if aa else 6)


def _call(entry, ascii_u8, counts, aa, num_sigs, extra, plane, *tail):
    """Launch ``entry`` of the library on the current stream; count it."""
    global launches
    lib = load_kernel()
    dev = ascii_u8.device
    b, lpad = ascii_u8.shape
    ext = extra or (None, None, None)
    rc = getattr(lib, entry)(
        kmer_windows._LUTS.ctypes.data, int(aa), ascii_u8.data_ptr(), b,
        lpad, counts.data_ptr(),
        *(None if t is None else t.data_ptr() for t in ext),
        num_sigs, kmer_windows.reciprocal(num_sigs), plane.data_ptr(),
        plane.numel(), *tail, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"fused probe kernel launch failed: CUDA error "
                          f"{rc}")
    with _lock:
        launches += 1


def first_event(plane: torch.Tensor, ascii_u8: torch.Tensor,
                counts: torch.Tensor, aa: bool, num_sigs: int, w: int,
                row_map=None, own_start=None, own_end=None) -> torch.Tensor:
    """B1's first event at window ``w`` on ``plane`` (u16, the whole table
    and its padding) for every window of the rows, as one u8 answer
    buffer on the rows' device (``tilejoin.answer_views`` gives off and
    state, flat in the windows' order). CPU tensors run the plain twin;
    CUDA tensors launch the kernel on the current stream (or raise
    KernelError)."""
    extra = _extra(row_map, own_start, own_end)
    _check(plane, ascii_u8, counts, aa, num_sigs, extra)
    if not isinstance(w, int) or not 1 <= w <= tilejoin.MAX_WINDOW:
        raise KernelError(f"window {w!r} outside [1, {tilejoin.MAX_WINDOW}]")
    if ascii_u8.device.type == "cpu":
        return first_event_reference(plane, ascii_u8, counts, aa, num_sigs,
                                     w, *extra)
    n = _n_windows(ascii_u8, aa)
    answer = tilejoin._new_answer(n, ascii_u8.device)
    if n:
        off, state = tilejoin.answer_views(answer, n)
        _call("fused_first_event", ascii_u8, counts, aa, num_sigs, extra,
              plane, w, off.data_ptr(), state.data_ptr())
    return answer


def shard_first_match(plane: torch.Tensor, ascii_u8: torch.Tensor,
                      counts: torch.Tensor, aa: bool, num_sigs: int, lo: int,
                      s_loc: int, w: int, row_map=None, own_start=None,
                      own_end=None) -> torch.Tensor:
    """B12's answer for the table shard that owns ``[lo, lo + s_loc)``
    (``plane``: its u16 slice with a halo of ``w`` slots) to every window
    of the rows: int32, flat in the windows' order, on the rows' device.
    CPU tensors run the plain twin; CUDA tensors launch the kernel on the
    current stream (or raise KernelError)."""
    extra = _extra(row_map, own_start, own_end)
    _check(plane, ascii_u8, counts, aa, num_sigs, extra)
    shard_probe.check_shard(plane, lo, s_loc, w)
    if ascii_u8.device.type == "cpu":
        return shard_first_match_reference(plane, ascii_u8, counts, aa,
                                           num_sigs, lo, s_loc, w, *extra)
    n = _n_windows(ascii_u8, aa)
    out = torch.empty(n, dtype=torch.int32, device=ascii_u8.device)
    if n:
        _call("fused_shard_probe", ascii_u8, counts, aa, num_sigs, extra,
              plane, lo, s_loc, w, out.data_ptr())
    return out
