"""K-mer windows from ASCII rows: the hand-written CUDA kernel
``csrc/kmer_windows.cu`` (the device prepare's, ``--prepare jax``), its
plain PyTorch twins and the wrapper that picks between them by the
tensors' device. The fused step runs the same windows and their probe in
one launch (``parallel/fused_probe.py``, whose twin starts from
``windows_reference`` here and whose checks from ``_check``).

Replaces the device programs that the JAX package writes in XLA for the
TPU to prepare queries: the values of ``ops/kmerize.py`` ``kmer_windows``
and ``kmer_window_mods`` over the JAX prepare's padded power-of-two
buckets (encode, six-frame translation, 8-mer packing), and the
compaction of their valid windows on the host. ``windows_reference`` is
the composition of ``ops/encode.py``, ``ops/translate.py`` and
``ops/kmerize.py`` over padded rows: each window's value, or its home and
fingerprint (-1 and 0 for a window that is not valid, which the sparse
probe answers as off the plane without reading it); the twin of the fused
step's windows too.

``ragged_values``: rows unpadded in one byte stream with their bounds ->
only the valid windows, compacted on the card in the order
``np.nonzero`` gives the padded values (container, then position): values
int64, positions int32, and a count a container (a protein, or a contig's
frame).

The kernel is compiled with nvcc for sm_90a into a plain-C shared library on
first use and loaded with ctypes; nothing is built or imported for CUDA when
this module is imported.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np
import torch

from ..constants import (AA_OFF_LUT, CODON_AA_OFF, COMPL_DNA_CODE_LUT,
                         DNA_CODE_LUT, K)
from ..lookup.tilejoin import KernelError, build_cuda_library
from .encode import aa_offsets
from .kmerize import FP_MOD, kmer_windows, to_u16
from .translate import translate_6frames

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "kmer_windows.cu")

# the ragged entry's calls (two kernels each) since import (or since a
# caller reset it to 0); counted only where the wrapper launches the CUDA
# kernel, never for the twin
ragged_launches = 0

# the kernel's tables (struct Luts of the source), passed by value a launch
_LUTS = np.ascontiguousarray(np.concatenate(
    [AA_OFF_LUT, DNA_CODE_LUT, COMPL_DNA_CODE_LUT, CODON_AA_OFF]
).astype(np.uint8))
assert _LUTS.size == 832

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
    """Type the C entries of a build of the kernel."""
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.kmer_values_ragged.restype = ctypes.c_int
    lib.kmer_values_ragged.argtypes = [p, ctypes.c_int, p, i64, p, i64, p, p,
                                       p, p, p]
    lib.kmer_values_tile.restype = ctypes.c_int
    lib.kmer_values_tile.argtypes = []
    return lib


def reciprocal(d: int) -> int:
    """The fused kernel's exact reciprocal of a divisor: ceil(2^66 / d), with
    which floor(v * M / 2^66) == v // d for every v < 2^35 (all k-mer
    values) and 5 <= d < 2^31; 0 (the kernel's plain %) below 5."""
    return 0 if d < 5 else -(-(1 << 66) // d)


def windows_reference(ascii_u8: torch.Tensor, counts: torch.Tensor, aa: bool,
                      num_sigs: Optional[int] = None, row_map=None,
                      own_start=None, own_end=None):
    """Windows of padded rows by the JAX package's ops, composed: the twin
    of the fused kernel's windows and of the ragged entry. ``counts``:
    num_starts (aa rows) or lengths (DNA rows). Returns (homes, fps) when
    ``num_sigs`` is given, else the values; a window that is not valid has
    home -1, fingerprint 0, value -1."""
    if aa:
        values, ok = kmer_windows(aa_offsets(ascii_u8), counts)
    else:
        frames = translate_6frames(ascii_u8, counts)  # [B, 6, Lpad//3]
        if row_map is None:
            starts = (counts.to(torch.int64) // 3 - K + 1).clamp(min=0)
            values, ok = kmer_windows(frames, starts[:, None].expand(-1, 6))
        else:
            r = row_map.to(torch.int64)
            good = (r >= 0) & (r < 6)
            sel = torch.take_along_dim(
                frames, torch.where(good, r, 0)[:, :, None], dim=1)
            w = max(sel.shape[-1] - K + 1, 0)
            values, ok = kmer_windows(sel, torch.full_like(r, w))
            jj = torch.arange(w, device=ascii_u8.device)
            ok &= (good[..., None] & (jj >= own_start[..., None])
                   & (jj < own_end[..., None]))
    if num_sigs is None:
        return torch.where(ok, values, -1)
    homes = torch.where(ok, values % num_sigs, -1).to(torch.int32)
    return homes, to_u16(torch.where(ok, values % FP_MOD, 0))


def _check(ascii_u8, counts, num_sigs, extra=()) -> None:
    """The fused entries' checks of their rows, counts and long-contig
    columns (``extra``: (name, tensor) pairs) and of ``num_sigs``."""
    dev = ascii_u8.device
    if (ascii_u8.dtype != torch.uint8 or ascii_u8.dim() != 2
            or not ascii_u8.is_contiguous()):
        raise KernelError(f"ascii must be a contiguous 2-D uint8 tensor, got "
                          f"{ascii_u8.dtype} {tuple(ascii_u8.shape)}")
    b = ascii_u8.shape[0]
    for name, t, shape in (("counts", counts, (b,)),
                           *((n, x, (b, 6)) for n, x in extra)):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise KernelError(f"{name} must be a contiguous int32 tensor of "
                              f"shape {shape}, got {t.dtype} "
                              f"{tuple(t.shape)}")
        if t.device != dev:
            raise KernelError(f"{name} is on {t.device}, ascii on {dev}")
    if num_sigs is not None and not 1 <= num_sigs < 1 << 31:
        raise KernelError(f"num_sigs {num_sigs} outside [1, 2^31)")
    if dev.type not in ("cpu", "cuda"):
        raise KernelError(f"no k-mer window kernel for device {dev}")


# the ragged entry's bounds: bytes (DNA positions are two a byte, int32)
# and rows (six containers a DNA row, int32)
MAX_RAGGED_BYTES = 1 << 30
MAX_RAGGED_ROWS = 1 << 28


def ragged_values_reference(bytes_u8: torch.Tensor, bounds: torch.Tensor,
                            aa: bool):
    """Plain PyTorch twin of the ragged entry: each row's values by
    ``windows_reference`` (the rows of one power-of-two length class
    padded together, which changes no window), its valid windows by
    ``torch.nonzero``, in container order. Returns (values int64 [n], pos
    int32 [n], counts int32 [containers])."""
    dev = bytes_u8.device
    b = bounds.to(torch.int64)
    lens = b[1:] - b[:-1]
    per = 1 if aa else 6
    counts = torch.zeros(lens.numel() * per, dtype=torch.int32, device=dev)
    parts = [(torch.zeros(0, dtype=torch.int64, device=dev),) * 3]
    classes = _pow2_class(lens)
    for width in (torch.unique(classes).tolist() if bytes_u8.numel() else ()):
        sel = torch.nonzero(classes == width).view(-1)
        cols = torch.arange(width, device=dev)
        at = (b[sel][:, None] + cols).clamp(max=bytes_u8.numel() - 1)
        mat = torch.where(cols < lens[sel][:, None], bytes_u8[at], 0)
        n_in = (lens[sel] - K) if aa else lens[sel]
        values = windows_reference(mat.contiguous(), n_in.to(torch.int32),
                                   aa)
        idx = torch.nonzero(values >= 0)
        c = sel[idx[:, 0]] * per + (0 if aa else idx[:, 1])
        parts.append((c, idx[:, -1], values[tuple(idx.t())]))
    c, j, v = (torch.cat(x) for x in zip(*parts))
    order = torch.argsort(c * (1 << 31) + j)
    counts += torch.bincount(c, minlength=counts.numel()).to(torch.int32)
    return v[order], j[order].to(torch.int32), counts


def _pow2_class(lens: torch.Tensor) -> torch.Tensor:
    """The padded width a row's length class takes in the twin: the next
    power of two at or above the length, 32 at least."""
    x = lens.clamp(min=32) - 1
    return torch.pow(2, torch.floor(torch.log2(x.double())).long() + 1)


def ragged_values(bytes_u8: torch.Tensor, bounds: torch.Tensor, aa: bool):
    """The valid windows of unpadded rows, compacted in container order:
    row r is bytes_u8[bounds[r]:bounds[r + 1]] (bounds int32 [R + 1] from 0
    to the byte count, never down); its windows are a protein's (``aa``:
    window j valid for j < length - 8 and 8 amino acids) or a contig's six
    frames' (container 6r + g, +0 +1 +2 -0 -1 -2; j < length/3 - 7).
    Returns (values int64 [n], pos int32 [n], counts int32 [R or 6R]).
    CPU tensors run the twin; CUDA tensors launch the kernel's two
    kernels on the current stream and wait for the total (or raise
    KernelError)."""
    global ragged_launches
    if (bytes_u8.dtype != torch.uint8 or bytes_u8.dim() != 1
            or not bytes_u8.is_contiguous()):
        raise KernelError(f"bytes must be a contiguous 1-D uint8 tensor, "
                          f"got {bytes_u8.dtype} {tuple(bytes_u8.shape)}")
    if (bounds.dtype != torch.int32 or bounds.dim() != 1
            or bounds.numel() < 1 or not bounds.is_contiguous()):
        raise KernelError(f"bounds must be a contiguous 1-D int32 tensor of "
                          f"rows + 1 entries, got {bounds.dtype} "
                          f"{tuple(bounds.shape)}")
    dev = bytes_u8.device
    if bounds.device != dev:
        raise KernelError(f"bounds is on {bounds.device}, bytes on {dev}")
    n, rows = bytes_u8.numel(), bounds.numel() - 1
    if n >= MAX_RAGGED_BYTES or rows >= MAX_RAGGED_ROWS:
        raise KernelError(f"{n} bytes in {rows} rows: the ragged entry takes "
                          f"under {MAX_RAGGED_BYTES} and {MAX_RAGGED_ROWS}")
    if dev.type == "cpu":
        return ragged_values_reference(bytes_u8, bounds, aa)
    if dev.type != "cuda":
        raise KernelError(f"no k-mer window kernel for device {dev}")
    slots = n if aa else 2 * n
    containers = rows * (1 if aa else 6)
    if slots == 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(containers, dtype=torch.int32, device=dev))
    lib = load_kernel()
    tiles = -(-slots // lib.kmer_values_tile())
    values = torch.empty(slots, dtype=torch.int64, device=dev)
    pos = torch.empty(slots, dtype=torch.int32, device=dev)
    counts = torch.empty(containers, dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * tiles + 1, dtype=torch.int32, device=dev)
    rc = lib.kmer_values_ragged(
        _LUTS.ctypes.data, int(aa), bytes_u8.data_ptr(), n,
        bounds.data_ptr(), rows, values.data_ptr(), pos.data_ptr(),
        counts.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"k-mer window kernel (ragged entry) launch "
                          f"failed: CUDA error {rc}")
    with _lock:
        ragged_launches += 1
    total = int(scratch[2 * tiles])
    return values[:total], pos[:total], counts
