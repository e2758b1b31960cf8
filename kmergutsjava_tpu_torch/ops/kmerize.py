"""Amino-acid 8-mer packing on torch tensors (the counterpart of the JAX
package's ``ops/kmerize.py``).

value(start i) = sum_k a[i+k] * 20^(7-k) in int64; a window is valid when
all 8 offsets are < 20 and i < num_starts, which carries the reference's
window bound (KmerGutsJava.java:912):

- aa mode: ``i < len - K``, so num_starts = len - K: the last full window
  of a protein is skipped, a reference quirk kept here;
- DNA mode: over the reference's len/3+1 buffer, num_starts =
  len//3 - K + 1.

The JAX package's int32 residue form (``kmer_window_mods``) exists because a
TPU has no int64 lanes; the card has, so the residues here are taken of the
int64 value, and the hand kernel computes them exactly by a precomputed
reciprocal (``ops/kmer_windows.py``).
"""
from __future__ import annotations

import torch

from ..constants import K, POW20
from ..lookup.sparse import FP_MOD


def kmer_windows(aa_off: torch.Tensor, num_starts):
    """Pack every window of K amino-acid offsets into base-20 values.

    aa_off: [..., N] uint8 offsets (0..19 valid; >= 20 invalid or
    terminator); num_starts: [...] window starts a row. Returns (values
    [..., N-K+1] int64, the packed value of every window, valid or not;
    valid [..., N-K+1] bool)."""
    n = aa_off.shape[-1]
    w = max(n - K + 1, 0)
    dev = aa_off.device
    a = aa_off.to(torch.int64)
    values = torch.zeros(aa_off.shape[:-1] + (w,), dtype=torch.int64,
                         device=dev)
    ok = torch.ones(aa_off.shape[:-1] + (w,), dtype=torch.bool, device=dev)
    for k in range(K):
        seg = a[..., k: k + w]
        values += seg * int(POW20[k])
        ok &= seg < 20
    starts = torch.arange(w, device=dev)
    num_starts = torch.as_tensor(num_starts, device=dev).to(torch.int64)
    return values, ok & (starts < num_starts[..., None])


def window_homes_fps(aa_off: torch.Tensor, num_starts, num_sigs: int):
    """(homes int32, fps uint16, ok) per window: the window's value mod
    num_sigs (its home slot) and mod 65535 (its fingerprint), of every
    window whether valid or not, as the JAX package's ``_window_homes_qfp``
    (``parallel/annotate_step.py``) gives them."""
    values, ok = kmer_windows(aa_off, num_starts)
    homes = (values % num_sigs).to(torch.int32)
    return homes, to_u16(values % FP_MOD), ok


def to_u16(x: torch.Tensor) -> torch.Tensor:
    """Integer values in [0, 65536) -> uint16 storage."""
    return torch.where(x >= 32768, x - 65536, x).to(torch.int16).view(
        torch.uint16)
