"""Six-frame DNA translation on torch tensors (the counterpart of the JAX
package's ``ops/translate.py``).

The reference translates one frame at a time with a scalar codon walk
(translate, KmerGutsJava.java:320-343) into a reused buffer of length
len/3+1, writing a terminator (offset 21) one past the last codon. Here all
six frames come out at once as a [..., 6, Lpad//3] array of amino-acid
offsets in which every position at or past the frame's codon count
``(length - f)//3`` is 21, which the JAX package shows hit-equivalent to the
reference's buffer (the k-mer windows never read past index len/3-1).

Frame rows are in the order in which the reference creates hit containers
(prepareQuery, ref :1060-1073): +0, +1, +2, -0, -1, -2. Reverse frame f
reads base ``L-1-p`` complemented at position p of its strand, which is what
the JAX package's flip-then-roll of the padded row amounts to; a read past
``Lpad`` is an invalid base.
"""
from __future__ import annotations

import torch

from ..constants import CODON_AA_OFF, INVALID_AA, INVALID_DNA, TERMINATOR_AA
from .encode import byte_lut, compl_codes, dna_codes


def _codes_at(codes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """codes[..., idx] (idx [..., m] int64), INVALID_DNA outside [0, Lpad)."""
    lpad = codes.shape[-1]
    ok = (idx >= 0) & (idx < lpad)
    if lpad == 0:
        return torch.full(idx.shape, INVALID_DNA, dtype=torch.uint8,
                          device=idx.device)
    got = torch.gather(codes, -1, idx.clamp(0, lpad - 1))
    return torch.where(ok, got, INVALID_DNA)


def translate_6frames(ascii_u8: torch.Tensor, length) -> torch.Tensor:
    """ASCII DNA [..., Lpad] (content in [0, length)) -> [..., 6, Lpad//3]
    amino-acid offsets, uint8. ``length`` is a tensor of the leading shape
    (or an int for one row)."""
    lpad = ascii_u8.shape[-1]
    dev = ascii_u8.device
    m = lpad // 3
    length = torch.as_tensor(length, device=dev).to(torch.int64)[..., None]
    lead = ascii_u8.shape[:-1]
    j = torch.arange(m, device=dev)
    strands = (dna_codes(ascii_u8), compl_codes(ascii_u8))
    rows = []
    for strand in (0, 1):
        for f in range(3):
            c = []
            for t in range(3):
                p = (f + 3 * j + t).expand(*lead, m)
                idx = p if strand == 0 else length - 1 - p
                c.append(_codes_at(strands[strand], idx).long())
            ok = (c[0] < 4) & (c[1] < 4) & (c[2] < 4)
            codon = torch.where(ok, c[0] * 16 + c[1] * 4 + c[2], 0)
            aa = torch.where(ok, byte_lut(CODON_AA_OFF, codon), INVALID_AA)
            # codons in this frame: floor((length - f) / 3), >= 0
            ncod = (length - f).clamp(min=0) // 3
            rows.append(torch.where(j < ncod, aa, TERMINATOR_AA)
                        .to(torch.uint8))
    return torch.stack(rows, dim=-2)
