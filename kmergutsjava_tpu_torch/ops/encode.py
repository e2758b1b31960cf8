"""Character-level encoding ops on torch tensors (the counterpart of the JAX
package's ``ops/encode.py``).

Every per-character switch of the reference (KmerGutsJava.java:111-318)
is a 256-entry byte table indexed by the ASCII byte, so bytes 128-255
(latin-1 input) index it too. The JAX package applies the tables as a
one-hot matrix product on the TPU's matrix unit; here they are a plain
index, which is what the hand kernel (``csrc/kmer_windows.cu``) does with
the tables in shared memory. These ops are the kernel's plain twin.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import AA_OFF_LUT, COMPL_DNA_CODE_LUT, DNA_CODE_LUT


def byte_lut(lut: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    """``lut[idx]`` for a small numpy table and integer codes in
    [0, len(lut)), on idx's device."""
    return torch.from_numpy(np.ascontiguousarray(lut)).to(idx.device)[
        idx.long()]


def aa_offsets(ascii_u8: torch.Tensor) -> torch.Tensor:
    """ASCII bytes -> amino-acid offsets 0..19 (20 = invalid), uint8.

    Mirrors toAminoAcidOff (ref :111-175) applied per char (ref :1054-1058).
    """
    return byte_lut(AA_OFF_LUT, ascii_u8)


def dna_codes(ascii_u8: torch.Tensor) -> torch.Tensor:
    """ASCII bytes -> base codes A=0 C=1 G=2 T/U=3 (4 = invalid), ref
    dnaChar."""
    return byte_lut(DNA_CODE_LUT, ascii_u8)


def compl_codes(ascii_u8: torch.Tensor) -> torch.Tensor:
    """ASCII bytes -> base codes of their complements (not reversed)."""
    return byte_lut(COMPL_DNA_CODE_LUT, ascii_u8)


def revcomp_codes(ascii_u8: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Base codes of the reverse complement of an ASCII DNA array.

    The reference's revComp char round-trip (compl per char, then reverse,
    ref :263-272, then dnaChar during translation :324-326) as one table
    index plus a flip. IUPAC ambiguity codes complement to non-ACGT letters
    and therefore stay invalid (4), as in the reference.
    """
    return torch.flip(compl_codes(ascii_u8), dims=(axis,))
