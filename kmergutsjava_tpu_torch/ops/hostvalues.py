"""Host recompute of packed k-mer values at hit coordinates (numpy; a copy
of the JAX package's ``ops/hostvalues.py``).

The fused device path (``models/spmd.py``) verifies every device candidate
against the query's full k-mer value on the host, and never reads query
values back from the device, so they are recomputed here AT THE CANDIDATE
COORDINATES only: O(hits x K) fancy-indexed gathers and, for DNA, no host
re-translation of whole contigs. The value of container ``g``'s window at
protein position ``j`` is read straight from the nucleotide bytes with the
codon math of the translation (``ops/translate.py``; ref
KmerGutsJava.java:320-343,1060-1073).
"""
from __future__ import annotations

import numpy as np

from ..constants import (AA_OFF_LUT, CODON_AA_OFF, COMPL_DNA_CODE_LUT,
                         DNA_CODE_LUT, K, POW20)


def aa_values_at(mat: np.ndarray, rr: np.ndarray, cc: np.ndarray
                 ) -> np.ndarray:
    """Packed k-mer values of aa windows starting at column ``cc`` of
    ascii rows ``mat[rr]``. Coordinates must point at valid windows
    (candidate windows passed the device's validity test, so all K
    residues are valid aa letters)."""
    vals = np.zeros(len(cc), np.int64)
    for k in range(K):
        vals += AA_OFF_LUT[mat[rr, cc + k]].astype(np.int64) * int(POW20[k])
    return vals


def dna_values_at(mat: np.ndarray, lens: np.ndarray, rr: np.ndarray,
                  gg: np.ndarray, cc: np.ndarray) -> np.ndarray:
    """Packed k-mer values of DNA windows: container ``gg`` (reference
    frame-row order +0+1+2-0-1-2), protein position ``cc``, of contig
    rows ``mat[rr]`` with true lengths ``lens[rr]``.

    aa position j of forward frame f reads nucleotides f+3j+t; of the
    reverse-complement frame f, nucleotides L-1-(f+3j+t) complemented,
    the indexing of the reference's revComp-then-translate (ref
    :1063-1072) and of translate_6frames. Coordinates must point at valid
    windows (all codons unambiguous)."""
    n = len(cc)
    vals = np.zeros(n, np.int64)
    if n == 0:
        return vals
    strand = gg // 3
    f = gg % 3
    L = lens[rr].astype(np.int64)
    rev = strand == 1
    for k in range(K):
        code = np.empty((3, n), np.int64)
        for t in range(3):
            p = f + 3 * (cc + k) + t
            idx = np.where(rev, L - 1 - p, p)
            # candidates are in range by the validity test; clamp
            # defensively
            idx = np.clip(idx, 0, mat.shape[1] - 1)
            b = mat[rr, idx]
            code[t] = np.where(rev, COMPL_DNA_CODE_LUT[b],
                               DNA_CODE_LUT[b]).astype(np.int64)
        ci = code[0] * 16 + code[1] * 4 + code[2]
        valid = (code < 4).all(axis=0)
        aa_off = CODON_AA_OFF[np.where(valid, ci, 0)].astype(np.int64)
        vals += aa_off * int(POW20[k])
    return vals
