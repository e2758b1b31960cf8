"""Helpers the traffic generators share.

Sizes are never drawn at random: a pool of 2^m requests takes the 2^m
quantiles of its size distribution, in bit-reversed order XOR a
seed-chosen mask. Every seed thus gets the same set of sizes, in another
order, and every prefix of 2^j requests holds one size from each of 2^j
equal strata, so a window that ends anywhere has seen a balanced mix.
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from ..reference.fasta import Record
from ..reference.prepare import AMINO


def _bit_reverse(k: int, bits: int) -> int:
    return int(format(k, f"0{bits}b")[::-1], 2) if bits else 0


def log_uniform_sizes(lo: float, hi: float, count: int,
                      rng: np.random.Generator) -> List[int]:
    """``count`` (a power of two) sizes at the quantiles of log-uniform
    [lo, hi], in the balanced order described above."""
    bits = count.bit_length() - 1
    if count != 1 << bits:
        raise ValueError(f"a pool of {count}: not a power of two")
    mask = int(rng.integers(count))
    return [int(round(lo * (hi / lo) ** ((_bit_reverse(k ^ mask, bits) + 0.5)
                                        / count)))
            for k in range(count)]


def substitute_protein(seq: np.ndarray, rate: float,
                       rng: np.random.Generator) -> np.ndarray:
    """Each residue replaced with probability ``rate`` by another of the
    20 amino acids (any of them where it was none)."""
    alphabet = np.frombuffer(AMINO, np.uint8)
    at = np.nonzero(rng.random(len(seq)) < rate)[0]
    out = seq.copy()
    idx = np.full(256, -1, np.int64)
    idx[alphabet] = np.arange(20)
    old = idx[seq[at]]
    shift = rng.integers(1, 20, len(at))
    new = np.where(old >= 0, (old + shift) % 20, rng.integers(0, 20, len(at)))
    out[at] = alphabet[new]
    return out


BASES = np.frombuffer(b"ACGT", np.uint8)
BASE_CODE = np.zeros(256, np.uint8)
BASE_CODE[BASES] = np.arange(4, dtype=np.uint8)


def substitute_dna(seq: np.ndarray, rate: float, reverse: bool,
                   rng: np.random.Generator) -> np.ndarray:
    """ACGT bytes, optionally reverse-complemented, each base replaced with
    probability ``rate`` by one of the three others."""
    code = BASE_CODE[seq]
    if reverse:
        code = (3 - code)[::-1]
    at = rng.random(len(code)) < rate
    code = code.copy()
    code[at] = (code[at] + rng.integers(1, 4, int(at.sum()))) % 4
    return BASES[code]


def fasta_text(records: Sequence[Record]) -> str:
    return "".join(f">{r.id}\n{r.seq}\n" for r in records)


def write(run, name: str, text: str) -> str:
    d = os.path.join(run.work, "traffic")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, name)
    with open(path, "w", encoding="latin-1") as fh:
        fh.write(text)
    return path
