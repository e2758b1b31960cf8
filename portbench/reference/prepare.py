"""The query side: 8-mer windows of proteins, or of the six translated
frames of DNA contigs (prepareQuery, KmerGutsJava.java:1051-1074).

- An amino acid's offset is its place in ``ACDEFGHIKLMNPQRSTVWY``; every
  other byte, lower case included, is invalid (toAminoAcidOff :111-175).
- An 8-mer's value packs its eight offsets in base 20, first residue most
  significant (encodedKmer :274-292); a window with an invalid residue
  has none.
- Protein mode takes windows ``i < len - 8`` (addKmers :912): a protein's
  last full window is skipped.
- DNA mode translates frames +0, +1, +2 of the contig and then -0, -1, -2
  of its reverse complement (translate :320-343, the IUPAC complement
  :177-260); a codon with a base outside ACGTU is invalid, a stop codon
  too. Every full window of a frame counts.

Containers are made in that order: one (id, "+", 0) a protein, six a
contig, and their index is the container id of a query.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from .fasta import Record

K = 8
INVALID_AA = 20
INVALID_BASE = 4
AMINO = b"ACDEFGHIKLMNPQRSTVWY"
# codon index c1 * 16 + c2 * 4 + c3 (A=0, C=1, G=2, T=3) -> amino acid
GENETIC_CODE = (b"KNKNTTTTRSRSIIMI" b"QHQHPPPPRRRRLLLL"
                b"EDEDAAAAGGGGVVVV" b"*Y*YSSSS*CWCLFLF")


def _aa_lut() -> np.ndarray:
    lut = np.full(256, INVALID_AA, dtype=np.uint8)
    lut[np.frombuffer(AMINO, np.uint8)] = np.arange(20, dtype=np.uint8)
    return lut


def _base_lut() -> np.ndarray:
    lut = np.full(256, INVALID_BASE, dtype=np.uint8)
    for chars, code in ((b"aA", 0), (b"cC", 1), (b"gG", 2), (b"tuTU", 3)):
        lut[np.frombuffer(chars, np.uint8)] = code
    return lut


def _complement() -> np.ndarray:
    lut = np.arange(256, dtype=np.uint8)
    for src, dst in zip(b"aAcCgGtuTUmMrRwWsSyYkKbBdDhHvVnN",
                        b"tTgGcCaaAAkKyYwWSSrRmMvVhHdDbBnN"):
        lut[src] = dst
    return lut


AA_LUT = _aa_lut()
BASE_LUT = _base_lut()
COMPLEMENT = _complement()
CODON_AA = AA_LUT[np.frombuffer(GENETIC_CODE, np.uint8)]

Container = Tuple[str, str, int]


class Queries(NamedTuple):
    """The query 8-mers of a FASTA text, and its containers."""
    values: np.ndarray      # int64 8-mer values
    container: np.ndarray   # int64 container index of each value
    pos: np.ndarray         # int64 window start in its protein or frame
    containers: List[Container]
    lengths: Dict[str, int]  # id -> sequence length, in input order


def _windows(offs: np.ndarray):
    """(values, valid) of every 8-residue window of ``offs``."""
    w = len(offs) - K + 1
    if w <= 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    o = offs.astype(np.int64)
    values = o[:w].copy()
    for k in range(1, K):
        values *= 20
        values += o[k:k + w]
    return values, _valid(offs)


def _valid(offs: np.ndarray) -> np.ndarray:
    """Whether each 8-residue window of ``offs`` holds no invalid one."""
    w = len(offs) - K + 1
    if w <= 0:
        return np.zeros(0, bool)
    bad = np.concatenate([[0], np.cumsum(offs >= 20, dtype=np.int32)])
    return bad[K:] == bad[:w]


def _lengths(records: Sequence[Record]) -> Dict[str, int]:
    lengths: Dict[str, int] = {}
    for r in records:
        if r.id in lengths:
            raise ValueError(f"duplicate record id {r.id}: the judged "
                             "traffic never repeats an id")
        lengths[r.id] = len(r.seq)
    return lengths


def _protein_row(records: Sequence[Record]):
    """(offsets of all proteins, K-1 invalid ones between them; each
    protein's start and length)."""
    lens = np.array([len(r.seq) for r in records], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens + K - 1)])[:-1]
    text = ("\0" * (K - 1)).join(r.seq for r in records).encode("latin-1")
    return AA_LUT[np.frombuffer(text, np.uint8)], starts, lens


def _strands(records: Sequence[Record], lens, pads):
    """Each contig's bases (forward, then reverse complement) as base codes,
    every contig followed by its pad of invalid bases."""
    if len(set(lens.tolist())) == 1:  # equal lengths (read sets): a matrix
        n, length = len(records), int(lens[0])
        seqs = np.frombuffer("".join(r.seq for r in records).encode(
            "latin-1"), np.uint8).reshape(n, length)
        for rows in (seqs, COMPLEMENT[seqs[:, ::-1]]):
            c = np.full((n, length + int(pads[0])), INVALID_BASE, np.uint8)
            c[:, :length] = BASE_LUT[rows]
            yield c.reshape(-1)
        return
    seqs = [r.seq.encode("latin-1") for r in records]
    fill = [b"\0" * p for p in pads.tolist()]
    comp = COMPLEMENT.tobytes()
    for strand in (seqs, [s.translate(comp)[::-1] for s in seqs]):
        text = b"".join(x for pair in zip(strand, fill) for x in pair)
        yield BASE_LUT[np.frombuffer(text, np.uint8)]


def _frame_rows(records: Sequence[Record]):
    """The six frame rows of all contigs, each contig in a block that
    starts on a codon boundary with at least K-1 invalid codons after it:
    [(strand, frame, amino-acid offsets)], and each contig's first codon."""
    lens = np.array([len(r.seq) for r in records], dtype=np.int64)
    pads = 3 * (K - 1) + (3 - lens % 3) % 3
    starts = np.concatenate([[0], np.cumsum(lens + pads)])[:-1]
    rows = []
    for strand, codes in enumerate(_strands(records, lens, pads)):
        c = np.concatenate([codes, np.full(3, INVALID_BASE, np.uint8)])
        ncod = len(codes) // 3
        for f in range(3):
            c1, c2, c3 = (c[f + t:f + t + 3 * ncod:3] for t in range(3))
            ok = (c1 | c2 | c3) < 4
            codon = np.where(ok, (c1 << 4) | (c2 << 2) | c3, 0)
            rows.append((strand, f, np.where(ok, CODON_AA[codon],
                                             INVALID_AA).astype(np.uint8)))
    return rows, starts // 3


def protein_queries(records: Sequence[Record]) -> Queries:
    lengths = _lengths(records)
    offs, starts, lens = _protein_row(records)
    values, valid = _windows(offs)
    idx = np.nonzero(valid)[0]
    rec = np.searchsorted(starts, idx, side="right") - 1
    pos = idx - starts[rec]
    keep = pos < lens[rec] - K  # the skipped last window
    return Queries(values[idx[keep]], rec[keep], pos[keep],
                   [(r.id, "+", 0) for r in records], lengths)


def dna_queries(records: Sequence[Record]) -> Queries:
    lengths = _lengths(records)
    rows, cod_start = _frame_rows(records)
    parts = []
    for strand, f, offs in rows:
        values, valid = _windows(offs)
        idx = np.nonzero(valid)[0]
        rec = np.searchsorted(cod_start, idx, side="right") - 1
        parts.append((values[idx], 6 * rec + 3 * strand + f,
                      idx - cod_start[rec]))
    values, container, pos = (np.concatenate([p[i] for p in parts])
                              for i in range(3))
    containers = [(r.id, s, f) for r in records for s in ("+", "-")
                  for f in range(3)]
    return Queries(values, container, pos, containers, lengths)


def queries(records: Sequence[Record], aa: bool) -> Queries:
    return protein_queries(records) if aa else dna_queries(records)


def count(records: Sequence[Record], aa: bool) -> int:
    """How many query 8-mers ``queries`` gives (the work of a request),
    without making them."""
    if not aa:
        return sum(int(_valid(offs).sum())
                   for _, _, offs in _frame_rows(records)[0])
    lens = np.array([len(r.seq) for r in records], dtype=np.int64)
    offs = AA_LUT[np.frombuffer("".join(r.seq for r in records).encode(
        "latin-1"), np.uint8)]
    # valid windows of the concatenation, counted only where they start
    # in [start, start + len - K) of a protein (inside it, last one left out)
    ok = np.concatenate([[0], np.cumsum(_valid(offs), dtype=np.int64)])
    start = np.concatenate([[0], np.cumsum(lens)])[:-1][lens > K]
    end = start + lens[lens > K] - K
    return int((ok[end] - ok[start]).sum())
