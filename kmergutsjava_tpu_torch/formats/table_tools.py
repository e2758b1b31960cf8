"""Utilities to create signature tables from sequence data.

The reference repo ships no table builder (its data directory is external,
ref reference data/README.md), but every test and deployment needs one.
These helpers derive a signature set from annotated proteins and write a
data directory (kmer.table.mem_map + function.index) the engine — and the
reference Java engine — can consume.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import AA_OFF_LUT, K, POW20
from .function_index import write_function_index
from .kmer_table import FUNCTION_INDEX_FILE, TABLE_FILE, KmerTable, build_table, write_table


def protein_kmers(seq: str) -> List[Tuple[int, int]]:
    """All valid (value, start) 8-mer windows of a protein (full windows,
    i <= len-K; table building has no reason to reproduce the query-side
    skip-last-window quirk)."""
    offs = AA_OFF_LUT[np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)]
    if len(offs) < K:
        return []
    win = np.lib.stride_tricks.sliding_window_view(offs.astype(np.int64), K)
    values = win @ POW20
    starts = np.nonzero((win < 20).all(axis=1))[0]
    return list(zip(values[starts].tolist(), starts.tolist()))


def signatures_from_proteins(
    proteins: Iterable[Tuple[str, int, int]],
    weight: float = 1.0,
    weights: Optional[Dict[int, float]] = None,
) -> Dict[str, np.ndarray]:
    """Derive a signature set from (sequence, function_index, otu_index)
    triples. First occurrence of a k-mer wins; avg_from_end is the k-mer's
    offset from the protein end (len - start - K)."""
    vals: List[np.ndarray] = []
    otu: List[np.ndarray] = []
    avg: List[np.ndarray] = []
    fi: List[np.ndarray] = []
    wt: List[np.ndarray] = []
    for seq, f, o in proteins:
        kms = protein_kmers(seq)
        if not kms:
            continue
        v = np.fromiter((k[0] for k in kms), dtype=np.int64, count=len(kms))
        s = np.fromiter((k[1] for k in kms), dtype=np.int64, count=len(kms))
        vals.append(v)
        otu.append(np.full(len(v), o, dtype=np.int32))
        avg.append((len(seq) - s - K).astype(np.int32))
        fi.append(np.full(len(v), f, dtype=np.int32))
        w = weights.get(f, weight) if weights else weight
        wt.append(np.full(len(v), w, dtype=np.float32))
    if not vals:
        return dict(kmers=np.zeros(0, np.int64), otu=np.zeros(0, np.int32),
                    avg_from_end=np.zeros(0, np.int32),
                    fi=np.zeros(0, np.int32), wt=np.zeros(0, np.float32))
    v = np.concatenate(vals)
    # first occurrence wins: np.unique's return_index yields the first index
    # of each distinct value; re-sorting those indices restores input order
    _, first = np.unique(v, return_index=True)
    first.sort()
    return dict(
        kmers=v[first],
        otu=np.concatenate(otu)[first],
        avg_from_end=np.concatenate(avg)[first],
        fi=np.concatenate(fi)[first],
        wt=np.concatenate(wt)[first],
    )


def write_data_dir(data_dir: str, signatures: Dict[str, np.ndarray],
                   functions: Sequence[str], load_factor: float = 0.6,
                   gz: bool = False) -> KmerTable:
    """Write a complete engine data directory; returns the built table."""
    os.makedirs(data_dir, exist_ok=True)
    table = build_table(**signatures, load_factor=load_factor)
    suffix = ".gz" if gz else ""
    write_table(os.path.join(data_dir, TABLE_FILE + suffix), table)
    write_function_index(os.path.join(data_dir, FUNCTION_INDEX_FILE + suffix),
                         functions)
    return table
