"""The E. coli K-12 W3110 corpus (the reference's own test input,
KmerGutsJavaServerTest.java:76-86; copies in ``portbench/data``) and the
tables made from it.

``corpus_signatures``: every protein but each third contributes its 8-mers
(every full window), the first occurrence of a value wins, function =
index mod 97, OTU = index mod 20, weight 1, avg_from_end = len - start - 8.

``seeded_table``: those signatures (of the first ``corpus_proteins``
proteins, where a configuration names a number), with seeded weights in
(0, 1] in place of 1, plus seeded random filler up to a total count, with
random OTU (< 20), avg_from_end (< 500), function (< 97) and weight in
[0, 1); the filler is a uniform draw of distinct values that are not
corpus signatures and do not home in the table's last TAIL slots.
"""
from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from ..reference import fasta
from ..reference.prepare import AA_LUT, K
from ..reference.table import MAX_ENCODED
from .tables import next_odd_prime, write_slots

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")
PROTEOME = os.path.join(DATA, "Ecoli_K12_W3110.faa.gz")
GENOME = os.path.join(DATA, "Ecoli_K12_W3110.fna.gz")
TAIL = 4096  # slots at the table's end in which no filler value homes


def _records_with_descr(path: str) -> List[Tuple[str, str, str]]:
    """(id, description, sequence) of each record; the corpus files are
    well formed, one caption line per record."""
    out = []
    for block in ("\n" + fasta.read_text(path)).split("\n>")[1:]:
        head, _, body = block.partition("\n")
        tokens = head.replace("\t", " ").split()
        out.append((tokens[0], " ".join(tokens[1:]),
                    body.replace("\n", "").replace("\r", "")))
    return out


@lru_cache(maxsize=None)
def proteome() -> Tuple[Tuple[str, str, str], ...]:
    return tuple(_records_with_descr(PROTEOME))


@lru_cache(maxsize=None)
def genome() -> Tuple[str, str, str]:
    return _records_with_descr(GENOME)[0]


def corpus_signatures(proteins) -> Dict[str, np.ndarray]:
    chosen = [(i, seq) for i, (_, _, seq) in enumerate(proteins)
              if i % 3 != 2]
    lens = np.array([len(s) for _, s in chosen], dtype=np.int64)
    idx = np.array([i for i, _ in chosen], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens + K - 1)])[:-1]
    text = ("\0" * (K - 1)).join(s for _, s in chosen).encode("latin-1")
    offs = AA_LUT[np.frombuffer(text, np.uint8)]
    w = len(offs) - K + 1
    o = offs.astype(np.int64)
    values, valid = o[:w].copy(), offs[:w] < 20
    for k in range(1, K):
        values = values * 20 + o[k:k + w]
        valid &= offs[k:k + w] < 20
    at = np.nonzero(valid)[0]
    values = values[at]
    _, first = np.unique(values, return_index=True)  # stable: first wins
    first.sort()
    at = at[first]
    rec = np.searchsorted(starts, at, side="right") - 1
    prot = idx[rec]
    return dict(kmers=values[first],
                otu=(prot % 20).astype(np.int32),
                avg_from_end=(lens[rec] - (at - starts[rec]) - K).astype(
                    np.int32),
                fi=(prot % 97).astype(np.int32),
                wt=np.ones(len(first), dtype=np.float32))


def function_names(count: int) -> List[str]:
    return [f"ecoli function {i}" for i in range(count)]


def fixed_num_sigs(corpus_kmers: np.ndarray, total: int, load: float) -> int:
    """numSigs of a configuration: the next odd prime above total / load,
    grown (to the next odd prime above numSigs + max(17, numSigs >> 12))
    only while the corpus signatures by themselves would reach the last
    slot. It depends on the configuration alone, never on the seed."""
    num = next_odd_prime(max(int(total / load) + 1, total + 2, 11))
    while True:
        home = np.sort(corpus_kmers % num)
        step = np.arange(len(home), dtype=np.int64)
        if not len(home) or \
                (np.maximum.accumulate(home - step) + step)[-1] < num - 1:
            return num
        num = next_odd_prime(num + max(17, num >> 12))


def seeded_table(data_dir: str, cfg: dict, seed: int) -> int:
    """The configuration's table from ``seed``; returns numSigs, the same
    for every seed (``fixed_num_sigs``).

    The filler's values home below numSigs - TAIL, so that one placement
    always fits: a chain reaches the last slot only through a run of TAIL
    occupied slots, which at load 0.6 has odds far below 1e-100 (and the
    builder raises if it ever did). One sort places the table: each
    signature's key is (home << 36) | (value << 1) | is_filler, so the
    sorted keys are the placement order, a filler value that repeats a
    corpus value or another filler value sits right after it and is
    dropped, and the corpus signatures come in the order of their own
    keys. The filler's attributes are drawn in that order."""
    t = cfg["table"]
    sig = corpus_signatures(proteome()[:t.get("corpus_proteins")])
    total, corpus_n = t["total_signatures"], len(sig["kmers"])
    need = total - corpus_n
    num = fixed_num_sigs(sig["kmers"], total, t["load_factor"])
    rng = np.random.default_rng([seed, 0x7AB1E])
    # the corpus signatures' weights too are drawn, in (0, 1]: sums of
    # fractional float32 weights are what the report's %f shows
    sig["wt"] = (1 - rng.random(corpus_n, dtype=np.float32)).astype(
        np.float32)
    draw = rng.integers(0, MAX_ENCODED, int(need * 1.02) + 1000,
                        dtype=np.int64)
    draw = draw[draw % num < num - TAIL]
    values = np.concatenate([sig["kmers"], draw])
    filler = np.concatenate([np.zeros(corpus_n, np.int64),
                             np.ones(len(draw), np.int64)])
    keys = ((values % num) << 36) | (values << 1) | filler
    keys.sort()
    same = np.zeros(len(keys), dtype=bool)
    same[1:] = (keys[1:] >> 1) == (keys[:-1] >> 1)
    keys = keys[~same]
    at = np.nonzero(keys & 1)[0]
    if len(at) < need:
        raise RuntimeError("filler draw came up short")
    drop = np.zeros(len(keys), dtype=bool)
    drop[at[rng.choice(len(at), len(at) - need, replace=False)]] = True
    keys = keys[~drop]
    home = keys >> 36
    step = np.arange(total, dtype=np.int64)
    pos = np.maximum.accumulate(home - step) + step
    if pos[-1] >= num - 1:
        raise RuntimeError("a chain reached the table's last slot")
    is_filler = (keys & 1).astype(bool)
    m = int(is_filler.sum())
    corpus_home = sig["kmers"] % num
    corpus_order = np.lexsort((sig["kmers"], corpus_home))
    draws = dict(otu=rng.integers(0, t["otus"], m).astype(np.int32),
                 avg_from_end=rng.integers(0, 500, m).astype(np.int32),
                 fi=rng.integers(0, t["functions"], m).astype(np.int32),
                 wt=rng.random(m, dtype=np.float32))
    placed = {"kmers": (keys >> 1) & ((1 << 35) - 1)}
    for key, got in draws.items():
        col = np.empty(total, dtype=got.dtype)
        col[is_filler] = got
        col[~is_filler] = sig[key][corpus_order]
        placed[key] = col
    write_slots(data_dir, num, pos, placed, function_names(t["functions"]))
    return num
