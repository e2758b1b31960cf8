"""Calls from the hits of one container, and the OTU counter
(gatherHits KmerGutsJava.java:457-514, processSetOfHits :385-455,
tabulateOtuDataForContig :516-524).

A hit is (pos, otu, avg_from_end, function, weight). In position order:
a gap over ``max_gap`` closes the run (processed when it holds at least
``min_hits`` hits, else dropped); the first hit of a run sets the current
function; a hit is appended while the run holds fewer than 39,998; two
consecutive hits of one function other than the current one process the
run at once. Processing counts the run's hits of the current function and
sums their weights in position order in float32; at ``min_hits`` and
``min_weighted_hits`` it prints a CALL and adds those hits' OTUs to the
top-5 counter (found: add; else append, or overwrite the last of five;
then bubble up past every entry whose count is at most the new one). If
the run's last two hits share a function other than the current one, they
seed the next run and their function becomes current.

``precision="bfloat16"`` rounds each weight and each partial sum to
bfloat16: the control of the benchmark's comparison, not the reference.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

import numpy as np

from .javafmt import jformat

K = 8
MAX_HITS = 40000
OTU_SLOTS = 5


class Params(NamedTuple):
    min_hits: int = 5
    min_weighted_hits: int = 0
    max_gap: int = 200
    order_constraint: bool = False


def _bf16(x: float) -> float:
    """The nearest bfloat16 (8 significant bits, ties to even)."""
    if x == 0.0:
        return 0.0
    m, e = math.frexp(x)
    return math.ldexp(round(m * 256.0), e - 8)


def weight_sum(weights, precision: str) -> np.float32:
    """The weights' sum in position order: in float32, or for the control
    in bfloat16 (each weight and each partial sum rounded to it)."""
    w = np.asarray(weights, dtype=np.float32)
    if precision == "float32":
        return np.cumsum(w, dtype=np.float32)[-1] if len(w) else \
            np.float32(0)
    if precision != "bfloat16":
        raise ValueError(precision)
    s = 0.0
    for x in w.tolist():
        s = _bf16(s + _bf16(x))
    return np.float32(s)


def otu_add(counts: List[List[int]], oi: int, inc: int) -> None:
    """``inc`` hits of OTU ``oi`` at once: no entry can leave within a run
    of equal OTUs, and one bubble pass past every entry whose count is at
    most the new one ends where ``inc`` single passes would."""
    j = 0
    while j < len(counts) and counts[j][0] != oi:
        j += 1
    if j == len(counts):
        if len(counts) == OTU_SLOTS:
            j -= 1
        else:
            counts.append([0, 0])
        counts[j] = [oi, inc]
    else:
        counts[j][1] += inc
    while j > 0 and counts[j - 1][1] <= counts[j][1]:
        counts[j - 1], counts[j] = counts[j], counts[j - 1]
        j -= 1


def _fold_otus(counts, otus) -> None:
    run_oi, run = otus[0], 0
    for o in otus:
        if o == run_oi:
            run += 1
        else:
            otu_add(counts, run_oi, run)
            run_oi, run = o, 1
    otu_add(counts, run_oi, run)


def _process(hits: list, current: int, functions: Sequence[str], counts,
             out: list, p: Params, precision: str) -> int:
    cur = [h for h in hits if h[3] == current]
    weighted = weight_sum([h[4] for h in cur], precision) \
        if len(cur) >= p.min_hits else np.float32(0)
    if len(cur) >= p.min_hits and weighted >= p.min_weighted_hits:
        end = cur[-1] if cur else hits[0]
        out.append("CALL\t%d\t%d\t%d\t%d\t%s\t%s" % (
            hits[0][0], end[0] + K - 1, len(cur), current,
            functions[current], jformat(weighted)))
        if cur:
            _fold_otus(counts, [h[1] for h in cur])
    if len(hits) < 2:
        raise IndexError("processSetOfHits with fewer than 2 hits")
    if hits[-2][3] != current and hits[-2][3] == hits[-1][3]:
        current = hits[-1][3]
        hits[:] = hits[-2:]
    else:
        hits.clear()
    return current


def calls(pos, otu, avg, fi, wt, functions: Sequence[str], counts,
          out: list, p: Params, precision: str = "float32") -> None:
    """Append one container's CALL lines to ``out``; ``pos`` ... ``wt``
    are its hits in any order."""
    n = len(pos)
    if n < p.min_hits:
        return
    order = np.argsort(pos, kind="stable")
    pos, otu, avg, fi, wt = (np.asarray(a)[order]
                             for a in (pos, otu, avg, fi, wt))
    if (not p.order_constraint and p.min_hits >= 2
            and bool((fi == fi[0]).all())):
        # one function: the machine never triggers mid-run and never seeds,
        # so each gap-delimited segment of at least min_hits hits is one
        # processed run
        cut = [0, *(np.nonzero(np.diff(pos) > p.max_gap)[0] + 1).tolist(), n]
        if all(b - a < MAX_HITS - 2 for a, b in zip(cut, cut[1:])):
            f = int(fi[0])
            for a, b in zip(cut, cut[1:]):
                if b - a < p.min_hits:
                    continue
                weighted = weight_sum(wt[a:b], precision)
                if weighted >= p.min_weighted_hits:
                    out.append("CALL\t%d\t%d\t%d\t%d\t%s\t%s" % (
                        int(pos[a]), int(pos[b - 1]) + K - 1, b - a, f,
                        functions[f], jformat(weighted)))
                    _fold_otus(counts, otu[a:b].tolist())
            return
    hits: list = []
    current = 0
    last = None
    for h in zip(pos.tolist(), otu.tolist(), avg.tolist(), fi.tolist(),
                 wt.astype(np.float32).tolist()):
        if last is not None and last[0] + p.max_gap < h[0]:
            if len(hits) >= p.min_hits:
                current = _process(hits, current, functions, counts, out, p,
                                   precision)
            else:
                hits.clear()
            last = hits[-1] if hits else None
        if last is None:
            current = h[3]
        if (not p.order_constraint or last is None
                or (h[3] == last[3]
                    and abs((h[0] - last[0]) - (last[2] - h[2])) <= 20)):
            if len(hits) < MAX_HITS - 2:
                hits.append(h)
                last = h
            if current != h[3] and len(hits) > 1 \
                    and hits[-2][3] == hits[-1][3]:
                current = _process(hits, current, functions, counts, out, p,
                                   precision)
                last = hits[-1] if hits else None
    if len(hits) >= p.min_hits:
        _process(hits, current, functions, counts, out, p, precision)


def otu_line(qid: str, length: int, counts) -> str:
    return "OTU-COUNTS\t%s[%d]" % (qid, length) + "".join(
        "\t%d-%d" % (c, o) for o, c in counts)
