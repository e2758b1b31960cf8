"""Hit grouping, CALL emission, and OTU accounting.

Faithful re-expression of the reference's sequential state machine:
gatherHits (KmerGutsJava.java:457-514),
processSetOfHits (:385-455), tabulateOtuDataForContig (:516-524), and the
per-sequence drivers processAASeq (:526-536) / processSeq (:538-558).

Semantics preserved exactly, including the non-obvious ones:

- a gap > maxGap closes the current run, but processSetOfHits may leave a
  trailing same-function pair in the list as the seed of the next run — so
  a seed pair can survive across a gap and a CALL's start coordinate can be
  a pre-gap seed position (ref :441-450);
- two consecutive hits sharing a *new* function index trigger mid-run
  processing (ref :503-508);
- hit weights accumulate in float32 in position order and are formatted with
  Java's HALF_UP "%f" (see utils/javafmt);
- the OTU counter is a capped top-5 move-to-front list whose bubble pass
  swaps on <= (ref :432-437) and overwrites the last entry when full
  (ref :419-421);
- the reference crashes (IndexOutOfBounds) when processSetOfHits sees fewer
  than 2 hits, which can only happen with minHits < 2; we raise the same way.

Hits are 5-tuples (from0_in_prot, oI, avg_off_from_end, fI, functionWt) with
functionWt an np.float32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, TextIO

import numpy as np

from ..constants import K, MAX_HITS_PER_SEQ, OI_BUFSZ
from ..utils.javafmt import jformat


@dataclass
class GroupingParams:
    min_hits: int = 5
    min_weighted_hits: int = 0
    max_gap: int = 200
    order_constraint: bool = False
    debug: bool = False


class Report:
    """Line-oriented report writer (Java PrintWriter with '\\n' separators)."""

    def __init__(self, stream: TextIO):
        self.stream = stream

    def print(self, text: str) -> None:
        self.stream.write(text)

    def println(self, text: str = "") -> None:
        self.stream.write(text)
        self.stream.write("\n")

    def flush(self) -> None:
        self.stream.flush()


def display_hits(hits, out: Report) -> None:
    """Debug dump (ref displayHits :375-383)."""
    parts = ["hits: "]
    for h in hits:
        parts.append("%d/%s/%d " % (h[0], jformat(h[4]), h[3]))
    out.println("".join(parts))


def process_set_of_hits(hits: List[tuple], functions: Sequence[str], current_fi: int,
                        oi_counts: List[List[int]], out: Report,
                        p: GroupingParams) -> int:
    """ref processSetOfHits :385-455. Mutates ``hits`` and ``oi_counts``.

    The per-hit loops of the reference reduce to: the counted set is
    exactly the currentFI hits in list order (the last of them IS the
    reference's lastHit bound), the weight is their sequential float32 sum
    (np.cumsum in f32 is sequential), and the OTU fold batches per run of
    equal consecutive oIs (exactness argument at _otu_add_batch).
    """
    cur = [h for h in hits if h[3] == current_fi]
    fi_count = len(cur)
    if fi_count >= p.min_hits:
        weighted = (np.cumsum(
            np.fromiter((h[4] for h in cur), dtype=np.float32,
                        count=fi_count), dtype=np.float32)[-1]
            if fi_count else np.float32(0.0))
    else:
        weighted = np.float32(0.0)
    if fi_count >= p.min_hits and weighted >= p.min_weighted_hits:
        # fi_count == 0 only with min_hits <= 0; the reference's lastHit
        # then stays 0 and the CALL anchors on hits[0] (ref :389, :401)
        end_hit = cur[-1] if cur else hits[0]
        out.println("CALL\t%d\t%d\t%d\t%d\t%s\t%s" % (
            hits[0][0], end_hit[0] + (K - 1), fi_count, current_fi,
            functions[current_fi], jformat(weighted)))
        if p.debug:
            out.print("after-call: ")
            display_hits(hits, out)
        # fold the called hits into the top-5 OTU counter (ref :411-439),
        # batched per run of equal consecutive oIs
        if cur:
            run_oi = cur[0][1]
            run_len = 0
            for h in cur:
                if h[1] == run_oi:
                    run_len += 1
                else:
                    _otu_add_batch(oi_counts, run_oi, run_len)
                    run_oi = h[1]
                    run_len = 1
            _otu_add_batch(oi_counts, run_oi, run_len)
    num = len(hits)
    if num < 2:
        raise IndexError(
            "processSetOfHits with <2 hits (the reference throws here too; "
            "use minHits >= 2)")
    if hits[num - 2][3] != current_fi and hits[num - 2][3] == hits[num - 1][3]:
        current_fi = hits[num - 1][3]
        seed = [hits[num - 2], hits[num - 1]]
        hits.clear()
        hits.extend(seed)
    else:
        hits.clear()
    return current_fi


def gather_hits(all_hits: List[tuple], functions: Sequence[str],
                oi_counts: List[List[int]], out: Report, p: GroupingParams) -> None:
    """ref gatherHits :457-514 for one (query, strand, frame) container."""
    all_hits.sort(key=lambda h: h[0])
    hits: List[tuple] = []
    current_fi = 0
    # hot loop: localize lookups
    max_gap = p.max_gap
    min_hits = p.min_hits
    order_constraint = p.order_constraint
    debug = p.debug
    cap = MAX_HITS_PER_SEQ - 2
    append = hits.append
    last = None  # hits[-1] shadow
    for ph in all_hits:
        fi = ph[3]
        if debug:
            out.println("HIT\t%d\t%d\t%d\t%d\t%s\t%d" % (
                ph[0], 0, ph[2], fi, jformat(ph[4], 3), ph[1]))
        if last is not None and last[0] + max_gap < ph[0]:
            if len(hits) >= min_hits:
                current_fi = process_set_of_hits(hits, functions, current_fi,
                                                 oi_counts, out, p)
            else:
                hits.clear()
            last = hits[-1] if hits else None
        if last is None:
            current_fi = fi
        if (not order_constraint) or (last is None) or (
                fi == last[3]
                and abs((ph[0] - last[0]) - (last[2] - ph[2])) <= 20):
            if len(hits) < cap:
                append(ph)
                last = ph
                if debug:
                    out.print("after-hit: ")
                    display_hits(hits, out)
            if current_fi != fi and len(hits) > 1 and hits[-2][3] == hits[-1][3]:
                current_fi = process_set_of_hits(hits, functions, current_fi,
                                                 oi_counts, out, p)
                last = hits[-1] if hits else None
    if len(hits) >= min_hits:
        process_set_of_hits(hits, functions, current_fi, oi_counts, out, p)


def _otu_add_batch(oi_counts: List[List[int]], oi: int, inc: int) -> None:
    """Add ``inc`` occurrences of ``oi`` at once. Exact w.r.t. the per-hit
    loop: within a run of equal oIs no eviction can occur, and bubbling
    after each increment ends at the same place as one bubble past all
    entries with count <= the final count (the <= comparison makes the last
    step pass ties anyway)."""
    j = 0
    while j < len(oi_counts) and oi_counts[j][0] != oi:
        j += 1
    if j == len(oi_counts):
        if len(oi_counts) == OI_BUFSZ:
            j -= 1
        else:
            oi_counts.append([0, 0])
        oi_counts[j][0] = oi
        oi_counts[j][1] = inc
    else:
        oi_counts[j][1] += inc
    while j > 0 and oi_counts[j - 1][1] <= oi_counts[j][1]:
        oi_counts[j - 1], oi_counts[j] = oi_counts[j], oi_counts[j - 1]
        j -= 1


def gather_hits_arrays(pos: np.ndarray, otu: np.ndarray, avg: np.ndarray,
                       fi: np.ndarray, wt: np.ndarray,
                       functions: Sequence[str], oi_counts: List[List[int]],
                       out: Report, p: GroupingParams,
                       presorted: bool = False,
                       single_fi_hint: Optional[bool] = None) -> None:
    """Array-level entry point. Takes the exact state machine's fast path
    when it provably reduces to a single run: one function index, no gaps
    over max_gap, below the hit cap, non-debug. Otherwise falls back to the
    tuple-level machine.

    ``presorted``/``single_fi_hint`` let a caller that already position-
    sorted the hits and computed the one-function flag (e.g. via global
    segmented reductions across all containers) skip per-container work.
    """
    n = len(pos)
    if n == 0:
        return
    if n < p.min_hits and not p.debug:
        # the machine cannot emit anything: every run has < minHits hits of
        # any function, so no CALL and no OTU updates (ref :397, :479, :511)
        return
    if not presorted:
        order = np.argsort(pos, kind="stable")
        pos, otu, avg, fi, wt = (a[order] for a in (pos, otu, avg, fi, wt))
    single_fi = (
        not p.debug
        and not p.order_constraint  # collinearity can reject hits (ref :490)
        and p.min_hits >= 2  # min_hits < 2 hits the reference's crash path
        and (single_fi_hint if single_fi_hint is not None
             else (n < 2 or bool((fi[0] == fi).all())))
    )
    if single_fi:
        # With one function index the machine has no mid-run triggers
        # (currentFI == fI throughout) and no seed carryover (the tail pair
        # always shares currentFI), so it reduces to gap segmentation: each
        # segment of length >= minHits yields one processSetOfHits
        # (ref :477-484 gap close, :511-513 final).
        if n < p.min_hits:
            return
        splits = (np.nonzero(np.diff(pos) > p.max_gap)[0] + 1).tolist()
        bounds = [0] + splits + [n]
        if all(b - a < MAX_HITS_PER_SEQ - 2
               for a, b in zip(bounds[:-1], bounds[1:])):
            wt32 = wt.astype(np.float32)
            f0 = int(fi[0]) if n else 0
            for a, b in zip(bounds[:-1], bounds[1:]):
                length = b - a
                if length < p.min_hits:
                    continue
                weighted = np.cumsum(wt32[a:b], dtype=np.float32)[-1]
                if weighted >= p.min_weighted_hits:
                    out.println("CALL\t%d\t%d\t%d\t%d\t%s\t%s" % (
                        int(pos[a]), int(pos[b - 1]) + (K - 1), length, f0,
                        functions[f0], jformat(weighted)))
                    # OTU updates, batched per run of equal consecutive oIs
                    o = otu[a:b]
                    inner = np.nonzero(np.diff(o))[0] + 1
                    starts = np.concatenate([[0], inner, [length]])
                    for x, y in zip(starts[:-1], starts[1:]):
                        _otu_add_batch(oi_counts, int(o[x]), int(y - x))
            return
    hits = list(zip(pos.tolist(), otu.tolist(), avg.tolist(), fi.tolist(),
                    [np.float32(w) for w in wt.astype(np.float32)]))
    gather_hits(hits, functions, oi_counts, out, p)


def tabulate_otu_data(current_id: str, length: int, oi_counts: List[List[int]],
                      out: Report) -> None:
    """ref tabulateOtuDataForContig :516-524."""
    parts = ["OTU-COUNTS\t%s[%d]" % (current_id, length)]
    for oi, count in oi_counts:
        parts.append("\t%d-%d" % (count, oi))
    out.println("".join(parts))
    oi_counts.clear()


def _gather_dispatch(container, functions, oi_counts, out, p) -> None:
    """Accept a list of hit tuples, a 5-tuple of parallel arrays, a 7-tuple
    with (presorted, single_fi_hint) appended, or a precomputed
    ("pre", call_lines, otu_updates) result from the batch fast path."""
    if isinstance(container, tuple):
        if len(container) == 3 and container[0] == "pre":
            _, lines, updates = container
            for ln in lines:
                out.println(ln)
            for o, inc in updates:
                _otu_add_batch(oi_counts, o, inc)
            return
        if len(container) == 7:
            *arrays, presorted, hint = container
            gather_hits_arrays(*arrays, functions, oi_counts, out, p,
                               presorted=presorted, single_fi_hint=hint)
        else:
            gather_hits_arrays(*container, functions, oi_counts, out, p)
    else:
        gather_hits(container, functions, oi_counts, out, p)


def process_aa_seq(query_id: str, protein_len: int, container_hits: dict,
                   functions: Sequence[str], out: Report, p: GroupingParams) -> None:
    """ref processAASeq :526-536."""
    oi_counts: List[List[int]] = []
    out.println("PROTEIN-ID\t%s\t%d" % (query_id, protein_len))
    _gather_dispatch(container_hits[(query_id, "+", 0)], functions, oi_counts,
                     out, p)
    tabulate_otu_data(query_id, protein_len, oi_counts, out)


def process_dna_seq(query_id: str, contig_len: int, container_hits: dict,
                    functions: Sequence[str], out: Report, p: GroupingParams) -> None:
    """ref processSeq :538-558."""
    oi_counts: List[List[int]] = []
    containers = [container_hits[(query_id, s, f)]
                  for s in ("+", "-") for f in range(3)]
    if all(isinstance(c, tuple) and len(c) == 3 and c[0] == "pre"
           for c in containers):
        # all six frames precomputed: emit the whole block in one write
        parts = ["processing %s[%d]" % (query_id, contig_len)]
        k = 0
        for strand in ("+", "-"):
            for frame in range(3):
                parts.append("TRANSLATION\t%s\t%d\t%s\t%d"
                             % (query_id, contig_len, strand, frame))
                _, lines, updates = containers[k]
                parts.extend(lines)
                for o, inc in updates:
                    _otu_add_batch(oi_counts, o, inc)
                k += 1
        out.println("\n".join(parts))
        tabulate_otu_data(query_id, contig_len, oi_counts, out)
        return
    out.println("processing %s[%d]" % (query_id, contig_len))
    k = 0
    for strand in ("+", "-"):
        for frame in range(3):
            out.println("TRANSLATION\t%s\t%d\t%s\t%d" % (query_id, contig_len,
                                                         strand, frame))
            _gather_dispatch(containers[k], functions, oi_counts, out, p)
            k += 1
    tabulate_otu_data(query_id, contig_len, oi_counts, out)
