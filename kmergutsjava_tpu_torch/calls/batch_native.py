"""Batch grouping through the native core (native/grouping.cpp).

One ctypes call runs the exact CALL/OTU state machine over every container
in the batch; Python only formats the CALL text (Java HALF_UP "%f" via
utils/javafmt) and later folds the returned RLE OTU increments into the
per-sequence top-5 move-to-front counter. Same ("pre", lines, updates)
result shape as calls/batch_host.batch_single_fi_calls, pinned to the
Python machine by the differential tests in tests/test_batch_native.py.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..utils.javafmt import jformat
from ..utils.native import load_grouping
from .grouping import GroupingParams


def native_available() -> bool:
    return load_grouping() is not None


def _sorted_unique(cnt_s: np.ndarray):
    """(uniq, starts) of an ALREADY-SORTED container column. np.unique
    re-sorts (O(n log n) — ~7s on a 66M-hit metagenome); boundary
    detection on the sorted column is one O(n) pass."""
    n = len(cnt_s)
    if n == 0:
        return cnt_s[:0], np.zeros(0, dtype=np.int64)
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(cnt_s[1:], cnt_s[:-1], out=change[1:])
    starts = np.nonzero(change)[0]
    return cnt_s[starts], starts


def _run_machine(lib, cnt_s: np.ndarray, pos_s: np.ndarray, otu_s: np.ndarray,
                 avg_s: np.ndarray, fi_s: np.ndarray, wt_s: np.ndarray,
                 todo: np.ndarray, bounds: Sequence[int], p: GroupingParams):
    """Gather the selected containers into one contiguous batch and run the
    native state machine. ``cnt_s``..``wt_s`` are the (cnt_id, pos)-sorted
    global hit columns; ``bounds[k]..bounds[k+1]`` delimits the k-th
    distinct container and ``todo`` lists the k indices to process.

    Returns (cnt_of_batch, n_calls, call_container, call_start, call_end,
    call_count, call_fi, call_weight, call_nupd, upd_oi, upd_inc) — the
    raw columnar machine output, calls grouped by nondecreasing batch
    container index.
    """
    # gather the selected containers into one contiguous batch
    todo = np.asarray(todo, dtype=np.int64)
    bounds = np.asarray(bounds, dtype=np.int64)
    starts = bounds[todo]
    ends = bounds[todo + 1]
    lens = ends - starts
    if (lens == 0).any():  # the jump-correction trick needs lens >= 1
        keep = lens > 0
        todo, starts, ends, lens = todo[keep], starts[keep], ends[keep], \
            lens[keep]
    b_bounds = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    n_containers = len(todo)
    total = int(b_bounds[-1])
    if np.array_equal(starts[1:], ends[:-1]):
        # contiguous selection (the common every-container case): slice
        sl = slice(int(starts[0]) if n_containers else 0,
                   int(ends[-1]) if n_containers else 0)
        idx = None
    else:
        # vectorized multi-range arange: unit steps with jump corrections
        idx = np.ones(total, dtype=np.int64)
        if total:
            off = b_bounds[:-1]
            idx[0] = starts[0]
            nz = off[1:]
            idx[nz] = starts[1:] - (ends[:-1] - 1)
        idx = np.cumsum(idx)
        sl = idx
    pos_b = np.ascontiguousarray(pos_s[sl], dtype=np.int64)
    otu_b = np.ascontiguousarray(otu_s[sl], dtype=np.int32)
    avg_b = np.ascontiguousarray(avg_s[sl], dtype=np.int32)
    fi_b = np.ascontiguousarray(fi_s[sl], dtype=np.int32)
    wt_b = np.ascontiguousarray(wt_s[sl], dtype=np.float32)

    max_calls = total + n_containers + 1
    max_upds = 2 * total + 2
    call_container = np.empty(max_calls, np.int64)
    call_start = np.empty(max_calls, np.int64)
    call_end = np.empty(max_calls, np.int64)
    call_count = np.empty(max_calls, np.int32)
    call_fi = np.empty(max_calls, np.int32)
    call_weight = np.empty(max_calls, np.float32)
    call_nupd = np.empty(max_calls, np.int32)
    upd_oi = np.empty(max_upds, np.int32)
    upd_inc = np.empty(max_upds, np.int32)

    n_calls = lib.group_batch(
        pos_b, otu_b, avg_b, fi_b, wt_b, b_bounds, n_containers,
        p.min_hits, p.min_weighted_hits, p.max_gap,
        1 if p.order_constraint else 0,
        call_container, call_start, call_end, call_count, call_fi,
        call_weight, call_nupd, upd_oi, upd_inc, max_calls, max_upds)
    if n_calls == -2:
        raise IndexError(
            "processSetOfHits with <2 hits (the reference throws here too; "
            "use minHits >= 2)")
    if n_calls < 0:
        raise RuntimeError("native grouping output overflow")
    cnt_of_batch = cnt_s[starts].astype(np.int64)
    return (cnt_of_batch, int(n_calls), call_container, call_start, call_end,
            call_count, call_fi, call_weight, call_nupd, upd_oi, upd_inc)


def batch_group_calls(cnt_s: np.ndarray, pos_s: np.ndarray, otu_s: np.ndarray,
                      avg_s: np.ndarray, fi_s: np.ndarray, wt_s: np.ndarray,
                      todo: np.ndarray, bounds: Sequence[int],
                      functions: Sequence[str],
                      p: GroupingParams) -> Dict[int, tuple]:
    """Run the native machine over the selected containers. Returns
    {cnt_id: ("pre", call_lines, otu_updates)} for every selected container.
    """
    lib = load_grouping()
    if lib is None:
        raise RuntimeError("native grouping library unavailable")
    if not len(todo):
        return {}
    (cnt_of_batch, n_calls, call_container, call_start, call_end, call_count,
     call_fi, call_weight, call_nupd, upd_oi, upd_inc) = _run_machine(
        lib, cnt_s, pos_s, otu_s, avg_s, fi_s, wt_s, todo, bounds, p)
    out: Dict[int, tuple] = {}
    cnt_list = cnt_of_batch.tolist()
    for cid in cnt_list:
        out[cid] = ("pre", [], [])
    u = 0
    for i in range(n_calls):
        cid = cnt_list[int(call_container[i])]
        f = int(call_fi[i])
        out[cid][1].append("CALL\t%d\t%d\t%d\t%d\t%s\t%s" % (
            int(call_start[i]), int(call_end[i]), int(call_count[i]), f,
            functions[f], jformat(call_weight[i])))
        nu = int(call_nupd[i])
        out[cid][2].extend(
            (int(upd_oi[u + j]), int(upd_inc[u + j])) for j in range(nu))
        u += nu
    return out


def try_native_report(prep, hits, functions: Sequence[str], aa: bool,
                      report, p: GroupingParams) -> bool:
    """Render the WHOLE non-debug grouping phase natively: one global
    (container, position) sort, one group_batch call, one emit_report call
    (native/grouping.cpp) producing the complete report
    text — no per-sequence Python. Byte-identical to the process_aa_seq /
    process_dna_seq path (pinned by tests/test_grouping_fastpath.py and the
    corpus tests); returns False when the native library is unavailable so
    the caller falls back.

    Caller contract (checked in models/pipeline.py): not debug,
    min_hits >= 2, grouping_impl == "host".
    """
    lib = load_grouping()
    if lib is None:
        return False
    frames = 1 if aa else 6
    items = list(prep.id_len.items())
    n_seq = len(items)
    n_cont = prep.num_containers()  # no key-list synthesis on the fast path
    # container ids per sequence in emission order ((+,-)x(0,1,2));
    # prepare assigns cids densely in exactly that order, so the identity
    # map applies unless duplicate FASTA ids re-registered a sequence
    # (then the LAST container wins per key, ref :805-809)
    if n_cont == n_seq * frames:
        seq_cids = np.arange(n_cont, dtype=np.int64)
    else:
        key_to_cnt = {key: cid for cid, key in enumerate(prep.containers)}
        strands_frames = ([("+", 0)] if aa else
                          [(s, f) for s in ("+", "-") for f in range(3)])
        seq_cids = np.fromiter(
            (key_to_cnt[(qid, s, f)] for qid, _ in items
             for s, f in strands_frames),
            dtype=np.int64, count=n_seq * frames)

    # one global (container, position) sort; the stream path's fused decode
    # emits hits in feed order, which IS this order — detect and skip
    c, p_ = hits.cnt_id, hits.pos
    presorted = len(c) == 0 or bool(np.all(
        (c[1:] > c[:-1]) | ((c[1:] == c[:-1]) & (p_[1:] >= p_[:-1]))))
    if presorted:
        cnt_s, pos_s, otu_s = hits.cnt_id, hits.pos, hits.otu
        avg_s, fi_s = hits.avg_from_end, hits.fi
        wt_s = hits.wt.astype(np.float32)
    else:
        order = np.lexsort((hits.pos, hits.cnt_id))
        cnt_s, pos_s, otu_s = c[order], p_[order], hits.otu[order]
        avg_s, fi_s = hits.avg_from_end[order], hits.fi[order]
        wt_s = hits.wt[order].astype(np.float32)
    uniq, starts = _sorted_unique(cnt_s)
    bounds = np.append(starts, len(cnt_s))
    winning = np.zeros(n_cont, dtype=bool)
    winning[seq_cids] = True
    todo = np.nonzero(winning[uniq])[0].astype(np.int64)

    if len(todo):
        (cnt_of_batch, n_calls, call_container, call_start, call_end,
         call_count, call_fi, call_weight, call_nupd, upd_oi,
         upd_inc) = _run_machine(lib, cnt_s, pos_s, otu_s, avg_s, fi_s, wt_s,
                                 todo, bounds, p)
    else:
        cnt_of_batch = np.zeros(0, np.int64)
        n_calls = 0
        call_container = call_start = call_end = np.zeros(0, np.int64)
        call_count = call_fi = call_nupd = np.zeros(0, np.int32)
        call_weight = np.zeros(0, np.float32)
        upd_oi = upd_inc = np.zeros(0, np.int32)
    n_batch = len(cnt_of_batch)
    call_off = np.searchsorted(
        call_container[:n_calls], np.arange(n_batch + 1)).astype(np.int64)
    upd_base = np.concatenate(
        [[0], np.cumsum(call_nupd[:n_calls], dtype=np.int64)])
    batch_of_cid = np.full(n_cont, -1, dtype=np.int64)
    batch_of_cid[cnt_of_batch] = np.arange(n_batch, dtype=np.int64)
    seq_batch = np.ascontiguousarray(batch_of_cid[seq_cids])

    id_bytes = [qid.encode("utf-8") for qid, _ in items]
    ids_off = np.zeros(n_seq + 1, dtype=np.int64)
    np.cumsum([len(b) for b in id_bytes], out=ids_off[1:])
    ids_blob = np.frombuffer(b"".join(id_bytes), dtype=np.uint8)
    seq_len = np.fromiter((ln for _, ln in items), dtype=np.int64,
                          count=n_seq)
    fn_bytes = [f.encode("utf-8") for f in functions]
    fn_off = np.zeros(len(fn_bytes) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in fn_bytes], out=fn_off[1:])
    fn_blob = np.frombuffer(b"".join(fn_bytes), dtype=np.uint8)

    # capacity: mirrors emit_report's per-line headroom checks
    fn_max = int((fn_off[1:] - fn_off[:-1]).max()) if len(fn_bytes) else 0
    cap = (int(ids_off[-1]) * (frames + 2)
           + n_seq * ((frames + 2) * 64 + 5 * 48)
           + n_calls * (fn_max + 192) + 64)
    buf = np.empty(cap, dtype=np.uint8)
    n = lib.emit_report(
        np.ascontiguousarray(ids_blob), ids_off, seq_len, n_seq, frames,
        seq_batch, call_off,
        np.ascontiguousarray(call_start[:n_calls]),
        np.ascontiguousarray(call_end[:n_calls]),
        np.ascontiguousarray(call_count[:n_calls]),
        np.ascontiguousarray(call_fi[:n_calls]),
        np.ascontiguousarray(call_weight[:n_calls]),
        upd_base, upd_oi, upd_inc,
        np.ascontiguousarray(fn_blob), fn_off, buf, cap)
    if n < 0:
        return False
    report.print(buf[:n].tobytes().decode("utf-8"))
    report.flush()
    return True
