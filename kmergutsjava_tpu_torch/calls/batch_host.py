"""Global batch evaluation of the single-function grouping fast path.

For containers whose hits all share one function index (and with the
default non-debug, no-order-constraint, min_hits >= 2 configuration), the
state machine reduces to gap segmentation (see gather_hits_arrays). This
module evaluates ALL such containers in one vectorized pass over the
globally (container, position)-sorted hit arrays: per-container numpy
overhead disappears, and python work remains only per qualifying segment
(i.e. per emitted CALL), where the float32 weight must be accumulated
sequentially (np.cumsum per segment — np.add.reduceat is pairwise and
would drift).

Output per container: (call_lines, otu_updates) in emission order, the same
contract as calls/scan_machine.gather_hits_scan_batch.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..constants import K
from ..utils.javafmt import jformat
from .grouping import GroupingParams


def batch_single_fi_calls(
    cnt_s: np.ndarray,  # [N] container ids, sorted (primary key)
    pos_s: np.ndarray,  # [N] positions, sorted within container
    otu_s: np.ndarray,
    fi_s: np.ndarray,
    wt_s: np.ndarray,  # float32
    eligible_lookup: np.ndarray,  # bool, indexed by container id
    functions: Sequence[str],
    p: GroupingParams,
) -> Dict[int, Tuple[List[str], List[Tuple[int, int]]]]:
    """Returns {cid: (lines, otu_updates)} for every eligible container that
    has hits (hitless eligible containers are trivially empty)."""
    results: Dict[int, Tuple[List[str], List[Tuple[int, int]]]] = {}
    if len(cnt_s) == 0:
        return results
    keep = eligible_lookup[cnt_s]
    cnt = cnt_s[keep]
    pos = pos_s[keep]
    otu = otu_s[keep]
    fi = fi_s[keep]
    wt = wt_s[keep].astype(np.float32)
    n = len(cnt)
    if n == 0:
        return results
    for c in np.unique(cnt).tolist():
        results[int(c)] = ([], [])
    # oversized containers fall back to the exact machine elsewhere; they
    # are excluded by the caller (hit-cap interactions)
    new_run = np.empty(n, dtype=bool)
    new_run[0] = True
    new_run[1:] = (cnt[1:] != cnt[:-1]) | ((pos[1:] - pos[:-1]) > p.max_gap)
    seg_start = np.nonzero(new_run)[0]
    seg_end = np.append(seg_start[1:], n)
    seg_len = seg_end - seg_start
    qualify = seg_len >= p.min_hits
    min_w = p.min_weighted_hits
    for a, b in zip(seg_start[qualify].tolist(), seg_end[qualify].tolist()):
        weighted = np.cumsum(wt[a:b], dtype=np.float32)[-1]
        if weighted >= min_w:
            cid = int(cnt[a])
            f0 = int(fi[a])
            lines, updates = results[cid]
            lines.append("CALL\t%d\t%d\t%d\t%d\t%s\t%s" % (
                int(pos[a]), int(pos[b - 1]) + (K - 1), b - a, f0,
                functions[f0], jformat(weighted)))
            o = otu[a:b]
            inner = np.nonzero(np.diff(o))[0] + 1
            starts = np.concatenate([[0], inner, [b - a]])
            for x, y in zip(starts[:-1].tolist(), starts[1:].tolist()):
                updates.append((int(o[x]), int(y - x)))
    return results
