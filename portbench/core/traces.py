"""Reduction of torch.profiler traces (Chrome trace JSON) to the numbers
the per-layer metrics read.

- Busy time: the union of kernel, copy and memset intervals inside the
  traced window; the window is the harness's own ``portbench.traced`` span
  where the trace holds it, else the extent of the trace's events.
- Kernel time: the sum of kernel intervals (copies and memsets left out)
  inside the window.
- Lost records: the wrappers' launch counters (files in
  ``portbench/counters``) say how many launches of each kernel the traced
  work made; a trace that holds fewer records of that kernel lost them,
  and is never read for an idle share or a roofline.
- Breakdown: the device operations by total time, and the longest idle
  gaps, each named by the innermost harness span around it and the CPU op
  that overlaps it most.
"""
from __future__ import annotations

import glob
import importlib
import json
import os
from typing import Dict, List, Optional, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "portbench.traced"
SPAN_PREFIX = "portbench."
COUNTERS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "counters")


class LostRecords(RuntimeError):
    pass


def launch_counters() -> List[dict]:
    """The kernel launch counters the harness can read: one file each,
    ``{"module": ..., "attribute": ..., "kernel": <name marker>}``."""
    out = []
    for path in sorted(glob.glob(os.path.join(COUNTERS, "*.json"))):
        with open(path) as fh:
            out.append(json.load(fh))
    return out


def read_counters() -> Dict[str, int]:
    """Each counter's value now, by kernel marker (absent modules read 0)."""
    got = {}
    for c in launch_counters():
        try:
            mod = importlib.import_module(c["module"])
        except ImportError:
            got[c["kernel"]] = 0
            continue
        got[c["kernel"]] = int(getattr(mod, c["attribute"], 0))
    return got


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _clip(s, e, lo, hi):
    return max(s, lo), min(e, hi)


def summarize(path: str, launches: Optional[Dict[str, int]] = None) -> dict:
    """The trace at ``path`` reduced: window_s, busy_s, kernel_s,
    kernel counts by marker, and the breakdown. ``launches`` (kernel
    marker -> launches the traced work made) checks for lost records."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    window = [e for e in events if e.get("name") == WINDOW_SPAN
              and e.get("cat") == "user_annotation"]
    if window:
        lo = float(window[0]["ts"])
        hi = lo + float(window[0]["dur"])
    else:
        lo = min(float(e["ts"]) for e in events)
        hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
    device, kernel_us, by_name = [], 0.0, {}
    counts = {k: 0 for k in (launches or {})}
    for e in events:
        if e.get("cat") not in DEVICE_KINDS:
            continue
        s, t = _clip(float(e["ts"]), float(e["ts"]) + float(e["dur"]), lo,
                     hi)
        name = e.get("name", "")
        for k in counts:
            if k in name and e.get("cat") == "kernel":
                counts[k] += 1
        if t <= s:
            continue
        device.append((s, t))
        if e.get("cat") == "kernel":
            kernel_us += t - s
        short = name[:96]
        by_name[short] = by_name.get(short, 0.0) + (t - s) / 1e6
    lost = {k: (counts[k], n) for k, n in (launches or {}).items()
            if counts[k] < n}
    if lost:
        raise LostRecords(f"trace holds fewer kernel records than launches "
                          f"(marker: (records, launches)): {lost}")
    busy = _union(device)
    busy_us = sum(t - s for s, t in busy)
    gaps, at = [], lo
    for s, t in busy + [(hi, hi)]:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(SPAN_PREFIX)
             and e.get("name") != WINDOW_SPAN]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_gap_label(g, spans, ops), (g[1] - g[0]) / 1e6]
            for g in gaps[:10]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=(hi - lo) / 1e6, busy_s=busy_us / 1e6,
                kernel_s=kernel_us / 1e6, kernel_records=counts,
                device_ops=[[k, v] for k, v in top], idle_gaps=idle)


def _gap_label(gap, spans, ops) -> str:
    s, t = gap
    mid = (s + t) / 2
    inner = [e for e in spans if float(e["ts"]) <= mid
             <= float(e["ts"]) + float(e["dur"])]
    span = min(inner, key=lambda e: float(e["dur"]))["name"] if inner \
        else "(no harness span)"
    best, best_overlap = "(no CPU op)", 0.0
    for e in ops:
        a, b = _clip(float(e["ts"]), float(e["ts"]) + float(e["dur"]), s, t)
        if b - a > best_overlap:
            best, best_overlap = e.get("name", ""), b - a
    return f"{span} | {best}"


def merge(summaries: List[dict]) -> dict:
    """Several traces (one a job) as one: times add up, breakdowns merge."""
    out = dict(window_s=0.0, busy_s=0.0, kernel_s=0.0)
    ops: Dict[str, float] = {}
    gaps: List[list] = []
    for s in summaries:
        for k in out:
            out[k] += s[k]
        for name, v in s["device_ops"]:
            ops[name] = ops.get(name, 0.0) + v
        gaps.extend(s["idle_gaps"])
    out["device_ops"] = [[k, v] for k, v in
                         sorted(ops.items(), key=lambda kv: -kv[1])[:10]]
    out["idle_gaps"] = sorted(gaps, key=lambda g: -g[1])[:10]
    return out
