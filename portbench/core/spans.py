"""Reads the port's own span log (``kmergutsjava_tpu_torch.utils.timing``
``recent_runs()``) for jobs that ran in the harness's process: the run
records whose start lies inside the measured window, so warm-up and
traced jobs are left out. A program without the log reads None, and so
does a window that holds no job with the span."""
from __future__ import annotations

from statistics import fmean
from typing import List, Optional

ROOT_SPAN = "cli.main"


def window_runs(run) -> List[dict]:
    """The window's records of CLI calls, oldest first."""
    try:
        from kmergutsjava_tpu_torch.utils import timing
    except ImportError:
        return []
    recent = getattr(timing, "recent_runs", None)
    if recent is None:
        return []
    lo, hi = run.window
    return [r for r in recent()
            if r.get("root") == ROOT_SPAN and lo <= r["start"] <= hi]


def span_mean_ms(run, name: str) -> Optional[float]:
    """The span's total a window job, mean over the window's jobs (0 for a
    job without it), in ms."""
    runs = window_runs(run)
    if not any(name in r["spans"] for r in runs):
        return None
    return fmean(r["spans"].get(name, {"ns": 0})["ns"] for r in runs) / 1e6


def unspanned_mean_ms(run) -> Optional[float]:
    """A job's ``cli.main`` less the spans directly under it on the main
    thread, mean over the window's jobs, in ms."""
    got = [r["spans"][ROOT_SPAN]["ns"] - r["under_root_ns"]
           for r in window_runs(run) if ROOT_SPAN in r["spans"]]
    return fmean(got) / 1e6 if got else None
