"""Lookup progress lines and an optional torch.profiler trace (host and
CUDA activity) around a run, beside the reference's wall-clock phase lines
(ref KmerGutsJava.java:794,:803,:819), which the engine prints itself.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional


class ProgressReporter:
    """Emits 'Processed: N%, time=T ms., found-so-far=K' lines per decile,
    mirroring the reference's lookup progress (ref :1019-1025)."""

    def __init__(self, total: int, emit: Callable[[str], None]):
        self.total = max(total, 1)
        self.emit = emit
        self.fraction = 0
        self.found = 0
        self._start = time.time()

    def update(self, done: int, found_delta: int) -> None:
        self.found += found_delta
        new_fraction = int(10.0 * done / self.total)
        if new_fraction != self.fraction:
            self.fraction = new_fraction
            self.emit("Processed: %d%%, time=%d ms., found-so-far=%d"
                      % (self.fraction * 10,
                         int((time.time() - self._start) * 1000), self.found))


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """torch.profiler trace context when a directory is given, else no-op.
    The trace is written as ``trace.json`` (Chrome trace format) in
    ``trace_dir``."""
    if not trace_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
