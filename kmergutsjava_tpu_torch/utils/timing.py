"""Profiling hook: an optional torch.profiler trace (host and CUDA
activity) around a run, beside the reference's wall-clock phase lines
(ref KmerGutsJava.java:794,:803,:819), which the engine prints itself.
"""
from __future__ import annotations

import contextlib
from typing import Optional


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
