"""The port's own timing: spans and counters of each run, lookup progress
lines, and an optional torch.profiler trace (host and CUDA activity) around
a run, beside the reference's wall-clock phase lines (ref
KmerGutsJava.java:794,:803,:819), which the engine prints from its phase
spans.

Spans and counters accumulate into the open run record: one a CLI call
(``cli.main``), one an annotate request of the service
(``service.annotate``), else one an ``Engine.run`` (``engine.run``). A
record holds, by name, each span's calls and total nanoseconds
(``time.perf_counter_ns``) and each counter's sum, and the run's
wall-clock start and end (``time.time()``). Spans of the lookups' worker
threads go into the same record: one run at a time is open in a process
(the service holds its engine lock, the CLI is one process). Finished
records are kept in a bounded log, ``recent_runs()``; a ``--profile`` run
writes its record as ``spans.json`` beside ``trace.json``.

While a torch.profiler is active each span also enters
``torch.profiler.record_function(name)``, so the trace shows it on the
kernels' and copies' timeline. Without one a span costs two clock reads
and one list append; spans go at phase, pass and chunk granularity, never
per record or per k-mer.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

# finished records kept for recent_runs()
LOG_SIZE = 4096

_clock = time.perf_counter_ns
_current: Optional["RunRecord"] = None
_log: "collections.deque[RunRecord]" = collections.deque(maxlen=LOG_SIZE)
# set while maybe_profile traces every thread: a worker thread's own
# profiler state reads off then, though its spans are recorded
_all_threads = False
_profiler_on: Optional[Callable[[], bool]] = None
_record_function = None


class RunRecord:
    """One run's spans and counters. Each thread appends to the record's
    lists (an append holds the interpreter lock: no add is lost, and none
    waits on a lock of its own); the totals are summed when read.
    ``under_root_ns`` sums the spans opened directly under the root span
    on the thread that opened the record: the root less it is the run's
    time that no span names."""

    def __init__(self, root: str):
        self.root = root
        self.start = time.time()
        self.end: Optional[float] = None
        self.thread = threading.get_ident()
        self.depth = 0   # open spans on the opening thread
        self.out_dir: Optional[str] = None   # where spans.json goes
        self._spans: list = []    # (name, ns, directly under the root)
        self._counts: list = []   # (name, n)
        self._totals: Optional[dict] = None  # summed once the run ended

    def add(self, name: str, ns: int) -> None:
        """A span timed by the caller, outside any span of the record."""
        self._spans.append((name, ns, False))

    def as_dict(self) -> dict:
        if self._totals is not None:
            return self._totals
        spans: Dict[str, dict] = {}
        under = 0
        for name, ns, top in list(self._spans):
            got = spans.setdefault(name, {"calls": 0, "ns": 0})
            got["calls"] += 1
            got["ns"] += ns
            if top:
                under += ns
        counters: Dict[str, int] = {}
        for name, n in list(self._counts):
            counters[name] = counters.get(name, 0) + n
        out = {"root": self.root, "start": self.start, "end": self.end,
               "spans": spans, "counters": counters, "under_root_ns": under}
        if self.end is not None:
            self._totals = out
        return out


def _resolve_profiler() -> Optional[Callable[[], bool]]:
    """torch's own test of whether a profiler records this thread, once
    torch is imported (never imports it: without torch there is no
    profiler)."""
    global _profiler_on
    torch = sys.modules.get("torch")
    _profiler_on = getattr(getattr(getattr(torch, "_C", None), "_autograd",
                                   None), "_profiler_enabled", None)
    return _profiler_on


class span:
    """``with span(name):`` adds the block's time to the open record (and,
    while a profiler is active, shows it in the trace). ``ns`` holds the
    block's time after it ends."""

    __slots__ = ("name", "ns", "_rec", "_depth", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.ns = 0

    def __enter__(self) -> "span":
        global _record_function
        rec = self._rec = _current
        self._depth = 0
        if rec is not None and rec.thread == threading.get_ident():
            rec.depth += 1
            self._depth = rec.depth
        self._rf = None
        on = _profiler_on or _resolve_profiler()
        if _all_threads or (on is not None and on()):
            if _record_function is None:
                from torch.profiler import record_function

                _record_function = record_function
            self._rf = _record_function(self.name)
            self._rf.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> None:
        self.ns = _clock() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        rec = self._rec
        if rec is not None:
            rec._spans.append((self.name, self.ns, self._depth == 2))
            if self._depth:
                rec.depth -= 1

    @property
    def ms(self) -> int:
        """Whole milliseconds, as the reference's info lines print them."""
        return self.ns // 1_000_000


def count(name: str, n: int) -> None:
    """Add ``n`` to the open record's counter ``name``."""
    rec = _current
    if rec is not None:
        rec._counts.append((name, n))


@contextlib.contextmanager
def record(root: str):
    """Open a run record whose root span is ``root``, unless one is open
    (then the block's spans go into that one and no root span is added).
    Yields the record; on exit it joins ``recent_runs()``, and is written
    as ``spans.json`` where ``maybe_profile`` traced the run."""
    global _current
    if _current is not None:
        yield _current
        return
    rec = _current = RunRecord(root)
    try:
        with span(root):
            yield rec
    finally:
        _current = None
        rec.end = time.time()
        rec.as_dict()  # the totals, summed once
        _log.append(rec)
        if rec.out_dir is not None:
            with open(os.path.join(rec.out_dir, "spans.json"), "w") as fh:
                json.dump(rec.as_dict(), fh, indent=1)


def recent_runs() -> List[dict]:
    """The finished records, oldest first, as dicts (the records' own:
    read, do not modify): ``root``, ``start`` and ``end``
    (``time.time()``), ``spans`` (name -> ``calls``, ``ns``), ``counters``
    and ``under_root_ns``."""
    return [r.as_dict() for r in list(_log)]


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
    The trace of every thread (the lookups' workers too) is written as
    ``trace.json`` (Chrome trace format) in ``trace_dir``; the open run
    record is written there as ``spans.json`` when it closes."""
    global _all_threads
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True))) as prof:
        _all_threads = True
        try:
            yield
        finally:
            _all_threads = False
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    if _current is not None:
        _current.out_dir = trace_dir
