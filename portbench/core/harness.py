"""What every cell's run shares: the run's state, the closed loop that
fills the measured window, the traced slice, and the result line.

A driver (``portbench/drivers/<name>.py``) brings up the program, warms
it, runs ``closed_loop`` over the traffic and, with ``--trace 1``,
``traced`` over a few more jobs; metric readers
(``portbench/metrics/<name>.py``) read what the run recorded.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from . import traces


@dataclass
class Job:
    """One request or job of the traffic."""
    name: str
    kmers: int            # its query 8-mers, as the reference counts them
    text: Optional[str] = None   # FASTA text (served requests)
    path: Optional[str] = None   # FASTA file (CLI jobs)

    def fasta(self) -> str:
        if self.text is not None:
            return self.text
        with open(self.path, "rb") as fh:
            return fh.read().decode("latin-1")


@dataclass
class Done:
    """One job of the window: its times (host clock), outcome and output."""
    job: Job
    start: float
    end: float
    ok: bool
    report: Optional[str] = None
    error: str = ""
    phases: Dict[str, int] = field(default_factory=dict)


class Run:
    def __init__(self, cell: str, workload: dict, config: dict, seed: int,
                 seconds: int, trace: bool, root: str, t0: float,
                 device: str = "cuda", work_root: Optional[str] = None):
        self.cell, self.workload, self.config = cell, workload, config
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.root, self.t0, self.device = root, t0, device
        self.aa = bool(config["engine"]["aa"])
        self.work = os.path.join(
            work_root or os.path.join(root, "portbench_work"), cell)
        self.data_dir = os.path.join(self.work, "data")
        self.num_sigs = 0
        self.jobs: List[Job] = []
        self.done: List[Done] = []
        self.data_s = 0.0
        self.setup_s = 0.0
        self.window = (0.0, 0.0)
        self.memory_peak_bytes = 0
        self.trace_summary: Optional[dict] = None
        self.traced_jobs: List[Job] = []
        self.readings: Dict[str, float] = {}  # a driver's own readings
        self.cleanups: List[Callable[[], None]] = []

    def rng(self, *tags: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, *tags])

    # -- set-up --------------------------------------------------------

    def make_data(self, generator) -> None:
        """The configuration's table and the cell's traffic, from the seed
        (timed apart as ``data_s``)."""
        from .corpus import seeded_table

        t = time.time()
        shutil.rmtree(self.work, ignore_errors=True)
        os.makedirs(self.work)
        self.num_sigs = seeded_table(self.data_dir, self.config, self.seed)
        self.readings["table_s"] = time.time() - t
        self.jobs = generator.generate(self, self.workload["traffic"])
        self.data_s = time.time() - t

    def engine_args(self) -> List[str]:
        """The configuration's engine options as CLI flags."""
        e = self.config["engine"]
        return [*(["-a"] if e["aa"] else []), "-m", str(e["min_hits"]),
                "-g", str(e["max_gap"])]

    # -- the window ----------------------------------------------------

    def closed_loop(self, do: Callable[[Job], Done]) -> None:
        """One client: each job starts when the last has ended, until
        ``seconds`` have passed; the last job started runs to its end.
        Everything before the window is set-up."""
        start = time.time()
        self.setup_s = start - self.t0
        deadline = start + self.seconds
        i = 0
        while i == 0 or time.time() < deadline:
            self.done.append(do(self.jobs[i % len(self.jobs)]))
            i += 1
        self.window = (start, self.done[-1].end)

    def traced(self, work: Callable[[], None], pads=(0.4, 1.6, 1.6)) -> None:
        """A torch.profiler trace of ``work()`` with ``pad`` seconds of idle
        host time before and after it, taken again with a wider pad while
        it lost kernel records; after the last loss no trace is kept."""
        import torch
        from torch.profiler import ProfilerActivity, profile, \
            record_function

        path = os.path.join(self.work, "trace.json")
        for pad in pads:
            before = traces.read_counters()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(pad)
                with record_function(traces.WINDOW_SPAN):
                    work()
                    if torch.cuda.is_available():
                        torch.cuda.synchronize()
                time.sleep(pad)
            after = traces.read_counters()
            launches = {k: after[k] - before[k] for k in before
                        if after[k] > before[k]}
            prof.export_chrome_trace(path)
            try:
                self.trace_summary = traces.summarize(path, launches)
                return
            except traces.LostRecords as ex:
                print(f"trace at pad {pad} s: {ex}", file=sys.stderr,
                      flush=True)
            finally:
                os.remove(path)

    # -- after the window ----------------------------------------------

    def attempted(self) -> int:
        return len(self.done)

    def failed(self) -> int:
        return sum(not d.ok for d in self.done)

    def stop_program(self) -> None:
        for fn in reversed(self.cleanups):
            fn()
        self.cleanups.clear()

    def cleanup(self) -> None:
        self.stop_program()
        shutil.rmtree(self.work, ignore_errors=True)


def execute(run: Run, cell: dict):
    """A run of ``cell`` after the look for a chip: set-up, the window, the
    program stopped, the judge. Returns (checks, correct, metrics): the
    end-to-end metrics, or with ``run.trace`` the per-layer ones."""
    from .judge import judge

    try:
        run.make_data(cell["generator"])
        print(f"set-up: data_s={run.data_s} (a table of {run.num_sigs} "
              f"slots in {run.readings['table_s']} s and {len(run.jobs)} "
              "distinct jobs from the seed)", file=sys.stderr, flush=True)
        cell["driver"].run(run)
        run.stop_program()
        walls = [round(d.end - d.start, 3) for d in run.done]
        print(f"jobs: {len(walls)} walls_s={walls[:40]} phases_ms="
              f"{[d.phases for d in run.done[:40] if d.phases]}",
              file=sys.stderr, flush=True)
        print(f"window quarters (jobs, kmers/s): {quarters(run)}",
              file=sys.stderr, flush=True)
        t = time.time()
        checks, correct = judge(run)
        print(f"judged in {time.time() - t} s", file=sys.stderr, flush=True)
    finally:
        run.cleanup()
    metrics = {}
    for m in cell["per_layer"] if run.trace else cell["end_to_end"]:
        value = cell["readers"][m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return checks, correct, metrics


def quarters(run: Run) -> List[tuple]:
    """Jobs and query 8-mers a second of each quarter of the window, by
    the jobs' end times (a drift inside the window shows here)."""
    start, end = run.window
    span = (end - start) / 4 or 1.0
    got = [[0, 0] for _ in range(4)]
    for d in run.done:
        q = got[min(3, int((d.end - start) / span))]
        q[0] += 1
        q[1] += d.job.kmers
    return [(n, round(k / span)) for n, k in got]


def phase_ms(info: str) -> Dict[str, int]:
    """The engine's phase lines (``Preparation time: N ms.`` and so on)."""
    got = {}
    for line in info.splitlines():
        for name in ("Preparation", "Lookup", "Grouping"):
            if line.startswith(name + " time: "):
                got[name] = int(line.split(": ")[1].split()[0])
    return got


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as ex:
        return f"nvidia-smi failed: {ex}"


@contextlib.contextmanager
def memory_sampler(interval_ms: int = 250):
    """The card's used memory (nvidia-smi, every ``interval_ms``), for runs
    whose program lives in other processes; yields a list whose max is
    the peak in bytes."""
    got: List[int] = []
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,"
         "nounits", "-i", "0", "-lms", str(interval_ms)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def read():
        for line in proc.stdout:
            line = line.strip()
            if line.isdigit():
                got.append(int(line) << 20)

    t = threading.Thread(target=read, daemon=True)
    t.start()
    try:
        yield got
    finally:
        proc.terminate()
        proc.wait(30)
        t.join(30)


def result_line(run: Run, metrics: Dict[str, dict], checks: Dict[str, dict],
                correct: bool, kind: str, chips: int) -> str:
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": bool(correct), "attempted": run.attempted(),
            "failed": run.failed(), "metrics": metrics, "device": device}
    if run.trace and run.trace_summary is not None:
        device["busy_s"] = run.trace_summary["busy_s"]
        device["window_s"] = run.trace_summary["window_s"]
        line["breakdown"] = {
            "device_ops": run.trace_summary["device_ops"],
            "idle_gaps": run.trace_summary["idle_gaps"]}
    line["checks"] = checks
    return json.dumps(line)
