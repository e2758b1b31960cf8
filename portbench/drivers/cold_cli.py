"""One-shot CLI jobs: each job is a fresh process that runs the port's
CLI (``kmergutsjava_tpu_torch.cli``) with ``-D <data> -q <file> -o
<report>``, as the reference's users and its own test run it; one at a
time. Every job pays the interpreter, the imports, the CUDA context, the
table read and the cold lookup build.

A job starts through ``core/cold_launch.py``, which runs the CLI's
``main`` and then looks for JAX or the JAX package in the job's own
process; a job that loaded one ends the run with no result
(``ForbiddenModules``).

Set-up: one job runs once (on a checkout's first run it builds the host
libraries and the kernels). The program lives in the jobs' processes, so
the card's peak memory is read by nvidia-smi, which runs from the warm-up
job to the window's end. With
``--trace 1`` two more jobs run with the CLI's own ``--profile``.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

from portbench.core import cold_launch, traces
from portbench.core.forbidden import ForbiddenModules
from portbench.core.harness import Done, memory_sampler, phase_ms

TRACED_JOBS = 2
CLI = "kmergutsjava_tpu_torch.cli"


def run(run) -> None:
    out = os.path.join(run.work, "report.txt")
    tmp = os.path.join(run.work, "tmp")
    os.makedirs(tmp, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (run.root, env.get("PYTHONPATH")) if p)

    def job(j, profile=None) -> Done:
        cmd = [sys.executable, "-m", "portbench.core.cold_launch", CLI,
               *run.engine_args(), "-D", run.data_dir, "-q", j.path,
               "-o", out, "-t", tmp,
               *(["--device", run.device] if run.device != "cuda" else []),
               *(["--profile", profile] if profile else [])]
        start = time.time()
        p = subprocess.run(cmd, cwd=run.root, env=env, capture_output=True,
                           text=True)
        end = time.time()
        if p.returncode == cold_launch.FOUND_EXIT and \
                cold_launch.MARK in p.stderr:
            raise ForbiddenModules(p.stderr.split(cold_launch.MARK)[-1]
                                   .strip())
        if p.returncode != 0:
            return Done(j, start, end, False,
                        error=f"exit {p.returncode}: {p.stderr[-2000:]}")
        with open(out, "rb") as fh:
            report = fh.read().decode("latin-1")
        return Done(j, start, end, True, report=report,
                    phases=phase_ms(p.stdout))

    if run.device == "cuda":
        # the sampler holds the card's driver open from the warm-up job on,
        # as persistence mode would: no job pays the driver's start alone
        with memory_sampler() as used:
            warm = job(run.jobs[0])
            if warm.ok:
                run.closed_loop(job)
        run.memory_peak_bytes = max(used, default=0)
    else:
        warm = job(run.jobs[0])
        if warm.ok:
            run.closed_loop(job)
    if not warm.ok:
        raise RuntimeError(f"warm-up job failed: {warm.error}")
    if run.trace:
        run.traced_jobs = run.jobs[:TRACED_JOBS]
        got = []
        for k, j in enumerate(run.traced_jobs):
            d = os.path.join(run.work, f"profile{k}")
            done = job(j, profile=d)
            if not done.ok:
                raise RuntimeError(f"traced job failed: {done.error}")
            try:
                # a job that probed on the card left kernel records
                got.append(traces.summarize(os.path.join(d, "trace.json"),
                                            {"": 1}))
            except traces.LostRecords as ex:
                print(f"traced job {k}: {ex}", file=sys.stderr, flush=True)
        if len(got) == len(run.traced_jobs):
            run.trace_summary = traces.merge(got)
