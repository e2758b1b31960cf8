"""A batch worker annotating files: the port's CLI entry
(``kmergutsjava_tpu_torch.cli.main``) called in the run's process, one job
after another, ``-D <data> -q <file> -o <report>`` with the default
backend, so the process's caches (the table, the lookup) stay warm.

Set-up: every file of the pool runs once (the first builds the lookup
and loads the kernels).
Each job's info lines (``Preparation time``, ``Lookup time``, ``Grouping
time``) are kept; its report is read back after it ends.
"""
from __future__ import annotations

import contextlib
import io
import os
import time

from portbench.core.harness import Done, phase_ms

TRACED_JOBS = 2


def run(run) -> None:
    import torch
    from torch.profiler import record_function

    from kmergutsjava_tpu_torch import cli

    out = os.path.join(run.work, "report.txt")
    tmp = os.path.join(run.work, "tmp")
    os.makedirs(tmp, exist_ok=True)

    def job(j) -> Done:
        buf = io.StringIO()
        start = time.time()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main([*run.engine_args(), "-D", run.data_dir,
                               "-q", j.path, "-o", out, "-t", tmp,
                               "--device", run.device])
            end = time.time()
            if rc != 0:
                return Done(j, start, end, False, error=f"exit {rc}")
            with open(out, "rb") as fh:
                report = fh.read().decode("latin-1")
            return Done(j, start, end, True, report=report,
                        phases=phase_ms(buf.getvalue()))
        except Exception as ex:  # noqa: BLE001 - a failed job is counted
            return Done(j, start, time.time(), False, error=repr(ex))

    for j in run.jobs:
        warm = job(j)
        if not warm.ok:
            raise RuntimeError(f"warm-up job failed: {warm.error}")
    run.closed_loop(job)
    if run.device == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    if run.trace:
        run.traced_jobs = run.jobs[:TRACED_JOBS]

        def traced():
            for j in run.traced_jobs:
                with record_function("portbench.job"):
                    job(j)

        run.traced(traced)
