"""The arithmetic behind the metric readers (``portbench/metrics``). A
reader that finds nothing to read returns None, and the metric is left
out of the line; it never returns 0 for a share."""
from __future__ import annotations

from statistics import fmean
from typing import Optional

from . import peaks


def kmers_per_s(run) -> Optional[float]:
    """Query 8-mers of every job completed, over the window's wall time
    (its start to the last completion)."""
    span = run.window[1] - run.window[0]
    done = sum(d.job.kmers for d in run.done if d.ok)
    return done / span if span > 0 and done else None


def wall_per_job_s(run) -> Optional[float]:
    span = run.window[1] - run.window[0]
    return span / len(run.done) if run.done else None


def service_overhead_ms(run) -> Optional[float]:
    """Mean client-side request time minus the mean of the server's own
    ``rpc_request_seconds`` of ``annotate`` over the window."""
    n = run.readings.get("server_n", 0)
    if not run.done or not n:
        return None
    client = fmean(d.end - d.start for d in run.done)
    return (client - run.readings["server_s"] / n) * 1e3


def phase_mean_ms(run, phase: str) -> Optional[float]:
    got = [d.phases[phase] for d in run.done if phase in d.phases]
    return fmean(got) if got else None


def outside_phases_ms(run) -> Optional[float]:
    """A job's wall time less its three phase lines, mean over jobs."""
    got = [(d.end - d.start) * 1e3 - sum(d.phases.values())
           for d in run.done if len(d.phases) == 3]
    return fmean(got) if got else None


def idle_pct(run) -> Optional[float]:
    t = run.trace_summary
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def probe_roofline_pct(run) -> Optional[float]:
    """The least time the traced jobs' probes need (bytes over the peak)
    over the sum of all kernel intervals in the traced window."""
    t = run.trace_summary
    if not t or t["kernel_s"] <= 0 or not run.traced_jobs:
        return None
    need = sum(peaks.probe_bytes(j.kmers, run.num_sigs)
               for j in run.traced_jobs) / peaks.HBM_BYTES_PER_S
    return 100.0 * need / t["kernel_s"]
