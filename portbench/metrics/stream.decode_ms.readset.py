"""Read-set jobs: the host's decode of the passes' answers (verification,
the exact fallback, the hits), total a job, mean over the window's jobs.
From the port's span log."""
from portbench.core import spans


def read(run):
    return spans.span_mean_ms(run, "stream.decode")
