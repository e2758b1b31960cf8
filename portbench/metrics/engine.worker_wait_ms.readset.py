"""Read-set jobs: the lookup phase's wait for the stream front end's worker
to finish its queued chunks and passes, total a job, mean over the window's
jobs. From the port's span log."""
from portbench.core import spans


def read(run):
    return spans.span_mean_ms(run, "engine.worker_wait")
