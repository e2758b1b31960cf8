"""Read-set jobs: the time the prepare's feed waits on a full queue of the
stream front end's worker, total a job, mean over the window's jobs. From
the port's span log."""
from portbench.core import spans


def read(run):
    return spans.span_mean_ms(run, "prepare.feed_wait")
