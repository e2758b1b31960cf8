"""Read-set jobs: the stream front end's scatter of query chunks into the
tiles (its worker thread), total a job, mean over the window's jobs. From
the port's span log."""
from portbench.core import spans


def read(run):
    return spans.span_mean_ms(run, "stream.scatter")
