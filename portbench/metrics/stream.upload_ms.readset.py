"""Read-set jobs: the query tiles' copies to the card (host side), total a
job, mean over the window's jobs. From the port's span log."""
from portbench.core import spans


def read(run):
    return spans.span_mean_ms(run, "stream.upload")
