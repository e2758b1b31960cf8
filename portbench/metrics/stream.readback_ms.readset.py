"""Read-set jobs: from each plane pass's launch to its answers on the host
(the pass's kernel and the copy back), total a job, mean over the window's
jobs. From the port's span log."""
from portbench.core import spans


def read(run):
    return spans.span_mean_ms(run, "stream.readback")
