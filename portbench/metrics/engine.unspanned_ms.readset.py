"""Read-set jobs: the CLI call's time that no span directly under it
names on its main thread (argument parsing, the function index, the
report's set-up, what a new step adds without a span), mean over the
window's jobs. From the port's span log."""
from portbench.core import spans


def read(run):
    return spans.unspanned_mean_ms(run)
