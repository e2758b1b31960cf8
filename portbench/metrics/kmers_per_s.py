"""Query 8-mers of every request or job completed in the window, over the
window's wall time (its start to the last completion)."""
from portbench.core import readers


def read(run):
    return readers.kmers_per_s(run)
