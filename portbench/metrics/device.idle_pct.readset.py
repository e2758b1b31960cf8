"""Share of the traced window (readset jobs) in which no kernel, copy or
memset ran on the card."""
from portbench.core import readers


def read(run):
    return readers.idle_pct(run)
