"""Read-set jobs: the engine's Lookup time line (the stream front end,
transfers, decode), mean per job."""
from portbench.core import readers


def read(run):
    return readers.phase_mean_ms(run, "Lookup")
