"""Read-set jobs: the engine's Preparation time line (prepare and the stream
scatter), mean per job."""
from portbench.core import readers


def read(run):
    return readers.phase_mean_ms(run, "Preparation")
