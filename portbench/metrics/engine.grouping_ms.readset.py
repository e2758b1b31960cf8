"""Read-set jobs: the engine's Grouping time line, mean per job."""
from portbench.core import readers


def read(run):
    return readers.phase_mean_ms(run, "Grouping")
