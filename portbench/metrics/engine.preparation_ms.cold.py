"""Cold CLI jobs: the engine's Preparation time line (the cold lookup build
and prepare), mean per job."""
from portbench.core import readers


def read(run):
    return readers.phase_mean_ms(run, "Preparation")
