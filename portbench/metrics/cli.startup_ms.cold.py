"""Cold CLI jobs: wall time less the three phase lines (interpreter, imports,
CUDA context, table read, kernel loads, exit), mean per job."""
from portbench.core import readers


def read(run):
    return readers.outside_phases_ms(run)
