"""The window's wall time (its start to the end of the last job it started)
over the cold CLI jobs it ran."""
from portbench.core import readers


def read(run):
    return readers.wall_per_job_s(run)
