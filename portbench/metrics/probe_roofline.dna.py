"""The probe's share of its roofline in the traced dna jobs: 12 B a query
8-mer and min(2 S, 32 n) B of plane a job over 3.35 TB/s, against the sum
of all kernel intervals in the traced window."""
from portbench.core import readers


def read(run):
    return readers.probe_roofline_pct(run)
