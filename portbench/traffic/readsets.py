"""Metagenome read sets: each job is one read-set file.

Parameters: ``reads`` and ``read_length`` (reads drawn from the E. coli
genome: uniform starts, either strand, as chip_smoke.py's phase 7 draws
them), ``substitution_rate`` (each base replaced by one of the three
others), ``pool`` (distinct read sets; the window cycles through them).
"""
from __future__ import annotations

from typing import List

import numpy as np

from portbench.core import corpus, mixes
from portbench.core.harness import Job
from portbench.reference import prepare
from portbench.reference.fasta import Record


def generate(run, t: dict) -> List[Job]:
    g = np.frombuffer(corpus.genome()[2].encode("latin-1"), np.uint8)
    code = mixes.BASE_CODE[g]
    n, length = t["reads"], t["read_length"]
    jobs = []
    for k in range(t["pool"]):
        rng = run.rng(3, k)
        starts = rng.integers(0, len(g) - length + 1, n)
        idx = code[starts[:, None] + np.arange(length)]
        rc = rng.random(n) < 0.5
        idx[rc] = (3 - idx[rc])[:, ::-1]
        subs = rng.random(idx.shape) < t["substitution_rate"]
        idx[subs] = (idx[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
        blob = mixes.BASES[idx].tobytes().decode("latin-1")
        records = [Record(f"r{i}", blob[i * length:(i + 1) * length])
                   for i in range(n)]
        text = mixes.fasta_text(records)
        kmers = prepare.count(records, aa=False)
        jobs.append(Job(f"readset{k}", kmers,
                        path=mixes.write(run, f"readset{k}.fna", text)))
    return jobs
