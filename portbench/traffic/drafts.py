"""Draft genomes: each request is one draft assembly of E. coli.

Parameters: ``bases_min``, ``bases_max`` (a log-uniform draft size, taken
from a random place of the circular genome), ``contig_min``,
``contig_max`` (contig lengths, log-uniform: the draft is cut into contigs
of a fixed set of 64 quantile lengths taken in turn from a random place;
a last piece shorter than ``contig_min`` joins the contig before it),
``substitution_rate`` (each base replaced by one of the three others;
each contig on either strand), ``pool`` (distinct requests, a power of
two; the window cycles through them), ``as`` (``text`` or ``file``).
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
    sizes = mixes.log_uniform_sizes(t["bases_min"], t["bases_max"],
                                    t["pool"], run.rng(4))
    pieces = mixes.log_uniform_sizes(t["contig_min"], t["contig_max"], 64,
                                     run.rng(5))
    rng = run.rng(6)
    jobs = []
    for k, size in enumerate(sizes):
        at = int(rng.integers(len(g)))
        draft = np.take(g, np.arange(at, at + size), mode="wrap")
        cuts, p = [0], int(rng.integers(64))
        while cuts[-1] < size:
            cuts.append(min(size, cuts[-1] + pieces[p % 64]))
            p += 1
        if len(cuts) > 2 and cuts[-1] - cuts[-2] < t["contig_min"]:
            del cuts[-2]
        records = []
        for c, (a, b) in enumerate(zip(cuts, cuts[1:])):
            seq = mixes.substitute_dna(draft[a:b], t["substitution_rate"],
                                       bool(rng.random() < 0.5), rng)
            records.append(Record(f"d{k:02d}_c{c:03d}",
                                  seq.tobytes().decode("latin-1")))
        text = mixes.fasta_text(records)
        name = f"draft{k:02d}"
        kmers = prepare.count(records, aa=False)
        jobs.append(Job(name, kmers, text=text) if t["as"] == "text" else
                    Job(name, kmers, path=mixes.write(run, name + ".fna",
                                                      text)))
    return jobs
