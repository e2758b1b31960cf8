"""Genome proteomes: each request or job is one genome's proteins.

Parameters: ``proteins_min``, ``proteins_max`` (a log-uniform count of
proteins, drawn without replacement from the 13,645 E. coli proteins and
put in random order), ``substitution_rate`` (each residue replaced by
another amino acid), ``pool`` (distinct requests, a power of two; the
window cycles through them), ``as`` (``text``: sent inline; ``file``:
written to a FASTA file).
"""
from __future__ import annotations

from typing import List

import numpy as np

from portbench.core import corpus, mixes
from portbench.core.harness import Job
from portbench.reference import prepare
from portbench.reference.fasta import Record


def generate(run, t: dict) -> List[Job]:
    prots = corpus.proteome()
    sizes = mixes.log_uniform_sizes(t["proteins_min"], t["proteins_max"],
                                    t["pool"], run.rng(1))
    rng = run.rng(2)
    jobs = []
    for k, size in enumerate(sizes):
        pick = rng.choice(len(prots), size, replace=False)
        seqs = [prots[i][2].encode("latin-1") for i in pick]
        lens = np.array([len(s) for s in seqs])
        blob = mixes.substitute_protein(
            np.frombuffer(b"".join(seqs), np.uint8), t["substitution_rate"],
            rng).tobytes()
        cut = np.concatenate([[0], np.cumsum(lens)]).tolist()
        records = [Record(prots[i][0], blob[a:b].decode("latin-1"))
                   for i, a, b in zip(pick.tolist(), cut, cut[1:])]
        text = mixes.fasta_text(records)
        name = f"proteome{k:03d}"
        kmers = prepare.count(records, aa=True)
        jobs.append(Job(name, kmers, text=text) if t["as"] == "text" else
                    Job(name, kmers, path=mixes.write(run, name + ".faa",
                                                      text)))
    return jobs
