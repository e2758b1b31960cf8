"""The traffic generators: the same seed gives the same traffic, another
seed other traffic over the same set of sizes."""
import os
import time

import pytest

from portbench.core.harness import Run

from .conftest import ROOT, tiny_cell


def _jobs(name, seed, tmp_path):
    cell, config, workload = tiny_cell(name)
    run = Run(name, workload, config, seed, 1, False, ROOT, time.time(),
              device="cpu", work_root=str(tmp_path / str(seed)))
    import os

    os.makedirs(run.work, exist_ok=True)
    jobs = cell["generator"].generate(run, workload["traffic"])
    return [(j.kmers, j.fasta()) for j in jobs]


@pytest.mark.parametrize("name", ["dna-readsets-batch", "dna-genomes-served",
                                  "aa-cold-cli"])
def test_seed_decides_the_traffic(name, tmp_path):
    a = _jobs(name, 2 ** 31 + 11, tmp_path)
    b = _jobs(name, 2 ** 31 + 11, tmp_path / "again")
    c = _jobs(name, 5, tmp_path)
    assert a == b
    assert [t for _, t in a] != [t for _, t in c]


@pytest.mark.parametrize("name", ["dna-genomes-served", "aa-cold-cli"])
def test_every_seed_gets_the_same_sizes(name, tmp_path):
    """Request sizes are quantiles, not draws: another seed changes their
    order and content, not the set of record counts or bases."""
    def sizes(seed):
        return sorted(sum(len(line) for line in text.split("\n")
                          if not line.startswith(">"))
                      if name.startswith("dna") else text.count(">")
                      for _, text in _jobs(name, seed, tmp_path))
    assert sizes(1) == sizes(2 ** 32 + 3)


def test_table_size_is_the_same_for_every_seed(tmp_path):
    """numSigs follows from the configuration alone, so a run's set-up does
    the same work on every seed; the tables' contents differ."""
    from portbench.core.corpus import seeded_table

    _, config, _ = tiny_cell("dna-readsets-batch")
    nums, tables = set(), set()
    for seed in (11, 2 ** 31 + 5, 12_345_678_901):
        d = str(tmp_path / str(seed))
        nums.add(seeded_table(d, config, seed))
        with open(os.path.join(d, "kmer.table.mem_map"), "rb") as fh:
            tables.add(hash(fh.read()))
    assert len(nums) == 1 and len(tables) == 3
