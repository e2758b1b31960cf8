"""Shared pieces of the benchmark's own tests (``python -m pytest
portbench/tests``): the repository root on the import path, the ``cuda``
marker, the parked cells, and cells cut to a size the CPU runs in
seconds."""
import copy
import json
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a few hundred corpus proteins and a small table: the same recipe, not the
# configuration's size
TINY_TABLE = {"total_signatures": 150_000, "corpus_proteins": 300}
TINY_TRAFFIC = {
    "proteomes": {"proteins_min": 20, "proteins_max": 80, "pool": 4},
    "readsets": {"reads": 300, "pool": 2},
    "drafts": {"bases_min": 20_000, "bases_max": 60_000,
               "contig_min": 2_000, "contig_max": 20_000, "pool": 4},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with torch CUDA (the test "
        "skips itself where torch.cuda.is_available() is false)")


def with_parked(bench):
    """``bench`` with the cells of ``portbench/parked.json`` added: cells
    defined by their files but kept out of BENCHMARK.json for their
    spread on the card (PERF.md, Open questions). A later change brings
    one back by moving its entries into BENCHMARK.json; here the tests
    drive them at a tiny size."""
    with open(os.path.join(ROOT, "portbench", "parked.json")) as fh:
        parked = json.load(fh)["cells"]
    out = copy.deepcopy(bench)
    for name, entries in parked.items():
        out["workloads"].append(entries["workload"])
        out["per_layer"].extend(entries["per_layer"])
        for m in out["end_to_end"]:
            if m["name"] in entries["end_to_end"]:
                m["workloads"].append(name)
    return out


def tiny_cell(name):
    """(cell, config, workload): the cell as registered (or parked), its
    table and traffic cut to the tiny sizes above."""
    from portbench.core import registry

    cell = registry.resolve(name, with_parked(registry.benchmark()))
    config = copy.deepcopy(cell["config"])
    config["table"].update(TINY_TABLE)
    workload = copy.deepcopy(cell["workload"])
    workload["traffic"].update(TINY_TRAFFIC[workload["traffic"]["generator"]])
    return cell, config, workload


def tiny_run(name, tmp_path, seed=12_345_678_901, seconds=1, device="cpu"):
    """A Run of the tiny cell on ``device`` (the CPU twins of the port)."""
    from portbench.core.harness import Run

    cell, config, workload = tiny_cell(name)
    run = Run(name, workload, config, seed, seconds, False, ROOT,
              time.time(), device=device, work_root=str(tmp_path))
    return cell, run


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
