"""On the card: each cell runs end to end through run.py, a short window,
and prints a correct result line (``python -m pytest --noconftest`` is not
needed: nothing here imports JAX)."""
import json
import os
import subprocess
import sys

import pytest

from portbench.core import registry

from .conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  registry.benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(cell, cuda):
    out = subprocess.run([sys.executable, os.path.join(ROOT, "portbench",
                                                        "run.py"),
                          "--workload", cell, "--seed", str(2 ** 31 + 99),
                          "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
