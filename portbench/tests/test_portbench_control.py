"""The control (``portbench/control.py``: the reference with bfloat16
weight sums in the program's place) comes out not correct through the
judge's own comparison, on three seeds, at a size a test run holds; on
the chip it runs at each cell's own size."""
import pytest

from .conftest import tiny_cell


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5, 77])
@pytest.mark.parametrize("name", ["dna-readsets-batch", "dna-genomes-served",
                                  "aa-cold-cli"])
def test_control_fails_the_judge(name, seed, tmp_path):
    from portbench.control import readings

    cell, config, workload = tiny_cell(name)
    got = readings(cell, name, seed, work_root=str(tmp_path), config=config,
                   workload=workload)
    assert got["correct"] is False
    checks = got["checks"]
    assert checks["judged"]["value"] >= 1
    assert checks["differing_reports"]["value"] >= 1
    assert checks["differing_lines"]["value"] >= 1
