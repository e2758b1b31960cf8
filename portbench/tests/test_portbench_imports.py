"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: compared by whole top-level
module names (the port's name begins with the JAX package's)."""
import ast
import glob
import os
import subprocess
import sys

import pytest

from portbench.core.forbidden import FORBIDDEN as _FORBIDDEN

from .conftest import ROOT

BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = set(_FORBIDDEN)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return [p for p in glob.glob(os.path.join(BENCH, sub, "**", "*.py"),
                                 recursive=True)
            if os.sep + "tests" + os.sep not in p]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(
    p, BENCH))
def test_no_jax_import(path):
    assert not FORBIDDEN & set(_imports(path))


@pytest.mark.parametrize("path", _sources("reference"),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    got = set(_imports(path))
    assert not (FORBIDDEN | {"kmergutsjava_tpu_torch", "torch"}) & got


def test_top_level_names_are_compared_whole():
    from portbench.core import forbidden

    sys.modules.setdefault("kmergutsjava_tpu_torch", sys)
    assert "kmergutsjava_tpu_torch" not in forbidden.loaded()


def test_loaded_modules_hold_no_jax():
    """Every module of the benchmark and the port's entry points, loaded in
    a fresh interpreter, load no JAX."""
    code = (
        "import sys, glob, os\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from portbench.core import registry, forbidden, judge, traces, "
        "cold_launch\n"
        "from portbench.tests.conftest import with_parked\n"
        "bench = with_parked(registry.benchmark())\n"
        "for c in registry.cells():\n"
        "    registry.resolve(c, bench)\n"
        "import kmergutsjava_tpu_torch.cli, kmergutsjava_tpu_torch.service"
        ".server\n"
        "print(forbidden.loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cold_job_that_loads_jax_gives_no_result(tmp_path, monkeypatch,
                                                 capsys):
    """A cold job's CLI that pulls in a module named ``jax`` (a stub,
    planted on the jobs' import path) ends the run with no result: the
    cold cell runs the program only in the jobs' own processes."""
    from portbench import run as runner

    from .conftest import tiny_run

    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    (stub / "planted_cli.py").write_text(
        "import jax  # noqa: F401\n"
        "from kmergutsjava_tpu_torch.cli import main  # noqa: F401\n")
    monkeypatch.setenv("PYTHONPATH", str(stub))
    cell, run = tiny_run("aa-cold-cli", tmp_path / "work")
    monkeypatch.setattr(cell["driver"], "CLI", "planted_cli")
    assert runner.measure(run, cell, "cpu") != 0
    out, err = capsys.readouterr()
    assert out == ""
    assert "loaded in a job's process: jax" in err
