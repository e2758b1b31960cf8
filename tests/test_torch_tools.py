"""The port's table tools (kmergutsjava_tpu_torch/tools.py), compile report
and packaging, on the CPU: ``build-table`` from both packages on the same
FASTA and flags writes byte-identical data dirs; ``check-table`` prints the
same lines and exit codes as the JAX package's, on a good table and on
each broken one; the compile report names torch and CUDA, not jax, and
the port's own copy of the spec; and the package data holds every kernel
source, the headers they share, the host C++ and the spec."""
import fnmatch
import glob
import importlib
import json
import os
import tomllib

import numpy as np
import pytest

from kmergutsjava_tpu import tools as jax_tools
from kmergutsjava_tpu.service import compile_report as jax_report
from kmergutsjava_tpu_torch import cli, tools
from kmergutsjava_tpu_torch.constants import MAX_ENCODED
from kmergutsjava_tpu_torch.formats.kmer_table import (TABLE_FILE, read_table,
                                                       write_table)
from kmergutsjava_tpu_torch.lookup import tilejoin
from kmergutsjava_tpu_torch.service import compile_report

from corpus_util import load_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AA = "ACDEFGHIKLMNPQRSTVWY"


def _run(main, argv, capsys):
    """(exit code or the exception's type and text, stdout)."""
    try:
        rc = main(argv)
    except Exception as ex:  # noqa: BLE001 — compared across packages
        rc = (type(ex).__name__, str(ex))
    return rc, capsys.readouterr().out


def _files(d):
    """Each file's bytes; a gzip member's header mtime (bytes 4-8, the
    second it was written) is zeroed."""
    got = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as fh:
            raw = fh.read()
        got[name] = raw[:4] + bytes(4) + raw[8:] if name.endswith(".gz") \
            else raw
    return got


@pytest.fixture(scope="module")
def proteins(tmp_path_factory):
    prots, _ = load_corpus(60, None)
    faa = tmp_path_factory.mktemp("tools") / "p.faa"
    faa.write_text("".join(f">{p.id} {p.descr}\n{p.seq}\n" for p in prots))
    return str(faa)


@pytest.mark.parametrize("flags", [
    [],
    ["--functions-from-descr", "--load-factor", "0.8", "--weight", "0.5",
     "--otu-mod", "3"],
    ["--function", "one function", "--load-factor", "0.95", "--gz"],
])
def test_build_table_equals_jax(proteins, tmp_path, capsys, flags):
    got = {}
    for name, main in (("jax", jax_tools.main), ("port", tools.main)):
        out = str(tmp_path / name)
        rc, text = _run(main, ["build-table", "-o", out, "--fasta", proteins,
                               *flags], capsys)
        got[name] = rc, text.replace(out, "<dir>"), _files(out)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0 and "signatures" in got["port"][1]


def test_build_table_cli_and_annotate(tmp_path, capsys):
    faa = tmp_path / "p.faa"
    faa.write_text(f">p1 alpha function\n{AA}\n>p2 beta function\n"
                   f"{AA[::-1]}\n")
    assert tools.main(["build-table", "-o", str(tmp_path / "d"), "--fasta",
                       str(faa), "--functions-from-descr"]) == 0
    assert "2 functions" in capsys.readouterr().out
    out = tmp_path / "r.txt"
    assert cli.main(["-a", "-D", str(tmp_path / "d"), "-q", str(faa), "-o",
                     str(out), "--device", "cpu"]) == 0
    text = out.read_text()
    assert "alpha function" in text and "beta function" in text


def test_tools_usage_and_unknown_command(capsys):
    assert tools.main([]) == 0
    assert "build-table" in capsys.readouterr().out
    assert tools.main(["nope"]) == 2
    assert "unknown command: nope" in capsys.readouterr().err


def _broken(kind, d):
    """Break the table of data dir ``d`` in one way. The meta file keeps
    the built table's max_probe (read_table took it from there), so the
    writer and the checker never recompute it."""
    path = os.path.join(d, TABLE_FILE)
    t = read_table(path, mmap=False)
    slots = np.array(t.slots)
    occ = np.nonzero(slots["kmer"] <= MAX_ENCODED)[0]
    empty = np.nonzero(slots["kmer"] > MAX_ENCODED)[0]
    if kind == "truncated":
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.truncate(size // 2)
        return
    if kind == "last_slot":
        slots["kmer"][-1] = 5
    elif kind == "negative":
        slots["kmer"][empty[-2]] = -slots["kmer"][occ[0]] - 1
    elif kind == "duplicate":
        i = occ[0]
        j = empty[empty > i][0]
        slots["kmer"][j] = slots["kmer"][i]
    elif kind == "function_range":
        slots["fi"][occ[1]] = 999
    elif kind == "before_home":  # an entry whose home lies after its slot
        slots["kmer"][empty[0]] = empty[0] + 3
    t.slots = slots
    write_table(path, t)


PROBLEMS = {"truncated": "file truncated", "last_slot": "last slot occupied",
            "negative": "negative k-mer", "duplicate": "duplicate k-mer",
            "function_range": "functionIndex out of range",
            "before_home": "placed before their home"}


@pytest.mark.parametrize("kind", ["ok", *PROBLEMS])
def test_check_table_equals_jax(proteins, tmp_path, capsys, kind):
    d = str(tmp_path / "d")
    assert tools.main(["build-table", "-o", d, "--fasta", proteins]) == 0
    capsys.readouterr()
    if kind != "ok":
        _broken(kind, d)
    port = _run(tools.main, ["check-table", d], capsys)
    assert port == _run(jax_tools.main, ["check-table", d], capsys)
    rc, text = port
    if kind == "ok":
        assert rc == 0 and text.endswith("OK\n") and "max_probe=" in text
    else:
        assert rc == 1 and "PROBLEM: " in text and PROBLEMS[kind] in text


# what the port's SPEC.md adds to the JAX package's list of /metrics
SPAN_METRICS = """, and `engine_span_seconds`
  {span}: a histogram of each successful annotate request's time in
  each of the engine's spans (`utils/timing.py`; its total over the
  request), among them `service.lock_wait` (the wait for the engine
  lock), `service.annotate` (the request under the lock) and the phases
  `engine.prepare`, `engine.lookup`, `engine.group`""".encode()


def test_compile_report_names_torch_and_cuda(tmp_path, capsys):
    import torch

    out = tmp_path / "work" / "compile_report.json"
    assert compile_report.main([str(out)]) == 0
    rep = json.loads(out.read_text())
    jax_out = tmp_path / "jax.json"
    assert jax_report.main([str(jax_out)]) == 0
    want = json.loads(jax_out.read_text())
    assert "jax" not in rep
    assert rep["torch"] == torch.__version__
    assert rep["cuda"] == torch.version.cuda
    for key in ("module_name", "rpc_prefix", "functions", "version"):
        assert rep[key] == want[key]
    # the port's own copy of the spec, the same text as the JAX package's
    # but for the one family the port's /metrics adds: the engine's spans
    assert rep["spec_file"] == os.path.join(REPO, "kmergutsjava_tpu_torch",
                                            "service", "SPEC.md")
    with open(rep["spec_file"], "rb") as fh, open(want["spec_file"],
                                                  "rb") as jfh:
        port, jax = fh.read(), jfh.read()
    assert port.count(SPAN_METRICS) == 1
    assert port.replace(SPAN_METRICS, b"") == jax
    assert "PyTorch" in rep["language"] and "CUDA" in rep["language"]
    assert rep["implementation"] != want["implementation"]


def test_package_data_holds_every_kernel_source_and_header():
    """An installed port builds every kernel and its host code and serves
    its spec: each csrc/*.cu, each header in tilejoin.HEADERS, each
    native/*.cpp and native/*.h and service/SPEC.md matches a package-data
    pattern, and each console script names a callable of the port."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        project = tomllib.load(fh)
    patterns = project["tool"]["setuptools"]["package-data"][
        "kmergutsjava_tpu_torch"]
    pkg = os.path.join(REPO, "kmergutsjava_tpu_torch")
    sources = glob.glob(os.path.join(pkg, "csrc", "*.cu"))
    assert len(sources) == 10  # kmer_windows, shard_probe, route_bins,
    # scan_machine, fused_probe, stream_tiles too
    natives = glob.glob(os.path.join(pkg, "native", "*.cpp"))
    assert len(natives) == 4  # feeder, scatter, grouping, fasta
    owned = (*natives, os.path.join(pkg, "native", "threading.h"),
             os.path.join(pkg, "service", "SPEC.md"))
    for path in (*sources, *tilejoin.HEADERS, *owned):
        rel = os.path.relpath(path, pkg)
        assert os.path.exists(path), rel
        assert any(fnmatch.fnmatch(rel, p) for p in patterns), rel
    scripts = project["project"]["scripts"]
    for name in ("kmer_guts_torch", "kmer_guts_torch_server"):
        module, func = scripts[name].split(":")
        assert module.startswith("kmergutsjava_tpu_torch.")
        assert callable(getattr(importlib.import_module(module), func))
