"""The PyTorch package's Engine and CLI, on the CPU, against the JAX
package: the 800-protein corpus report must equal golden_aa_800 and the JAX
Engine's report byte for byte, through the sparse path, the parity backend,
a truncated table and the debug info lines. Also: the port imports neither
jax nor the JAX package, and a CUDA device without CUDA raises."""
import gzip
import io
import os
import re
import shutil
import subprocess
import sys
import warnings

import pytest
import torch

from kmergutsjava_tpu.config import EngineConfig as JaxConfig
from kmergutsjava_tpu.models.pipeline import Engine as JaxEngine
from kmergutsjava_tpu_torch import cli
from kmergutsjava_tpu_torch.config import EngineConfig
from kmergutsjava_tpu_torch.formats.kmer_table import TABLE_FILE
from kmergutsjava_tpu_torch.lookup import tilejoin
from kmergutsjava_tpu_torch.models.pipeline import Engine

from corpus_util import build_corpus_data_dir, corpus_path, load_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    prots, _ = load_corpus(800, None)
    d = tmp_path_factory.mktemp("torch_golden")
    build_corpus_data_dir(str(d), prots)
    fasta = "".join(f">{p.id} {p.descr}\n{p.seq}\n" for p in prots)
    faa = d / "query.faa"
    faa.write_text(fasta)
    with gzip.open(corpus_path("golden_aa_800.txt.gz"), "rt") as fh:
        golden = fh.read()
    return str(d), fasta, str(faa), golden


def _port(data_dir, fasta, **kw):
    out = io.StringIO()
    Engine(EngineConfig(aa=True, device="cpu", **kw)).run(
        data_dir, None, out, stdout=True, query_stream=io.StringIO(fasta))
    return out.getvalue()


def _jax(data_dir, fasta, **kw):
    out = io.StringIO()
    JaxEngine(JaxConfig(aa=True, **kw)).run(
        data_dir, None, out, stdout=True, query_stream=io.StringIO(fasta))
    return out.getvalue()


@pytest.mark.parametrize("backend", ["auto", "xla", "parity"])
def test_engine_matches_golden_and_jax(corpus, backend):
    d, fasta, _, golden = corpus
    got = _port(d, fasta, backend=backend)
    assert got == golden
    if backend == "xla":
        assert got == _jax(d, fasta, backend="xla")


@pytest.mark.parametrize("prepare", ["native", "numpy"])
def test_cli_matches_golden(corpus, tmp_path, capsys, prepare):
    d, _, faa, golden = corpus
    out = tmp_path / "report.txt"
    before = tilejoin.launches
    rc = cli.main(["-a", "-D", d, "-q", faa, "-o", str(out), "--device",
                   "cpu", "--prepare", prepare, "--chunk", "65536"])
    assert rc == 0
    assert out.read_text() == golden
    assert tilejoin.launches == before  # the CPU runs the twin
    info = capsys.readouterr().out  # -o routes info lines to stdout
    for phase in ("Preparation", "Lookup", "Grouping"):
        assert f"{phase} time: " in info


def test_cli_profile_writes_a_trace(corpus, tmp_path, capsys):
    d, fasta, _, _ = corpus
    faa = tmp_path / "q.faa"
    faa.write_text(">" + ">".join(fasta.split(">")[1:6]))
    trace = tmp_path / "trace"
    assert cli.main(["-a", "-D", d, "-q", str(faa), "-o",
                     str(tmp_path / "r.txt"), "--device", "cpu",
                     "--profile", str(trace)]) == 0
    assert (trace / "trace.json").stat().st_size > 0


def test_debug_report_matches_jax(corpus):
    """Debug mode writes info lines into the report; with the timings
    masked, the port's report equals the JAX package's."""
    d, fasta, _, _ = corpus
    fasta = ">" + ">".join(fasta.split(">")[1:16])

    def masked(text):
        return re.sub(r"time=\d+ ms|: \d+ ms\.", "<t>", text)

    got = _port(d, fasta, debug=True, min_hits=1)
    assert "Kmer-table info: numSigs=" in got
    assert "Kmers found: " in got
    assert masked(got) == masked(_jax(d, fasta, debug=True, min_hits=1,
                                      backend="xla"))


def test_truncated_table_partial_report_matches_jax(tmp_path, corpus):
    d, fasta, _, _ = corpus
    small = tmp_path / "trunc"
    small.mkdir()
    for name in os.listdir(d):
        if name.startswith(("kmer.table", "function")):
            shutil.copy(os.path.join(d, name), small / name)
    path = small / TABLE_FILE
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(size // 2)
    os.remove(small / "kmer.table.meta.json")
    fasta = ">" + ">".join(fasta.split(">")[1:40])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # expected reroute warning
        got = _port(str(small), fasta, debug=True, backend="xla")
        want = _jax(str(small), fasta, debug=True, backend="xla")
    assert "Error: null" in got
    assert "PROTEIN-ID" in got

    def masked(text):
        return re.sub(r": \d+ ms\.", "<t>", text)

    assert masked(got) == masked(want)


def test_dense_table_falls_back_to_parity(tmp_path):
    """A probe window over 256 degrades to the parity scan, as in the JAX
    package (its test_truncated_table.py)."""
    import numpy as np

    from kmergutsjava_tpu_torch.constants import EMPTY_KMER
    from kmergutsjava_tpu_torch.formats.function_index import \
        write_function_index
    from kmergutsjava_tpu_torch.formats.kmer_table import (KmerTable,
                                                           SLOT_DTYPE,
                                                           write_table)

    num_sigs = 600
    slots = np.zeros(num_sigs, dtype=SLOT_DTYPE)
    slots["kmer"] = EMPTY_KMER
    for i in range(300):
        slots["kmer"][i] = i * num_sigs  # one 300-slot probe chain
    write_table(str(tmp_path / TABLE_FILE),
                KmerTable(slots=slots, num_sigs=num_sigs))
    write_function_index(str(tmp_path / "function.index"), ["f0"])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = _port(str(tmp_path), ">P1\nACDEFGHIKLMNPQRSTVWY\n",
                    backend="xla")
    assert any("parity" in str(x.message) for x in w)
    assert "PROTEIN-ID\tP1\t20" in got


def test_kernel_error_is_not_turned_into_a_report(corpus, monkeypatch):
    """The reference reports any lookup failure and exits 0; a kernel
    fault must propagate instead."""
    from kmergutsjava_tpu_torch.lookup.sparse import SparseLookup

    def broken(self, q_fp, homes):
        raise tilejoin.KernelError("launch refused")

    monkeypatch.setattr(SparseLookup, "dispatch_probe", broken)
    d, fasta, _, _ = corpus
    with pytest.raises(tilejoin.KernelError):
        _port(d, fasta, backend="xla", lookup_chunk=4096)


@pytest.mark.parametrize("step", ["dispatch", "read-back"])
def test_device_fault_is_not_turned_into_a_report(corpus, monkeypatch,
                                                  step):
    """An asynchronous device fault surfaces as a plain torch RuntimeError
    at the next CUDA call of either worker; it must propagate as a
    KernelError, not become an 'Error:' line and a partial report."""
    from kmergutsjava_tpu_torch.lookup import sparse

    def faulty(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    if step == "dispatch":
        monkeypatch.setattr(sparse.tilejoin, "tilejoin_probe", faulty)
    else:
        monkeypatch.setattr(sparse.torch.Tensor, "cpu", faulty)
    d, fasta, _, _ = corpus
    with pytest.raises(tilejoin.KernelError, match=f"{step} failed"):
        _port(d, fasta, backend="xla", lookup_chunk=4096)


def test_cuda_device_without_cuda_raises(corpus):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    d, fasta, faa, _ = corpus
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Engine(EngineConfig(aa=True)).run(d, faa, io.StringIO())
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["-a", "-D", d, "-q", faa, "--device", "cuda"])


@pytest.mark.parametrize("argv", [["-D", "x"], ["-a", "-D", "x", "--backend",
                                                "stream"],
                                  ["-a", "-D", "x", "--mesh", "2x2"],
                                  ["-a", "-D", "x", "--prepare", "jax"]])
def test_cli_rejects_unported_options(argv, capsys):
    assert cli.main(argv) == 2
    assert "ROADMAP.md" in capsys.readouterr().out


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, leaves
    jax and the JAX package out of sys.modules."""
    code = """
import importlib, pkgutil, sys
import kmergutsjava_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "kmergutsjava_tpu"))
print(len(names), bad)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.split(" ", 1)
    assert int(n) >= 20
    assert bad.strip() == "[]"
