"""The port's fused device path (``--backend spmd``: models/spmd.py,
parallel/annotate_step.py, parallel/seq_windows.py) and its device prepare
(``--prepare jax``: models/prepare.py prepare_aa/prepare_dna) on the CPU,
where the k-mer window kernel and the sparse probe run their plain twins,
against the JAX package: the step's verified hits equal the JAX
SpmdAnnotator's on a (1, 1) mesh, piece for piece; reports are
byte-identical to the JAX engine's ``spmd`` and ``xla`` for aa, DNA, debug
and long records (through windows, thresholds shrunk as in
tests/test_spmd_backend.py), for a probe window past 128 (the parity
fallback) and a truncated table; ``--prepare jax`` reports equal the JAX
engine's and its ``add_batch`` rows come in the JAX order; the CLI takes
``--backend spmd``; a KernelError in the prepare or the lookup phase
propagates and is never an ``Error:`` line."""
import io
import os
import random
import shutil
import warnings

import numpy as np
import pytest

import kmergutsjava_tpu.models.spmd as jax_spmd
from kmergutsjava_tpu.cli import main as jax_cli_main
from kmergutsjava_tpu.config import EngineConfig as JaxConfig
from kmergutsjava_tpu.formats.kmer_table import read_table as jax_read_table
from kmergutsjava_tpu.models import prepare as jax_prepare
from kmergutsjava_tpu.models.pipeline import Engine as JaxEngine
from kmergutsjava_tpu_torch import cli
from kmergutsjava_tpu_torch.config import EngineConfig
from kmergutsjava_tpu_torch.formats.fasta import FastaRecord
from kmergutsjava_tpu_torch.formats.kmer_table import TABLE_FILE, read_table
from kmergutsjava_tpu_torch.formats.table_tools import (
    signatures_from_proteins, write_data_dir)
from kmergutsjava_tpu_torch.lookup import tilejoin
from kmergutsjava_tpu_torch.models import prepare, spmd
from kmergutsjava_tpu_torch.models.pipeline import Engine
from kmergutsjava_tpu_torch.parallel import annotate_step

from test_end_to_end import _random_corpus, _strip_info
from test_spmd_backend import CODON, _dna_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A random 40-protein table; its proteins (aa queries, two long ones
    built from them) and reads and contigs translated back from them (DNA
    queries, one long)."""
    rng = random.Random(21)
    prots, triples, funcs = _random_corpus(rng)
    d = str(tmp_path_factory.mktemp("spmd") / "d")
    write_data_dir(d, signatures_from_proteins(triples), funcs)
    joined = "".join(prots)
    long_prots = [joined[:700], joined[300:1500].lower() + joined[:90]]
    aa = ("".join(f">p{i} d{i}\n{p}\n" for i, p in enumerate(prots))
          + "".join(f">long{i}\n{p}\n" for i, p in enumerate(long_prots)))
    long_nt = "".join(CODON[c] for c in joined)[:2400]
    reads = _dna_corpus(rng, prots, 40)
    dna = ("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads))
           + f">ctg\n{long_nt}\n>ctg2\n{long_nt[:130]}NNRY{long_nt[:400]}\n")
    return d, {"aa": aa, "dna": dna}


@pytest.fixture
def short_long(monkeypatch):
    """Thresholds of both packages shrunk so the long records go through
    windows."""
    for mod in (jax_spmd, spmd):
        monkeypatch.setattr(mod, "LONG_AA", 100)
        monkeypatch.setattr(mod, "WIN_AA", 64)
        monkeypatch.setattr(mod, "LONG_NT", 300)
        monkeypatch.setattr(mod, "WIN_NT", 150)


def _port(d, fasta, aa, **kw):
    out = io.StringIO()
    Engine(EngineConfig(aa=aa, device="cpu", **kw)).run(
        d, None, out, stdout=True, query_stream=io.StringIO(fasta))
    return out.getvalue()


def _jax(d, fasta, aa, **kw):
    out = io.StringIO()
    JaxEngine(JaxConfig(aa=aa, **kw)).run(
        d, None, out, stdout=True, query_stream=io.StringIO(fasta))
    return out.getvalue()


def _records(text):
    from kmergutsjava_tpu_torch.formats.fasta import read_fasta

    return list(read_fasta(io.StringIO(text)))


@pytest.mark.parametrize("mode", ["aa", "dna"])
def test_step_hits_equal_jax_annotator(corpus, short_long, mode):
    """The port's annotator (window kernel's twin -> B1's twin -> host
    verification) against the JAX SpmdAnnotator on a (1, 1) mesh
    (``_local_probe``): the same hit columns, piece for piece, long
    records included, and the same containers."""
    d, texts = corpus
    aa = mode == "aa"
    path = os.path.join(d, TABLE_FILE)
    jcfg = JaxConfig(aa=aa, backend="spmd", mesh_shape=(1, 1), debug=True)
    jann = jax_spmd.SpmdAnnotator(jax_read_table(path), jcfg, batch_rows=7)
    jprep = jann.consume(_records(texts[mode]))
    want = jann.finish()
    cfg = EngineConfig(aa=aa, backend="spmd", device="cpu", debug=True)
    ann = spmd.SpmdAnnotator(read_table(path), cfg, batch_rows=7)
    prep = ann.consume(_records(texts[mode]))
    got = ann.finish()
    assert prep.containers == jprep.containers
    assert len(ann._pieces) == len(jann._pieces) > spmd.MAX_IN_FLIGHT
    for name in ("cnt_id", "pos", "otu", "avg_from_end", "fi", "wt"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.kmers_found == want.kmers_found > 0


@pytest.mark.parametrize("mode", ["aa", "dna"])
@pytest.mark.parametrize("debug", [False, True])
def test_spmd_reports_equal_jax(corpus, short_long, mode, debug):
    """Reports byte-identical to the JAX engine's spmd and xla backends
    (timing lines stripped in debug mode), long records through windows."""
    d, texts = corpus
    aa = mode == "aa"
    kw = dict(min_hits=2, debug=debug)
    got = _port(d, texts[mode], aa, backend="spmd", **kw)
    want_spmd = _jax(d, texts[mode], aa, backend="spmd", **kw)
    want_xla = _jax(d, texts[mode], aa, backend="xla", **kw)
    if debug:
        got, want_spmd, want_xla = map(_strip_info,
                                       (got, want_spmd, want_xla))
        assert "Kmers found:" in got and "HIT\t" in got
    assert got == want_spmd == want_xla
    assert "CALL\t" in got


def test_spmd_probe_window_past_128_falls_back_to_parity(corpus):
    """A probe window over 128 is a ValueError of the program, so the run
    degrades to the parity scan, with the JAX engine's report."""
    d, texts = corpus
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = _port(d, texts["aa"], True, backend="spmd", probe_window=129,
                    min_hits=2)
    assert any("spmd backend unavailable" in str(x.message) for x in w)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _jax(d, texts["aa"], True, backend="spmd", probe_window=129,
                    min_hits=2)
    assert got == want and "CALL\t" in got


def test_spmd_truncated_table_matches_jax(tmp_path, corpus):
    """A truncated table never reaches the fused path: the parity scan's
    partial results and the "Error: null" line, as the JAX engine's."""
    import re

    d, texts = corpus
    small = tmp_path / "trunc"
    small.mkdir()
    for name in os.listdir(d):
        if name.startswith(("kmer.table", "function")):
            shutil.copy(os.path.join(d, name), small / name)
    path = small / TABLE_FILE
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 2)
    os.remove(small / "kmer.table.meta.json")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = _port(str(small), texts["aa"], True, backend="spmd",
                    debug=True, min_hits=2)
        want = _jax(str(small), texts["aa"], True, backend="spmd",
                    debug=True, min_hits=2)
    assert "Error: null" in got

    def masked(text):
        return re.sub(r": \d+ ms\.", "<t>", text)

    assert masked(got) == masked(want)


@pytest.mark.parametrize("mode,backend", [("aa", "xla"), ("aa", "parity"),
                                          ("dna", "xla"), ("dna", "stream")])
def test_prepare_jax_reports_equal_jax(corpus, mode, backend):
    """``--prepare jax`` (the window kernel's values entry) feeding each
    lookup: the JAX engine's ``--prepare jax`` report, byte for byte."""
    d, texts = corpus
    aa = mode == "aa"
    got = _port(d, texts[mode], aa, backend=backend, prepare_impl="jax",
                min_hits=2)
    want = _jax(d, texts[mode], aa, backend=backend, prepare_impl="jax",
                min_hits=2)
    assert got == want and "CALL\t" in got


class _Rows:
    """A store that records every add_batch call's rows."""

    def __init__(self):
        self.calls = []

    def add_batch(self, values, cnt_id, pos):
        n = len(values)
        self.calls.append((np.array(values, np.int64),
                           np.broadcast_to(np.asarray(cnt_id, np.int64),
                                           (n,)).copy(),
                           np.array(pos, np.int64)))

    def rows(self):
        return [np.concatenate([c[i] for c in self.calls])
                for i in range(3)]


@pytest.mark.parametrize("mode", ["aa", "dna"])
def test_device_prepare_rows_in_jax_order(corpus, monkeypatch, mode):
    """prepare_aa: the JAX add_batch calls, one for one. prepare_dna: the
    JAX rows in the JAX order (contig, frame row, position), though
    consecutive contigs share a launch (the batch budget shrunk here so
    that several launches occur); the containers equal the JAX's."""
    _, texts = corpus
    monkeypatch.setattr(prepare, "MAX_CELLS", 3000)
    recs = _records(texts[mode])
    got, want = _Rows(), _Rows()
    if mode == "aa":
        p = prepare.prepare_aa(recs, got, batch_rows=5, min_bucket=32,
                               device="cpu")
        jp = jax_prepare.prepare_aa(recs, want, batch_rows=5, min_bucket=32)
        assert len(got.calls) == len(want.calls)
        for g, w in zip(got.calls, want.calls):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    else:
        p = prepare.prepare_dna(recs, got, device="cpu")
        jp = jax_prepare.prepare_dna(recs, want)
        assert 1 < len(got.calls) < len(want.calls)
    for a, b in zip(got.rows(), want.rows()):
        np.testing.assert_array_equal(a, b)
    assert p.containers == jp.containers and p.id_len == jp.id_len


def test_cli_backend_spmd(tmp_path, capsys):
    """The CLI runs ``--backend spmd`` and ``--prepare jax`` as the JAX
    CLI does (the JAX package's test_spmd_cli_reachable)."""
    aa = "ACDEFGHIKLMNPQRSTVWY"
    write_data_dir(str(tmp_path / "d"), signatures_from_proteins(
        [(aa, 0, 3)], weight=0.5), ["funcA"])
    q = tmp_path / "q.faa"
    q.write_text(">P1\n" + aa + "\n")
    base = ["-a", "-D", str(tmp_path / "d"), "-q", str(q)]
    assert jax_cli_main(base + ["--backend", "spmd"]) == 0
    want = capsys.readouterr().out
    for extra in (["--backend", "spmd"], ["--prepare", "jax"]):
        assert cli.main(base + extra + ["--device", "cpu"]) == 0
        assert capsys.readouterr().out == want
    assert "CALL\t0\t18\t12\t0\tfuncA\t6.000000" in want


@pytest.mark.parametrize("phase", ["consume", "finish", "prepare"])
def test_kernel_error_propagates(corpus, monkeypatch, phase):
    """A KernelError of the fused step's launch (prepare phase), a device
    fault at its read-back (lookup phase) and a KernelError of the device
    prepare propagate; none becomes an ``Error:`` line."""
    d, texts = corpus

    def refused(*a, **kw):
        raise tilejoin.KernelError("launch refused")

    def faulty(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    kw = dict(backend="spmd")
    if phase == "consume":
        monkeypatch.setattr(tilejoin, "probe_answer", refused)
    elif phase == "finish":
        monkeypatch.setattr(annotate_step, "read_candidates", faulty)
    else:
        from kmergutsjava_tpu_torch.ops import kmer_windows

        monkeypatch.setattr(kmer_windows, "window_values", refused)
        kw = dict(backend="xla", prepare_impl="jax")
    out = io.StringIO()
    with pytest.raises(tilejoin.KernelError,
                       match="read-back failed" if phase == "finish"
                       else "launch refused"):
        Engine(EngineConfig(aa=True, device="cpu", debug=True, **kw)).run(
            d, None, out, stdout=True,
            query_stream=io.StringIO(texts["aa"]))
    assert "Error:" not in out.getvalue()
