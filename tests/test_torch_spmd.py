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
propagates and is never an ``Error:`` line.

On a mesh (the JAX package's eight virtual CPU devices; the port's
``mesh_devices`` of eight CPU positions) the step is the JAX step's body:
its int32 answer equals the JAX ``make_sharded_annotate_step``'s,
``make_sharded_dna_step``'s and ``make_windowed_dna_step``'s bit for bit at
(2, 2) and (4, 2), and reports with ``mesh_shape`` (2, 2), (4, 2) and
(1, 8), long records through windows and debug mode included, equal the
JAX engine's."""
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
from kmergutsjava_tpu_torch.parallel import annotate_step, seq_windows
from kmergutsjava_tpu_torch.parallel import mesh as port_mesh

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
    """``--prepare jax`` (the window kernel's ragged entry) feeding each
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
    consecutive contigs share a launch (the launch budget shrunk here so
    that several launches occur); the containers equal the JAX's."""
    _, texts = corpus
    monkeypatch.setattr(prepare, "VALUES_LAUNCH_BYTES", 3000)
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
        from kmergutsjava_tpu_torch.parallel import fused_probe

        monkeypatch.setattr(fused_probe, "first_event", refused)
    elif phase == "finish":
        monkeypatch.setattr(annotate_step, "read_candidates", faulty)
    else:
        from kmergutsjava_tpu_torch.ops import kmer_windows

        monkeypatch.setattr(kmer_windows, "ragged_values", refused)
        kw = dict(backend="xla", prepare_impl="jax")
    out = io.StringIO()
    with pytest.raises(tilejoin.KernelError,
                       match="read-back failed" if phase == "finish"
                       else "launch refused"):
        Engine(EngineConfig(aa=True, device="cpu", debug=True, **kw)).run(
            d, None, out, stdout=True,
            query_stream=io.StringIO(texts["aa"]))
    assert "Error:" not in out.getvalue()


CPU8 = ["cpu"] * 8


def _mesh_batch(texts, mode, width):
    """One batch of rows as the fused step takes them: the first 13
    records (not a multiple of the data axis, so that padding rows occur)
    cut to ``width``."""
    recs = _records(texts[mode])[:13]
    mat = np.zeros((len(recs), width), np.uint8)
    lens = np.zeros(len(recs), np.int64)
    for i, r in enumerate(recs):
        a = np.frombuffer(r.seq[:width].encode(), np.uint8)
        mat[i, :len(a)] = a
        lens[i] = len(a)
    return mat, lens


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
@pytest.mark.parametrize("mode", ["aa", "dna", "windows"])
def test_mesh_step_answers_equal_jax_step(corpus, mode, shape):
    """The port's mesh step (window kernel's twin and B12's twin on every
    position, the sum over the table axis) against the JAX sharded step on
    a mesh of the same shape: the int32 slot + 1 of every window, bit for
    bit."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kmergutsjava_tpu.parallel import annotate_step as jax_step
    from kmergutsjava_tpu.parallel import seq_windows as jax_windows
    from kmergutsjava_tpu.parallel.mesh import make_mesh

    d, texts = corpus
    path = os.path.join(d, TABLE_FILE)
    jt, pt = jax_read_table(path), read_table(path)
    pt.compute_max_probe()
    pw = max(8, pt.max_probe)
    jm = make_mesh(*shape)
    m = port_mesh.make_mesh(*shape, devices=port_mesh.mesh_devices(
        "cpu", CPU8))
    if mode == "windows":
        contig = np.frombuffer(_records(texts["dna"])[-2].seq.encode(),
                               np.uint8)
        plan = seq_windows.plan_windows(len(contig), 150)
        n = len(plan["s"])
        mat = np.full((n, 150), ord("N"), np.uint8)
        for i in range(n):
            mat[i, :plan["len_w"][i]] = contig[plan["s"][i]:plan["e"][i]]
        cols = [plan[k].astype(np.int32) for k in
                ("len_w", "row_map", "own_start", "own_end")]
        n_pad = -(-n // shape[0]) * shape[0]
        pad = [np.concatenate([x, np.zeros((n_pad - n, *x.shape[1:]),
                                           x.dtype)]) for x in [mat, *cols]]
        jstep, jplanes = jax_windows.make_windowed_dna_step(jm, jt, pw, 150)
        specs = [P("data", None), P("data"), P("data", None),
                 P("data", None), P("data", None)]
        want = np.asarray(jax.device_get(jstep(jplanes["fp"], *(
            jax.device_put(x, NamedSharding(jm, sp))
            for x, sp in zip(pad, specs)))))[:n]
        _, planes = annotate_step.make_sharded_dna_step(m, pt, pw)
        step, planes = seq_windows.make_sharded_windowed_dna_step(
            m, pt, pw, 150, planes)
        got = step(planes["fp"], mat, *cols).read()
    else:
        aa = mode == "aa"
        mat, lens = _mesh_batch(texts, mode, 256 if aa else 300)
        make_j = (jax_step.make_sharded_annotate_step if aa
                  else jax_step.make_sharded_dna_step)
        jstep, jplanes = make_j(jm, jt, pw)
        n_pad = -(-len(mat) // shape[0]) * shape[0]
        pm = np.zeros((n_pad, mat.shape[1]), np.uint8)
        pm[:len(mat)] = mat
        pl = np.zeros(n_pad, np.int64)
        pl[:len(lens)] = lens
        want = np.asarray(jax.device_get(jstep(
            jplanes["fp"], jax.device_put(pm, NamedSharding(jm, P("data",
                                                                  None))),
            jax.device_put(pl, NamedSharding(jm, P("data"))))))[:len(mat)]
        make_p = (annotate_step.make_sharded_annotate_step if aa
                  else annotate_step.make_sharded_dna_step)
        step, planes = make_p(m, pt, pw)
        got = step(planes["fp"], mat, lens).read()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 20


@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (1, 8)])
@pytest.mark.parametrize("mode", ["aa", "dna"])
def test_spmd_mesh_reports_equal_jax(corpus, short_long, mode, shape):
    """``--backend spmd`` with a mesh, long records through windows: the
    JAX engine's report with the same mesh shape; in debug mode too at
    (2, 2)."""
    d, texts = corpus
    aa = mode == "aa"
    for debug in ((False, True) if shape == (2, 2) else (False,)):
        kw = dict(backend="spmd", mesh_shape=shape, min_hits=2, debug=debug)
        got = _port(d, texts[mode], aa, mesh_devices=CPU8, **kw)
        want = _jax(d, texts[mode], aa, **kw)
        if debug:
            got, want = _strip_info(got), _strip_info(want)
        assert got == want and "CALL\t" in got
