"""The port's meshes (kmergutsjava_tpu_torch/parallel/mesh.py), their
collectives, the ``--mesh`` CLI flag and the engine's mesh modes on the
CPU, against the JAX package on its eight virtual CPU devices
(tests/conftest.py). The port's meshes take ``mesh_devices`` of eight CPU
positions (the same device repeated: several shards on one device, each
position with its own stream, None on the CPU), the counterpart of the JAX
tests' forced host devices.

Held here: ``make_mesh``/``default_mesh_shape`` as the JAX functions
(including the ``need N devices, have M`` error), the device list of a
config (one CPU without a list; a list of the wrong kind refused), psum,
all_to_all and fetch_global over repeated devices, exact; reports
byte-identical to the JAX Engine with the same ``mesh_shape`` for ``auto``
with a mesh (its sparse side routed, its dense side the sharded stream
path), for a mesh of 16 on 8 devices through every mesh-taking backend
(the ``Error:`` lines and the fallbacks, in debug mode so that they show),
for debug mode (where ``kmers_found`` is computed by some backends and not
others) and for a truncated table; and the CLI's ``--mesh``."""
import io
import os
import re
import shutil
import warnings

import numpy as np
import pytest
import torch

from kmergutsjava_tpu.config import EngineConfig as JaxConfig
from kmergutsjava_tpu.models.pipeline import Engine as JaxEngine
from kmergutsjava_tpu.parallel import mesh as jax_mesh
from kmergutsjava_tpu_torch import cli
from kmergutsjava_tpu_torch.config import EngineConfig
from kmergutsjava_tpu_torch.formats.kmer_table import TABLE_FILE
from kmergutsjava_tpu_torch.models import pipeline
from kmergutsjava_tpu_torch.models.pipeline import Engine
from kmergutsjava_tpu_torch.parallel import mesh

from corpus_util import build_corpus_data_dir, load_corpus
from test_end_to_end import _strip_info

CPU8 = ["cpu"] * 8  # the JAX tests' eight host devices


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The 300-protein corpus table (tests/corpus_util.py), its proteins as
    aa queries, the first 30 kbp of the genome as a DNA query, the first 4
    proteins (debug runs, whose HIT lines are slow in both packages) and
    the first 20 in a file (sparse against the table: ``auto`` routes)."""
    return make_corpus(tmp_path_factory.mktemp("mesh"))


def make_corpus(tmp):
    prots, contig = load_corpus(300, 30_000)
    d = str(tmp / "d")
    build_corpus_data_dir(d, prots)
    aa = "".join(f">{p.id} {p.descr}\n{p.seq}\n" for p in prots)
    dna = f">{contig.id} {contig.descr}\n{contig.seq}\n"
    few = str(tmp / "few.faa")
    with open(few, "w") as fh:
        fh.write("".join(f">{p.id} {p.descr}\n{p.seq}\n" for p in prots[:20]))
    debug = "".join(f">{p.id} {p.descr}\n{p.seq}\n" for p in prots[:4])
    return d, {"aa": aa, "dna": dna, "few": debug}, few


def port_report(d, fasta, aa, query=None, **kw):
    """The port's report on the CPU, its mesh over eight CPU positions."""
    kw.setdefault("mesh_devices", CPU8)
    out = io.StringIO()
    Engine(EngineConfig(aa=aa, device="cpu", **kw)).run(
        d, query, out, stdout=True,
        query_stream=None if query else io.StringIO(fasta))
    return out.getvalue()


def jax_report(d, fasta, aa, query=None, **kw):
    out = io.StringIO()
    JaxEngine(JaxConfig(aa=aa, **kw)).run(
        d, query, out, stdout=True,
        query_stream=None if query else io.StringIO(fasta))
    return out.getvalue()


def both(d, fasta, aa, **kw):
    """(port, JAX) reports, debug timing lines stripped; warnings (the
    parity fallbacks) silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = port_report(d, fasta, aa, **kw)
        want = jax_report(d, fasta, aa,
                          **{k: v for k, v in kw.items()
                             if k != "mesh_devices"})
    if kw.get("debug"):
        got, want = _strip_info(got), _strip_info(want)
    return got, want


def test_make_mesh_and_default_shape():
    """Grids row by row, the JAX function's shape rule and its error."""
    devs = [torch.device("cpu")] * 8
    m = mesh.make_mesh(2, 4, devs)
    assert m.shape == {"data": 2, "table": 4}
    assert m.positions() == [(d, t) for d in range(2) for t in range(4)]
    assert all(s is None for row in m.streams for s in row)
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        mesh.make_mesh(4, 4, devs)
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        jax_mesh.make_mesh(4, 4)
    for n in range(1, 10):
        assert mesh.default_mesh_shape(n) == jax_mesh.default_mesh_shape(n)


def test_mesh_devices_of_a_config():
    """One CPU without a list; the list as given, repeats kept; a device
    of another kind than the config's is refused (a cuda mesh never
    places a shard on the CPU)."""
    assert mesh.mesh_devices("cpu") == [torch.device("cpu")]
    assert mesh.mesh_devices("cpu", CPU8) == [torch.device("cpu")] * 8
    with pytest.raises(ValueError, match=r"\['cpu'\] are not cuda devices"):
        mesh.mesh_devices("cuda", ["cuda:0", "cpu"])
    with pytest.raises(ValueError, match="not cpu devices"):
        mesh.mesh_devices("cpu", ["cuda:0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            mesh.mesh_devices("cuda")


def test_collectives_over_repeated_devices():
    """psum, all_to_all and fetch_global on a mesh whose positions share
    one device: exact sums, one copy per (source, destination), rows read
    back in order."""
    rng = np.random.default_rng(3)
    m = mesh.make_mesh(2, 4, [torch.device("cpu")] * 8)
    parts = [[torch.from_numpy(rng.integers(0, 1000, 64).astype(np.int32))
              for _ in range(4)] for _ in range(2)]
    want = [sum(p.numpy().astype(np.int64) for p in row) for row in parts]
    rows = [mesh.psum(m, d, [p.clone() for p in parts[d]]) for d in range(2)]
    np.testing.assert_array_equal(mesh.fetch_global(m, rows),
                                  np.concatenate(want))
    line = mesh.make_mesh(1, 4, [torch.device("cpu")] * 4)
    sends = [[torch.full((3,), 10 * s + t, dtype=torch.int32)
              for t in range(4)] for s in range(4)]
    outs = [torch.zeros((4, 3), dtype=torch.int32) for _ in range(4)]
    mesh.all_to_all(line, sends, outs)
    for t in range(4):
        for s in range(4):
            assert outs[t][s].tolist() == [10 * s + t] * 3
    src = torch.arange(5)
    moved = mesh.move(src, line.at(0, 0), line.at(0, 1))
    assert moved is src  # the same device: no copy


@pytest.mark.parametrize("mode", ["aa", "dna"])
def test_auto_with_mesh_reports_equal_jax(corpus, mode):
    """``auto`` with ``--mesh 2x2`` from stdin (the deferred choice: the
    whole query set is dense against this table, so the sharded stream
    path) and, in aa mode, from a small file (sparse: the routed
    lookup): the JAX engine's reports."""
    d, texts, few = corpus
    kw = dict(backend="auto", mesh_shape=(2, 2), min_hits=2)
    got, want = both(d, texts[mode], mode == "aa", **kw)
    assert got == want and "CALL\t" in got
    if mode == "aa":
        got = port_report(d, None, True, query=few, **kw)
        lk = next(iter(pipeline._LOOKUP_CACHE.values()))
        assert type(lk).__name__ == "RoutedLookup"
        assert got == jax_report(d, None, True, query=few, **kw)
        assert "CALL\t" in got


@pytest.mark.parametrize("backend", ["sharded", "routed", "replicated",
                                     "xla", "stream", "spmd", "auto"])
def test_mesh_of_16_on_8_devices(corpus, backend):
    """A 4x4 mesh on eight devices, in debug mode (so that the info lines
    reach the report): the mesh lookups write the JAX engine's ``Error:
    need 16 devices, have 8`` and group no hits; ``xla`` keeps one device,
    ``stream`` takes the eight there are, ``spmd`` falls back to the
    parity scan and ``auto`` routes (sparse file) to the error; each report
    equals the JAX engine's."""
    d, texts, few = corpus
    kw = dict(backend=backend, mesh_shape=(4, 4), min_hits=2, debug=True)
    if backend == "auto":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = _strip_info(port_report(d, None, True, query=few, **kw))
            want = _strip_info(jax_report(d, None, True, query=few, **kw))
    else:
        got, want = both(d, texts["few"], True, **kw)
    assert got == want
    if backend in ("sharded", "routed", "replicated", "auto"):
        assert "Error: need 16 devices, have 8" in got
        assert "CALL\t" not in got
    else:
        assert "Error:" not in got and "CALL\t" in got


@pytest.mark.parametrize("backend", ["sharded", "routed", "replicated"])
def test_mesh_lookups_debug_equal_jax(corpus, backend):
    """Debug mode, where the mesh lookups' ``kmers_found`` comes from
    different code (computed always by routed and replicated, only in
    debug by sharded): HIT lines and the "Kmers found" line as the JAX
    engine's."""
    d, texts, _ = corpus
    got, want = both(d, texts["few"], True, backend=backend, min_hits=2,
                     debug=True)
    assert got == want
    assert "Kmers found:" in got and "HIT\t" in got


def test_truncated_table_with_mesh_matches_jax(tmp_path, corpus):
    """A truncated table never reaches a mesh: the parity scan's partial
    results and the "Error: null" line, as the JAX engine's."""
    d, texts, _ = corpus
    small = tmp_path / "trunc"
    small.mkdir()
    for name in os.listdir(d):
        if name.startswith(("kmer.table", "function")):
            shutil.copy(os.path.join(d, name), small / name)
    path = small / TABLE_FILE
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 2)
    os.remove(small / "kmer.table.meta.json")

    def masked(text):
        return re.sub(r": \d+ ms\.", "<t>", text)

    for backend in ("sharded", "routed"):
        got, want = both(str(small), texts["few"], True, backend=backend,
                         mesh_shape=(2, 2), min_hits=2, debug=True)
        assert "Error: null" in got
        assert masked(got) == masked(want)


def test_cli_mesh_flag(tmp_path, corpus, capsys):
    """``--mesh DxT`` parses as the JAX CLI's; with ``--device cuda`` on a
    machine without CUDA the run raises (no quiet fall back to the CPU);
    the other TPU flags are still refused with a pointer to ROADMAP.md."""
    d, _, few = corpus
    cfg, *_ = cli.parse_args(["-a", "-D", d, "--mesh", "4x2", "--backend",
                              "sharded"])
    assert cfg.mesh_shape == (4, 2) and cfg.backend == "sharded"
    assert cfg.mesh_devices is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cli.main(["-a", "-D", d, "-q", few, "--mesh", "1x1",
                      "--device", "cuda"])
    # one CPU: a 1x1 mesh through the CLI equals the JAX CLI's report
    out = tmp_path / "o.txt"
    assert cli.main(["-a", "-D", d, "-q", few, "--mesh", "1x1", "--backend",
                     "routed", "--device", "cpu", "-o", str(out)]) == 0
    assert out.read_text() == jax_report(d, None, True, query=few,
                                         backend="routed",
                                         mesh_shape=(1, 1))
    capsys.readouterr()
    for bad in ("2", "0x2", "2x-1"):
        assert cli.main(["-a", "-D", d, "--mesh", bad]) == 2
        assert "Error:" in capsys.readouterr().out
