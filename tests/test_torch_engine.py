"""The PyTorch package's Engine and CLI, on the CPU, against the JAX
package: the 800-protein corpus report must equal golden_aa_800 and the JAX
Engine's report byte for byte, through the sparse path, the stream path,
the merge-join block probe (``pallas``), the parity backend, a truncated
table and the debug info lines; in DNA mode the 300 kbp contig's report must
equal golden_dna_800 and the JAX Engine's through every backend, with `auto`
deciding from a stream (upgrading mid-prepare), from a file's size, and
below the density crossover (the sparse one-shot lookup). A table past the
block probe's 128-slot window gives the JAX engine's `Error:` line. Also:
the port imports neither jax nor the JAX package, a kernel fault
propagates, and a CUDA device without CUDA raises."""
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
from kmergutsjava_tpu_torch.lookup import blockprobe, stream, tilejoin
from kmergutsjava_tpu_torch.models import pipeline
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


def _port(data_dir, fasta, aa=True, **kw):
    out = io.StringIO()
    Engine(EngineConfig(aa=aa, device="cpu", **kw)).run(
        data_dir, None, out, stdout=True, query_stream=io.StringIO(fasta))
    return out.getvalue()


def _jax(data_dir, fasta, aa=True, **kw):
    out = io.StringIO()
    JaxEngine(JaxConfig(aa=aa, **kw)).run(
        data_dir, None, out, stdout=True, query_stream=io.StringIO(fasta))
    return out.getvalue()


@pytest.fixture(scope="module")
def dna(corpus):
    """The 300 kbp contig of golden_dna_800 (against the same 800-protein
    table), as text, as a file, its golden and the JAX Engine's auto
    report."""
    d, _, _, _ = corpus
    _, contig = load_corpus(0, 300_000)
    fasta = f">{contig.id} {contig.descr}\n{contig.seq}\n"
    fna = os.path.join(d, "contig.fna")
    with open(fna, "w") as fh:
        fh.write(fasta)
    with gzip.open(corpus_path("golden_dna_800.txt.gz"), "rt") as fh:
        golden = fh.read()
    return d, fasta, fna, golden, _jax(d, fasta, aa=False)


@pytest.fixture
def spy(monkeypatch):
    """Counts the one-shot and streaming lookups' calls by kind."""
    from kmergutsjava_tpu_torch.lookup.blockprobe import BlockProbeLookup
    from kmergutsjava_tpu_torch.lookup.sparse import SparseLookup
    from kmergutsjava_tpu_torch.lookup.stream import StreamLookup

    calls = {"stream_pass": 0, "sparse_lookup": 0, "parity": 0,
             "block_lookup": 0}

    def wrap(owner, name, key):
        orig = getattr(owner, name)

        def counted(*a, **kw):
            calls[key] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(owner, name, counted)

    wrap(StreamLookup, "_probe", "stream_pass")
    wrap(SparseLookup, "lookup", "sparse_lookup")
    wrap(BlockProbeLookup, "lookup", "block_lookup")
    wrap(pipeline, "lookup_stream", "parity")
    return calls


@pytest.mark.parametrize("backend", ["auto", "xla", "stream", "pallas",
                                     "parity"])
def test_engine_matches_golden_and_jax(corpus, backend):
    d, fasta, _, golden = corpus
    got = _port(d, fasta, backend=backend)
    assert got == golden
    if backend in ("xla", "pallas"):
        assert got == _jax(d, fasta, backend=backend)


@pytest.mark.parametrize("backend", ["auto", "stream", "xla", "pallas",
                                     "parity"])
def test_dna_engine_matches_golden_and_jax(dna, spy, backend):
    """A stream input: `auto` buffers, crosses numSigs/2.5 mid-prepare and
    upgrades to the stream path, as the JAX Engine does. The block probe
    (`pallas`) buffers and runs one plane pass; its exact rest is the only
    one-shot sparse lookup."""
    d, fasta, _, golden, jax_report = dna
    got = _port(d, fasta, aa=False, backend=backend)
    assert got == golden
    assert got == jax_report
    assert (spy["stream_pass"] > 0) == (backend in ("auto", "stream"))
    assert spy["block_lookup"] == (backend == "pallas")
    assert spy["sparse_lookup"] == 0 or backend == "pallas"


@pytest.mark.parametrize("backend,prepare", [("auto", "native"),
                                             ("auto", "numpy"),
                                             ("stream", "numpy"),
                                             ("xla", "numpy")])
def test_dna_cli_matches_golden(dna, spy, tmp_path, backend, prepare):
    """A file input: `auto` decides from its size (stream for this contig),
    through both prepare implementations."""
    d, _, fna, golden, _ = dna
    out = tmp_path / "report.txt"
    before = stream.launches
    assert cli.main(["-D", d, "-q", fna, "-o", str(out), "--device", "cpu",
                     "--backend", backend, "--prepare", prepare]) == 0
    assert out.read_text() == golden
    assert stream.launches == before  # the CPU runs the twin
    assert (spy["stream_pass"] > 0) == (backend != "xla")


@pytest.mark.parametrize("aa", [True, False])
def test_stream_device_stages_in_three_passes_match_jax(corpus, dna, spy,
                                                        monkeypatch, aa):
    """The stream backend on the CPU runs its device path through the
    twins of the scatter and resolve kernels (a set's tiles, occupancy and
    answers are tensors; only slots reach the host decode). With the feed
    cut into small chunks and a small input_size_limit, it runs three plane
    passes and more, and its report equals the golden and the JAX
    Engine's, byte for byte."""
    from functools import partial

    from kmergutsjava_tpu_torch.lookup import stream_tiles
    from kmergutsjava_tpu_torch.models import prepare
    from kmergutsjava_tpu_torch.utils import timing

    monkeypatch.setattr(prepare, "try_prepare_bulk",
                        partial(prepare.try_prepare_bulk, flush_chars=30_000))
    if aa:
        d, fasta, _, golden = corpus
        want, kw = golden, {}
    else:
        d, fasta, _, golden, want = dna
        kw = {"prepare_impl": "numpy"}
    before = (stream_tiles.scatter_launches, stream_tiles.resolve_launches)
    got = _port(d, fasta, aa=aa, backend="stream", input_size_limit=60_000,
                **kw)
    counters = timing.recent_runs()[-1]["counters"]
    assert counters["stream.passes"] == spy["stream_pass"] >= 3
    assert counters["stream.bytes_up"] == 8 * counters["stream.queries"]
    assert counters["stream.fallback_queries"] > 0
    assert (stream_tiles.scatter_launches,
            stream_tiles.resolve_launches) == before  # the twins ran
    assert got == golden
    assert got == want


def test_dna_stream_multipass_matches_golden(dna, spy):
    """A small input_size_limit (-l) makes the stream path run a plane pass
    per 50,000 queries (at the numpy prepare's per-frame batches): the
    report does not change."""
    d, fasta, _, golden, _ = dna
    got = _port(d, fasta, aa=False, backend="stream", prepare_impl="numpy",
                input_size_limit=50_000)
    assert spy["stream_pass"] >= 3
    assert got == golden


@pytest.mark.parametrize("backend", ["pallas", "parity"])
def test_dna_store_spills_match_golden(dna, monkeypatch, backend):
    """A small input_size_limit (-l) makes the bounded-RAM store, which
    feeds the block probe and the parity scan, spill sorted runs and merge
    them in a cascade: the report does not change."""
    from kmergutsjava_tpu_torch.lookup.store import QueryKmerStore

    spills = []
    orig = QueryKmerStore._spill

    def counted(self):
        spills.append(len(self._batches))
        return orig(self)

    monkeypatch.setattr(QueryKmerStore, "_spill", counted)
    d, fasta, _, golden, _ = dna
    got = _port(d, fasta, aa=False, backend=backend, prepare_impl="numpy",
                input_size_limit=50_000)
    assert len(spills) >= 3
    assert got == golden


def test_dna_debug_report_matches_jax(dna):
    """Debug mode through `auto`'s upgrade to the stream path: info lines,
    table info and the kmers-found count equal the JAX Engine's."""
    d, fasta, _, _, _ = dna

    def masked(text):
        return re.sub(r"time=\d+ ms|: \d+ ms\.", "<t>", text)

    got = _port(d, fasta, aa=False, debug=True)
    assert "Kmers found: " in got and "TRANSLATION\t" in got
    assert masked(got) == masked(_jax(d, fasta, aa=False, debug=True))


def test_dna_stdin_below_crossover_finishes_sparse(dna, spy):
    """A stream input that stays under numSigs/2.5 queries finishes on the
    sparse one-shot lookup, not the parity scan (the JAX Engine's
    _DeferredAutoFeed.finish -> _lookup with backend xla)."""
    d, fasta, _, _, _ = dna
    head, seq = fasta.split("\n", 1)
    small = head + "\n" + seq[:20_000] + "\n"
    got = _port(d, small, aa=False)
    assert spy == {"stream_pass": 0, "sparse_lookup": 1, "parity": 0,
                   "block_lookup": 0}
    assert got == _jax(d, small, aa=False)
    assert "CALL" in got


@pytest.mark.parametrize("backend", ["stream", "auto"])
def test_stream_kernel_error_is_not_turned_into_a_report(dna, monkeypatch,
                                                         backend):
    """A stream kernel fault (or a device fault surfacing as a torch
    RuntimeError at a pass) propagates as a KernelError instead of becoming
    an 'Error:' line; `auto` never retries on the sparse path."""
    from kmergutsjava_tpu_torch.lookup.stream import StreamLookup

    d, fasta, _, _, _ = dna

    def broken(*a, **kw):
        raise tilejoin.KernelError("launch refused")

    monkeypatch.setattr(StreamLookup, "_probe", broken)
    with pytest.raises(tilejoin.KernelError, match="launch refused"):
        _port(d, fasta, aa=False, backend=backend)
    monkeypatch.undo()

    def faulty(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(stream, "stream_probe", faulty)
    with pytest.raises(tilejoin.KernelError, match="pass failed"):
        _port(d, fasta, aa=False, backend=backend)


def test_stream_backend_falls_back_to_parity_past_window_64(tmp_path):
    """max_probe over 64 is a table the stream path cannot serve: a
    ValueError, so the run degrades to the parity scan with a warning, as
    in the JAX package."""
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
    for i in range(100):
        slots["kmer"][i] = i * num_sigs  # one 100-slot probe chain
    write_table(str(tmp_path / TABLE_FILE),
                KmerTable(slots=slots, num_sigs=num_sigs))
    write_function_index(str(tmp_path / "function.index"), ["f0"])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = _port(str(tmp_path), ">P1\nACDEFGHIKLMNPQRSTVWY\n",
                    backend="stream")
    assert any("stream backend unavailable" in str(x.message) for x in w)
    assert "PROTEIN-ID\tP1\t20" in got


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
    # auto on a small stream input finishes on the sparse one-shot lookup,
    # which reports its progress, as the JAX Engine's does
    assert "Processed: 100%" in got
    assert masked(got) == masked(_jax(d, fasta, debug=True, min_hits=1))


def _masked(text):
    return re.sub(r"time=\d+ ms|: \d+ ms\.", "<t>", text)


def test_pallas_debug_report_matches_jax(corpus):
    """Debug mode through the block probe: the kmers-found line and the
    info lines equal the JAX Engine's pallas run; neither writes progress
    lines."""
    d, fasta, _, _ = corpus
    fasta = ">" + ">".join(fasta.split(">")[1:16])
    got = _port(d, fasta, debug=True, min_hits=1, backend="pallas")
    assert "Kmers found: " in got and "Processed:" not in got
    assert _masked(got) == _masked(_jax(d, fasta, debug=True, min_hits=1,
                                        backend="pallas"))


def test_cli_pallas_matches_jax_cli_and_parity(corpus, tmp_path, capsys):
    """`--backend pallas --device cpu` through the CLI: byte-identical to
    the JAX CLI's `--backend pallas` and to the port's `--backend parity`."""
    from kmergutsjava_tpu import cli as jax_cli

    d, _, faa, golden = corpus
    runs = {"pallas": (cli.main, "pallas", ["--device", "cpu"]),
            "parity": (cli.main, "parity", ["--device", "cpu"]),
            "jax": (jax_cli.main, "pallas", [])}
    got = {}
    for name, (main, backend, extra) in runs.items():
        out = tmp_path / f"{name}.txt"
        assert main(["-a", "-D", d, "-q", faa, "-o", str(out), "--backend",
                     backend, *extra]) == 0
        got[name] = out.read_text()
    assert got["pallas"] == got["jax"] == got["parity"] == golden


def _one_chain_table(path, chain, num_sigs=600):
    """A data dir whose table holds one ``chain``-slot probe chain."""
    import numpy as np

    from kmergutsjava_tpu_torch.constants import EMPTY_KMER
    from kmergutsjava_tpu_torch.formats.function_index import \
        write_function_index
    from kmergutsjava_tpu_torch.formats.kmer_table import (KmerTable,
                                                           SLOT_DTYPE,
                                                           write_table)

    slots = np.zeros(num_sigs, dtype=SLOT_DTYPE)
    slots["kmer"] = EMPTY_KMER
    slots["kmer"][:chain] = np.arange(chain) * num_sigs
    write_table(str(path / TABLE_FILE),
                KmerTable(slots=slots, num_sigs=num_sigs))
    write_function_index(str(path / "function.index"), ["f0"])
    return str(path)


def test_pallas_window_past_128_reports_the_jax_error(tmp_path):
    """max_probe 150 is past the block probe's 128-slot window: the
    constructor's ValueError is raised inside the lookup phase and becomes
    the JAX engine's `Error:` line and an empty hit set, not a parity
    fallback."""
    d = _one_chain_table(tmp_path, 150)
    query = ">P1\nACDEFGHIKLMNPQRSTVWY\n"
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = _port(d, query, backend="pallas", debug=True)
    assert not any("parity" in str(x.message) for x in w)
    assert "Error: max_probe exceeds kernel halo" in got
    assert "Kmers found: 0 (pos-count=0)" in got
    assert _masked(got) == _masked(_jax(d, query, backend="pallas",
                                        debug=True))


@pytest.mark.parametrize("fault", ["kernel", "device"])
def test_block_probe_error_is_not_turned_into_a_report(corpus, monkeypatch,
                                                       fault):
    """A KernelError from the block-probe wrapper, or a device fault
    surfacing as a torch RuntimeError at its pass, propagates as a
    KernelError instead of becoming an `Error:` line."""
    def broken(*a, **kw):
        if fault == "kernel":
            raise tilejoin.KernelError("launch refused")
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(blockprobe, "block_probe", broken)
    d, fasta, _, _ = corpus
    with pytest.raises(tilejoin.KernelError,
                       match="launch refused" if fault == "kernel"
                       else "pass failed"):
        _port(d, fasta, backend="pallas")


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
        monkeypatch.setattr(sparse.tilejoin, "probe_answer", faulty)
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


@pytest.mark.parametrize("argv", [["-D", "x", "--platform", "tpu"],
                                  ["-a", "-D", "x", "--device", "cpu",
                                   "--platform", "gpu,cpu"],
                                  ["-a", "-D", "x", "--platform", "cpu",
                                   "--device", "cuda:0"],
                                  ["-a", "-D", "x", "--grouping", "tree"]])
def test_cli_rejects_unported_options(argv, capsys):
    """Every flag of the JAX CLI is parsed now; what the port cannot run
    is a usage error (exit 2, an Error: line and the usage): a platform
    other than the CPU or the card, a --platform that contradicts
    --device, a grouping other than host or scan."""
    assert cli.main(argv) == 2
    out = capsys.readouterr().out
    assert out.startswith("Error: ") and "Usage: kmer_guts" in out
    assert ("platform" in out.splitlines()[0]
            or "ROADMAP.md" in out.splitlines()[0])


@pytest.mark.parametrize("argv, device", [
    (["--platform", "cpu"], "cpu"), (["--platform", "cpu,tpu"], "cpu"),
    (["--platform", "gpu"], "cuda"), (["--platform", "cuda"], "cuda"),
    (["--device", "cuda:1", "--platform", "gpu"], "cuda:1"),
    (["--platform", "cpu", "--device", "cpu"], "cpu"), ([], "cuda")])
def test_cli_platform_pins_the_device(argv, device):
    cfg = cli.parse_args(["-D", "x"] + argv)[0]
    assert cfg.device == device


@pytest.mark.parametrize("argv, sort, dsort", [
    ([], None, None), (["--sort-chunks", "1"], True, None),
    (["--sort-chunks", "0"], False, None), (["--sort-chunks", "yes"], False,
                                            None),
    (["--sort-chunks", "1", "--device-sort"], True, True),
    (["--device-sort"], None, True)])
def test_cli_sort_flags_set_the_config(argv, sort, dsort):
    """As the JAX CLI: --sort-chunks X is X == "1", --device-sort sets the
    device sort (it acts only with the chunk sort)."""
    cfg = cli.parse_args(["-D", "x"] + argv)[0]
    assert (cfg.sort_chunks, cfg.device_sort) == (sort, dsort)


@pytest.mark.parametrize("flags", [["--sort-chunks", "1"],
                                   ["--sort-chunks", "1", "--device-sort"],
                                   ["--sort-chunks", "0", "--device-sort"],
                                   ["--platform", "cpu"]])
def test_cli_sort_and_platform_flags_keep_the_report(corpus, tmp_path,
                                                     capsys, flags):
    """The proteome through xla in chunks of 4,096 queries, each home-sorted
    on the host or on the device: the golden report, as without the flags;
    --platform cpu runs on the CPU (no --device given)."""
    d, _, faa, golden = corpus
    device = [] if "--platform" in flags else ["--device", "cpu"]
    assert cli.main(["-a", "-D", d, "-q", faa, "--backend", "xla",
                     "--chunk", "4096"] + device + flags) == 0
    assert capsys.readouterr().out == golden


def test_sorted_chunks_reach_the_probe_in_home_order(corpus, monkeypatch):
    """--sort-chunks 1 hands B1 each chunk in (stable) home order, from the
    host sort or, with --device-sort, from the device's; without it the
    engine's order. Reports are equal in all three."""
    from kmergutsjava_tpu_torch.lookup import sparse

    seen = []
    real = sparse.tilejoin.probe_answer

    def spy(fp, q_fp, homes, w):
        seen.append(homes.clone())
        return real(fp, q_fp, homes, w)

    monkeypatch.setattr(sparse.tilejoin, "probe_answer", spy)
    d, fasta, _, golden = corpus
    for kw, ordered in ((dict(), False), (dict(sort_chunks=True), True),
                        (dict(sort_chunks=True, device_sort=True), True)):
        seen.clear()
        assert _port(d, fasta, backend="xla", lookup_chunk=4096,
                     **kw) == golden
        assert len(seen) > 3
        assert all(bool((h[1:] >= h[:-1]).all()) == ordered or len(h) < 2
                   for h in seen[:-1])


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
    assert int(n) >= 50  # the fused path's ops/, parallel/ and spmd too
    assert bad.strip() == "[]"
