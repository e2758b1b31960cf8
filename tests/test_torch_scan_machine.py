"""The port's call-grouping machine (B11, kmergutsjava_tpu_torch/calls/
scan_machine.py) against the JAX package's ``calls/scan_machine.py``, exact:
the plain twin per step against the JAX ``scan_containers`` (appended and
emit flags at every step, the call record where a step emits) on seeded
ragged batches; ``gather_hits_scan_batch`` against the JAX one, the exact
host machine and the independent oracle; and the engine with
``grouping_impl="scan"`` against the JAX engine's and against host
grouping, in aa and DNA mode."""
import io
import random

import numpy as np
import pytest
import torch

from java_oracle import oracle_gather_hits
from kmergutsjava_tpu.calls import scan_machine as jax_scan
from kmergutsjava_tpu.calls.grouping import GroupingParams as JaxParams
from kmergutsjava_tpu.config import EngineConfig as JaxConfig
from kmergutsjava_tpu.models.pipeline import Engine as JaxEngine
from kmergutsjava_tpu_torch import cli
from kmergutsjava_tpu_torch.calls import scan_machine
from kmergutsjava_tpu_torch.calls.grouping import (GroupingParams, Report,
                                                   _otu_add_batch,
                                                   gather_hits)
from kmergutsjava_tpu_torch.config import EngineConfig
from kmergutsjava_tpu_torch.formats.table_tools import (signatures_from_proteins,
                                                        write_data_dir)
from kmergutsjava_tpu_torch.lookup.tilejoin import KernelError
from kmergutsjava_tpu_torch.models.pipeline import Engine

FUNCS = [f"fn{i}" for i in range(8)]
AA = "ACDEFGHIKLMNPQRSTVWY"


def _random_container(rng, n, n_fi, span):
    pos = sorted(rng.sample(range(span), min(n, span)))
    return (np.array(pos, np.int64),
            np.array([rng.randrange(5) for _ in pos], np.int32),
            np.array([rng.randrange(300) for _ in pos], np.int32),
            np.array([rng.randrange(n_fi) for _ in pos], np.int32),
            np.array([rng.choice([0.1, 0.25, 1.0, 2.5, 1 / 3]) for _ in pos],
                     np.float32))


def _cap_container(seed, n=40_030):
    """One function but for the last 20 hits, 2 apart: past the append cap
    (MAX_HITS_PER_SEQ - 2 = 39,998) with pair triggers after it."""
    rng = np.random.default_rng(seed)
    fi = np.zeros(n, np.int32)
    fi[-20:] = rng.integers(0, 3, 20)
    return (np.arange(n, dtype=np.int64) * 2,
            rng.integers(0, 5, n).astype(np.int32),
            rng.integers(0, 300, n).astype(np.int32), fi,
            rng.choice([0.25, 1.0], n).astype(np.float32))


def _jax_steps(containers, **kw):
    """The JAX scan over the padded batch: (appended, emit, recs), each
    container's steps 0..len."""
    c = len(containers)
    lmax = max([1] + [len(x[0]) for x in containers])
    cols = [np.zeros((c, lmax), d) for d in (np.int32,) * 4 + (np.float32,)]
    lens = np.zeros(c, np.int32)
    for i, cont in enumerate(containers):
        lens[i] = len(cont[0])
        for col, x in zip(cols, cont):
            col[i, :len(x)] = x
    import jax

    return jax.device_get(jax_scan.scan_containers(*cols, lens, **kw)), lens


def _assert_steps_equal(containers, **kw):
    hits, offsets = scan_machine.pack_containers(containers)
    flags, recs = scan_machine.scan_containers(
        torch.from_numpy(hits), torch.from_numpy(offsets), **kw)
    flags, recs = flags.numpy(), recs.numpy()
    (appended, emit, jrecs), lens = _jax_steps(containers, **kw)
    n_emit = 0
    for i, n in enumerate(lens):
        b = offsets[i] + i
        f = flags[b:b + n + 1]
        np.testing.assert_array_equal((f & 1).astype(bool),
                                      appended[i, :n + 1])
        np.testing.assert_array_equal((f & 2).astype(bool), emit[i, :n + 1])
        e = emit[i, :n + 1]
        np.testing.assert_array_equal(recs[b:b + n + 1][e],
                                      jrecs[i, :n + 1][e])
        assert not recs[b:b + n + 1][~e].any()  # the twin's 0 elsewhere
        n_emit += int(e.sum())
    assert len(flags) == len(hits) + len(containers)
    return n_emit


@pytest.mark.parametrize("order_constraint", [False, True])
@pytest.mark.parametrize("min_weighted", [0, 2])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_twin_matches_jax_scan_per_step(seed, min_weighted,
                                        order_constraint):
    """Random ragged batches (empty containers, one to four functions,
    gaps around max_gap) give the JAX scan's flags at every step and its
    records where a step emits."""
    rng = random.Random(seed * 10 + min_weighted + 100 * order_constraint)
    n_emit = 0
    for min_hits in (2, rng.choice([3, 5])):
        kw = dict(min_hits=min_hits, min_weighted=min_weighted,
                  max_gap=rng.choice([30, 200]),
                  order_constraint=order_constraint)
        containers = [_random_container(rng, rng.randint(0, 40),
                                        rng.choice([1, 2, 4]),
                                        rng.choice([100, 2000]))
                      for _ in range(25)]
        containers[rng.randrange(25)] = _random_container(rng, 0, 1, 10)
        n_emit += _assert_steps_equal(containers, **kw)
    assert n_emit > 0


@pytest.mark.parametrize("min_hits", [0, 1])
def test_twin_matches_jax_scan_below_two_hits(min_hits):
    """min_hits below 2 (the reference's crash configuration, refused by
    gather_hits_scan_batch) still steps as the JAX scan does: a flush of
    an empty list emits."""
    rng = random.Random(40 + min_hits)
    containers = [_random_container(rng, rng.randint(0, 30), 3, 300)
                  for _ in range(20)]
    assert _assert_steps_equal(containers, min_hits=min_hits,
                               min_weighted=0, max_gap=20,
                               order_constraint=False) > 0


def test_twin_matches_jax_scan_past_the_append_cap():
    """A container longer than the append cap, beside a short and an empty
    one: the capped steps are not appended, and the pair trigger is still
    checked at them."""
    cap = _cap_container(5)
    containers = [cap, tuple(x[:7] for x in cap), tuple(x[:0] for x in cap)]
    _assert_steps_equal(containers, min_hits=2, min_weighted=0, max_gap=200,
                        order_constraint=False)


def test_cpu_wrapper_runs_the_twin_and_checks_inputs():
    rng = random.Random(8)
    hits, offsets = scan_machine.pack_containers(
        [_random_container(rng, 20, 2, 100) for _ in range(5)])
    kw = dict(min_hits=2, min_weighted=0, max_gap=30,
              order_constraint=False)
    before = scan_machine.launches
    got = scan_machine.scan_containers(torch.from_numpy(hits),
                                       torch.from_numpy(offsets), **kw)
    assert scan_machine.launches == before
    want = scan_machine.scan_containers_reference(
        torch.from_numpy(hits), torch.from_numpy(offsets), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for bad in (torch.from_numpy(hits).to(torch.int64),
                torch.from_numpy(hits[:, :4].copy()),
                torch.from_numpy(hits).t()):
        with pytest.raises(KernelError):
            scan_machine.scan_containers(bad, torch.from_numpy(offsets),
                                         **kw)
    with pytest.raises(KernelError):
        scan_machine.scan_containers(torch.from_numpy(hits),
                                     torch.from_numpy(offsets).int(), **kw)
    empty = scan_machine.scan_containers(
        torch.zeros((0, 5), dtype=torch.int32),
        torch.zeros(1, dtype=torch.int64), **kw)
    assert empty[0].numel() == 0 and empty[1].shape == (0, 7)


def _ragged_offsets(seed, c=300):
    """int64 offsets of ``c`` containers of seeded lengths, with ties and
    empty ones."""
    rng = np.random.default_rng(seed)
    lens = rng.choice([0, 1, 5, 5, 40, 300, int(rng.integers(0, 4096))], c)
    return torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])
                            .astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_length_order_covers_every_container_once_longest_first(seed):
    """The kernel's order of containers: a permutation of the batch, by
    decreasing length, ties in batch order."""
    offsets = _ragged_offsets(seed)
    order = scan_machine.length_order(offsets)
    assert order.dtype == torch.int32
    lens = (offsets[1:] - offsets[:-1]).numpy()
    o = order.numpy()
    assert sorted(o.tolist()) == list(range(len(lens)))
    assert (np.diff(lens[o]) <= 0).all()
    for length in np.unique(lens):
        tie = o[lens[o] == length]
        assert (np.diff(tie) > 0).all()
    assert scan_machine.length_order(offsets[:1]).numel() == 0


def test_twin_results_do_not_depend_on_the_order():
    """The order only schedules the kernel: the wrapper's results on the
    CPU are the twin's for the length order, the batch order, its reverse
    and a random permutation."""
    rng = random.Random(12)
    hits, offsets = scan_machine.pack_containers(
        [_random_container(rng, rng.randint(0, 60), 3, 400)
         for _ in range(40)])
    h, o = torch.from_numpy(hits), torch.from_numpy(offsets)
    kw = dict(min_hits=2, min_weighted=0, max_gap=40, order_constraint=False)
    want = scan_machine.scan_containers_reference(h, o, **kw)
    perm = torch.from_numpy(np.random.default_rng(3).permutation(40)
                            .astype(np.int32))
    for order in (None, scan_machine.length_order(o),
                  torch.arange(40, dtype=torch.int32),
                  torch.arange(39, -1, -1, dtype=torch.int32), perm):
        got = scan_machine.scan_containers(h, o, order=order, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("bad", ["int64", "short", "2d", "strided"])
def test_wrapper_refuses_a_bad_order(bad):
    rng = random.Random(13)
    hits, offsets = scan_machine.pack_containers(
        [_random_container(rng, 10, 2, 100) for _ in range(6)])
    good = scan_machine.length_order(torch.from_numpy(offsets))
    order = {"int64": good.long(), "short": good[:5],
             "2d": good.view(2, 3),
             "strided": torch.arange(12, dtype=torch.int32)[::2]}[bad]
    with pytest.raises(KernelError):
        scan_machine.scan_containers(
            torch.from_numpy(hits), torch.from_numpy(offsets), order=order,
            min_hits=2, min_weighted=0, max_gap=30, order_constraint=False)


def _host_lines(containers, p):
    """The exact host machine's CALL lines a container and OTU counter."""
    lines, oi = [], []
    for pos, o, avg, fi, wt in containers:
        out = io.StringIO()
        hits = list(zip(pos.tolist(), o.tolist(), avg.tolist(), fi.tolist(),
                        [np.float32(w) for w in wt]))
        gather_hits(hits, FUNCS, oi, Report(out), p)
        lines.append(out.getvalue().splitlines())
    return lines, oi


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_gather_batch_matches_jax_and_host_machine(seed):
    """Lines and OTU updates equal the JAX gather_hits_scan_batch's, and
    the lines and folded counter the exact host machine's."""
    rng = random.Random(seed)
    for _ in range(2):
        kw = dict(min_hits=rng.choice([2, 3, 5]),
                  min_weighted_hits=rng.choice([0, 0, 1]),
                  max_gap=rng.choice([30, 200]),
                  order_constraint=rng.random() < 0.3)
        containers = [_random_container(rng, rng.randint(0, 40),
                                        rng.choice([1, 2, 4]),
                                        rng.choice([100, 2000]))
                      for _ in range(25)]
        got = scan_machine.gather_hits_scan_batch(
            containers, FUNCS, GroupingParams(**kw), device="cpu")
        assert got == jax_scan.gather_hits_scan_batch(
            containers, FUNCS, JaxParams(**kw))
        lines, oi_host = _host_lines(containers, GroupingParams(**kw))
        assert [g[0] for g in got] == lines
        oi_scan = []
        for _, updates in got:
            for o, inc in updates:
                _otu_add_batch(oi_scan, o, inc)
        assert oi_scan == oi_host


def test_gather_batch_matches_the_independent_oracle():
    rng = random.Random(11)
    containers = [_random_container(rng, rng.randint(0, 30), 3, 500)
                  for _ in range(30)]
    got = scan_machine.gather_hits_scan_batch(
        containers, FUNCS, GroupingParams(min_hits=2, max_gap=100),
        device="cpu")
    for (pos, oi, avg, fi, wt), (lines, _) in zip(containers, got):
        hits = list(zip(pos.tolist(), oi.tolist(), avg.tolist(), fi.tolist(),
                        [np.float32(w) for w in wt]))
        assert lines == oracle_gather_hits(hits, FUNCS, [],
                                           (2, 0, 100, False, False))


@pytest.mark.parametrize("kw", [dict(debug=True), dict(min_hits=1)])
def test_gather_batch_refuses_what_the_jax_one_refuses(kw):
    with pytest.raises(ValueError, match="non-debug, min_hits >= 2"):
        scan_machine.gather_hits_scan_batch([], FUNCS,
                                            GroupingParams(**kw),
                                            device="cpu")


@pytest.fixture(scope="module")
def scan_corpus(tmp_path_factory):
    rng = random.Random(21)
    prots = ["".join(rng.choice(AA) for _ in range(rng.randint(15, 90)))
             for _ in range(30)]
    d = str(tmp_path_factory.mktemp("scan") / "d")
    write_data_dir(d, signatures_from_proteins(
        [(p, i % 5, i % 7) for i, p in enumerate(prots)]),
        [f"f{i}" for i in range(5)])
    aa = "".join(f">p{i}\n{p}\n" for i, p in enumerate(prots))
    dna = "".join(f">c{i}\n" + "".join(rng.choice("ACGT") for _ in range(250))
                  + "\n" for i in range(6))
    codon = {"A": "GCT", "C": "TGT", "D": "GAT", "E": "GAA", "F": "TTT",
             "G": "GGT", "H": "CAT", "I": "ATT", "K": "AAA", "L": "CTT",
             "M": "ATG", "N": "AAT", "P": "CCT", "Q": "CAA", "R": "CGT",
             "S": "TCT", "T": "ACT", "V": "GTT", "W": "TGG", "Y": "TAT"}
    dna += "".join(f">g{i}\n" + "".join(codon[c] for c in p) + "\n"
                   for i, p in enumerate(prots[:8]))
    return d, {True: aa, False: dna}


@pytest.mark.parametrize("kw", [dict(min_hits=2), dict(min_hits=3,
                                                       order_constraint=True),
                                dict(min_hits=2, min_weighted_hits=2)])
@pytest.mark.parametrize("aa", [True, False])
def test_engine_scan_grouping_matches_jax(scan_corpus, aa, kw):
    """The port's engine with --grouping scan writes the JAX engine's
    report with grouping_impl="scan", and the host grouping's."""
    d, fasta = scan_corpus
    outs = {}
    for impl in ("host", "scan"):
        out = io.StringIO()
        Engine(EngineConfig(aa=aa, grouping_impl=impl, device="cpu", **kw)).run(
            d, None, out, stdout=True, query_stream=io.StringIO(fasta[aa]))
        outs[impl] = out.getvalue()
    out = io.StringIO()
    JaxEngine(JaxConfig(aa=aa, grouping_impl="scan", **kw)).run(
        d, None, out, stdout=True, query_stream=io.StringIO(fasta[aa]))
    assert outs["scan"] == out.getvalue() == outs["host"]
    assert "CALL\t" in outs["scan"]


def test_engine_sends_big_containers_to_the_host_machine(scan_corpus,
                                                         monkeypatch):
    """Containers over SCAN_BIG hits take the host machine, as in the JAX
    engine; the report is the same."""
    d, fasta = scan_corpus
    seen = []
    real = scan_machine.gather_hits_scan_batch

    def spy(batch, *args, **kwargs):
        seen.append(len(batch))
        return real(batch, *args, **kwargs)

    monkeypatch.setattr(scan_machine, "gather_hits_scan_batch", spy)
    monkeypatch.setattr(Engine, "SCAN_BIG", 3)
    out = io.StringIO()
    Engine(EngineConfig(aa=True, min_hits=2, grouping_impl="scan",
                        device="cpu")).run(d, None, out, stdout=True,
                                           query_stream=io.StringIO(
                                               fasta[True]))
    want = io.StringIO()
    JaxEngine(JaxConfig(aa=True, min_hits=2)).run(
        d, None, want, stdout=True, query_stream=io.StringIO(fasta[True]))
    assert out.getvalue() == want.getvalue()
    assert seen and seen[0] < 30  # most proteins have more than 3 hits


@pytest.mark.parametrize("extra", [["-d"], ["-m", "1"]])
def test_cli_scan_in_debug_or_min_hits_below_two_runs_on_the_host(
        scan_corpus, tmp_path, extra, monkeypatch):
    """--grouping scan with -d or -m 1 groups on the host machine, as the
    JAX engine does: the kernel is not called."""
    d, fasta = scan_corpus
    q = tmp_path / "q.faa"
    q.write_text(fasta[True])

    def never(*args, **kwargs):
        raise AssertionError("the scan machine ran")

    monkeypatch.setattr(scan_machine, "gather_hits_scan_batch", never)
    out = tmp_path / "o.txt"
    assert cli.main(["-a", "-D", d, "-q", str(q), "-o", str(out),
                     "--device", "cpu", "--grouping", "scan"] + extra) == 0
    assert "PROTEIN-ID" in out.read_text()


def test_cli_grouping_scan_matches_host(scan_corpus, tmp_path, capsys):
    d, fasta = scan_corpus
    q = tmp_path / "q.faa"
    q.write_text(fasta[True])
    outs = []
    for impl in ("host", "scan"):
        assert cli.main(["-a", "-m", "2", "-D", d, "-q", str(q), "--device",
                         "cpu", "--grouping", impl]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "CALL\t" in outs[0]
