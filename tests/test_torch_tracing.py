"""The port's spans and counters (``utils/timing.py``), on the CPU: spans
nest and sum across the main thread and a worker; no profiler, no
``record_function``; under a torch.profiler every span of the run shows in
the Chrome trace as a ``user_annotation``; an engine run through the stream
front end and one through the sparse front end leave a record with their
spans and counters, whose phase spans agree with the printed info lines;
``--profile`` writes ``spans.json``; the service exports each request's
spans on ``/metrics``."""
import contextlib
import io
import json
import os
import sys
import threading
import time

import pytest

from kmergutsjava_tpu_torch import cli
from kmergutsjava_tpu_torch.config import EngineConfig
from kmergutsjava_tpu_torch.models import pipeline
from kmergutsjava_tpu_torch.models.pipeline import Engine
from kmergutsjava_tpu_torch.service.server import KmerGutsService
from kmergutsjava_tpu_torch.utils import timing
from kmergutsjava_tpu_torch.utils.timing import count, record, span

from corpus_util import build_corpus_data_dir, load_corpus

# spans that enclose or come before the engine's profiled run
OUTSIDE_TRACE = {"cli.main", "cli.imports", "engine.run"}
PHASES = {"Preparation": "engine.prepare", "Lookup": "engine.lookup",
          "Grouping": "engine.group"}
COMMON = {"cli.main", "cli.imports", "table.read", "lookup.build",
          "lookup.build.plane", "lookup.build.upload", "engine.prepare",
          "prepare.feed", "prepare.feed_wait", "engine.lookup",
          "engine.group", "group.native"}
# DNA through the numpy prepare feeds a batch a frame, so a small -l makes
# the stream front end run several plane passes
SEVERAL_PASSES = ("--prepare", "numpy", "-l", "10000")
# counters that may read 0 on the CPU: the pool is never short, a pass may
# end before the next chunk, and a small table may send no query past its
# home's channels or to the full-window scan
MAY_BE_ZERO = {"stream.overlap_queries", "stream.fresh_sets",
               "stream.overflow_queries", "stream.fallback_queries"}
FRONT_ENDS = {
    "stream": ({"stream.scatter", "stream.pass", "stream.upload",
                "stream.readback", "stream.decode", "stream.reset",
                "stream.set_wait", "engine.worker_wait"},
               {"stream.passes", "stream.queries", "stream.bytes_up",
                "stream.bytes_down", "stream.overlap_queries",
                "stream.fresh_sets",
                "stream.overflow_queries", "stream.fallback_queries"}),
    "xla": ({"sparse.dispatch", "sparse.resolve", "sparse.verify"},
            {"sparse.bytes_up", "sparse.bytes_down"}),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(data dir, 200 proteins as a query file, a 60 kbp contig's file)."""
    prots, contig = load_corpus(200, 60_000)
    d = tmp_path_factory.mktemp("tracing")
    build_corpus_data_dir(str(d), prots)
    faa = d / "query.faa"
    faa.write_text("".join(f">{p.id}\n{p.seq}\n" for p in prots))
    fna = d / "contig.fna"
    fna.write_text(f">{contig.id}\n{contig.seq}\n")
    return str(d), str(faa), str(fna)


def _cli(corpus, tmp_path, *extra, dna=False):
    """The CLI on the CPU: (its info lines, the call's record)."""
    d, faa, fna = corpus
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([*([] if dna else ["-a"]), "-D", d, "-q",
                       fna if dna else faa, "-o", str(tmp_path / "r.txt"),
                       "--device", "cpu", *extra])
    assert rc == 0
    return buf.getvalue(), timing.recent_runs()[-1]


def test_spans_nest_and_sum_across_threads():
    def worker():
        with span("t.worker"):
            time.sleep(0.003)
        count("t.count", 5)

    with record("t.root") as rec:
        with record("t.inner") as same:  # a record is open: no new one
            assert same is rec
        with span("t.a"):
            with span("t.b"):
                time.sleep(0.002)
        with span("t.a") as second:
            t = threading.Thread(target=worker)
            t.start()
            t.join(30)
            assert not t.is_alive()
        count("t.count", 2)
    got = timing.recent_runs()[-1]
    spans = {k: (v["calls"], v["ns"]) for k, v in got["spans"].items()}
    assert set(spans) == {"t.root", "t.a", "t.b", "t.worker"}
    assert spans["t.a"][0] == 2 and spans["t.b"][0] == 1
    assert spans["t.worker"] == (1, spans["t.worker"][1])
    assert spans["t.b"][1] >= 2_000_000 and spans["t.worker"][1] >= 3_000_000
    assert spans["t.a"][1] >= spans["t.b"][1] + second.ns
    assert spans["t.root"][1] >= spans["t.a"][1]
    # only the root's direct children on the opening thread
    assert got["under_root_ns"] == spans["t.a"][1]
    assert got["counters"] == {"t.count": 7}
    assert got["root"] == "t.root" and got["start"] <= got["end"]
    assert rec.end == got["end"]


def test_spans_and_counts_hold_under_contention():
    """More threads than cores, switching often: no add is lost."""
    threads, each = 4 * (os.cpu_count() or 1), 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with record("t.root"):
            def work():
                for _ in range(each):
                    with span("t.s"):
                        pass
                    count("t.n", 1)

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(60)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    got = timing.recent_runs()[-1]
    assert got["spans"]["t.s"]["calls"] == threads * each
    assert got["counters"]["t.n"] == threads * each


def test_no_record_function_without_a_profiler(corpus, tmp_path,
                                               monkeypatch):
    entered = []

    class Spy:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(timing, "_record_function", Spy)
    _cli(corpus, tmp_path, "--backend", "stream")
    assert entered == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with record("t.root"), span("t.a"):
            pass
    assert entered == ["t.root", "t.a"]


@pytest.mark.parametrize("backend", ["stream", "xla"])
def test_profiled_run_shows_every_span_in_the_trace(corpus, tmp_path,
                                                    backend):
    out = tmp_path / "profile"
    _, rec = _cli(corpus, tmp_path, "--backend", backend, *SEVERAL_PASSES,
                  "--profile", str(out), dna=True)
    with open(out / "trace.json") as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"]
    window = [e for e in events if e.get("cat") == "Trace"]
    lo = min(float(e["ts"]) for e in window)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in window)
    shown = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            assert lo <= float(e["ts"]) <= float(e["ts"]) + float(
                e["dur"]) <= hi
            shown[e["name"]] = shown.get(e["name"], 0) + 1
    for name, got in rec["spans"].items():
        if name not in OUTSIDE_TRACE:
            assert shown.get(name) == got["calls"], name
    assert FRONT_ENDS[backend][0] <= set(shown)


@pytest.mark.parametrize("entry", ["cli", "engine"])
def test_profile_writes_spans_json(corpus, tmp_path, entry):
    out = tmp_path / "profile"
    if entry == "cli":
        _, rec = _cli(corpus, tmp_path, "--profile", str(out))
    else:
        d, faa, _ = corpus
        with open(tmp_path / "r.txt", "w") as fh:
            Engine(EngineConfig(aa=True, device="cpu",
                                profile_dir=str(out))).run(d, faa, fh)
        rec = timing.recent_runs()[-1]
    with open(out / "spans.json") as fh:
        written = json.load(fh)
    assert written == rec
    assert written["root"] == {"cli": "cli.main", "engine": "engine.run"}[
        entry]
    assert {"engine.prepare", "engine.lookup", "engine.group"} <= set(
        written["spans"])
    # the bulk prepare's inner spans (a query file takes the bulk parse)
    assert {"prepare.parse", "prepare.register", "prepare.encode"} <= set(
        written["spans"])
    assert (out / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("backend", ["stream", "xla"])
def test_engine_run_leaves_its_spans_and_counters(corpus, tmp_path,
                                                  backend, monkeypatch):
    # a cold run: the table read and the lookup built anew
    monkeypatch.setattr(pipeline, "_TABLE_CACHE", {})
    monkeypatch.setattr(pipeline, "_LOOKUP_CACHE", {})
    info, rec = _cli(corpus, tmp_path, "--backend", backend,
                     *SEVERAL_PASSES, dna=True)
    want_spans, want_counters = FRONT_ENDS[backend]
    assert COMMON | want_spans <= set(rec["spans"])
    assert set(rec["counters"]) == want_counters
    assert all(rec["counters"][k] > 0 for k in want_counters - MAY_BE_ZERO)
    if backend == "stream":
        passes = rec["counters"]["stream.passes"]
        assert passes >= 2 and rec["spans"]["stream.pass"]["calls"] == passes
        # every pass's set is zeroed in the run's record, the last one's too
        assert rec["spans"]["stream.reset"]["calls"] == passes
        assert rec["counters"]["stream.fresh_sets"] == 0
        assert 0 <= rec["counters"]["stream.overlap_queries"] <= \
            rec["counters"]["stream.queries"]
        # only the values go up (8 B a query); a hit's query index and slot
        # come back (8 B a hit), and a pass's three counts
        queries = rec["counters"]["stream.queries"]
        assert rec["counters"]["stream.bytes_up"] == 8 * queries
        hit_bytes = rec["counters"]["stream.bytes_down"] - 24 * passes
        assert 0 < hit_bytes <= 8 * queries and hit_bytes % 8 == 0
        assert 0 <= rec["counters"]["stream.overflow_queries"] <= \
            rec["counters"]["stream.fallback_queries"] <= queries
    printed = {}
    for line in info.splitlines():
        for phase in PHASES:
            if line.startswith(phase + " time: "):
                printed[phase] = int(line.split(": ")[1].split()[0])
    assert set(printed) == set(PHASES)
    for phase, name in PHASES.items():
        ms = rec["spans"][name]["ns"] / 1e6
        assert printed[phase] <= ms < printed[phase] + 1, (phase, ms)
    assert rec["spans"]["cli.main"]["ns"] >= rec["under_root_ns"] >= sum(
        rec["spans"][n]["ns"] for n in PHASES.values())


def test_service_exports_each_requests_spans(corpus):
    d, faa, _ = corpus
    svc = KmerGutsService(d, device="cpu")
    with open(faa) as fh:
        fasta = fh.read()
    svc.dispatch("KmerGutsJava.annotate", [{"fasta": fasta, "aa": True}])
    text = svc.metrics.render()
    assert "# TYPE engine_span_seconds histogram" in text
    for name in ("service.lock_wait", "service.annotate", "engine.prepare",
                 "engine.lookup", "engine.group"):
        assert f'engine_span_seconds_count{{span="{name}"}} 1' in text
        assert f'engine_span_seconds_bucket{{le="0.005",span="{name}"}}' \
            in text
    assert timing.recent_runs()[-1]["root"] == "service.annotate"
