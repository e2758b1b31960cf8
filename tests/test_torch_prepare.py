"""The PyTorch package's prepare phase (kmergutsjava_tpu_torch/models/
prepare.py) against the JAX package's host prepare, in both modes: the
numpy twin, the native feeder over records and the bulk parse must give the
JAX numpy prepare's (value, container, pos) records and container keys.
Exact: the records are integers."""
import io

import numpy as np
import pytest

from kmergutsjava_tpu.formats.fasta import read_fasta as jax_read_fasta
from kmergutsjava_tpu.models.prepare import (prepare_aa_numpy as jax_aa,
                                             prepare_dna_numpy as jax_dna)
from kmergutsjava_tpu_torch.formats.fasta import read_fasta
from kmergutsjava_tpu_torch.models import prepare


class Collect:
    """A query store that keeps every record in feed order."""

    def __init__(self):
        self.parts = []

    def add_batch(self, values, cnt_id, pos):
        n = len(values)
        self.parts.append((np.array(values, np.int64),
                           np.broadcast_to(np.asarray(cnt_id, np.int64),
                                           (n,)).copy(),
                           np.array(pos, np.int64)))

    def records(self):
        if not self.parts:
            return np.zeros((0, 3), np.int64)
        return np.stack([np.concatenate(c) for c in zip(*self.parts)], 1)


def _fasta(aa, seed):
    """Records of many lengths, including ones shorter than a k-mer window,
    lower case, ambiguous letters and (DNA) lengths off the codon frame."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYXacdk*" if aa
                          else b"ACGT" * 6 + b"acgtNRY", np.uint8)
    out = []
    for i, n in enumerate([1, 5, 7, 8, 9, 23, 24, 25, 26, 100, 301, 2000]
                          + list(rng.integers(30, 900, 40))):
        seq = alpha[rng.integers(0, len(alpha), n)].tobytes().decode()
        out.append(f">q{i} descr {i}\n{seq}\n")
    return "".join(out)


def _sorted(rec):
    return rec[np.lexsort((rec[:, 0], rec[:, 2], rec[:, 1]))]


@pytest.mark.parametrize("aa", [True, False])
def test_prepare_matches_jax(aa, tmp_path):
    text = _fasta(aa, seed=3 if aa else 4)
    path = tmp_path / "q.fa"
    path.write_text(text)
    want = Collect()
    jprep = (jax_aa if aa else jax_dna)(jax_read_fasta(io.StringIO(text)),
                                       want, flush_chars=5000)
    want_rec = want.records()
    assert len(want_rec) > 1000
    numpy_fn = prepare.prepare_aa_numpy if aa else prepare.prepare_dna_numpy
    native_fn = (prepare.prepare_aa_native if aa
                 else prepare.prepare_dna_native)
    got = Collect()
    prep = numpy_fn(read_fasta(io.StringIO(text)), got, flush_chars=5000)
    np.testing.assert_array_equal(got.records(), want_rec)  # feed order too
    assert prep.containers == jprep.containers
    assert list(prep.id_len.items()) == list(jprep.id_len.items())
    for name, run in (
            ("native", lambda c: native_fn(read_fasta(io.StringIO(text)), c)),
            ("bulk", lambda c: prepare.try_prepare_bulk(str(path), None, c,
                                                        aa))):
        got = Collect()
        prep = run(got)
        if prep is None:
            pytest.skip(f"native toolchain unavailable ({name})")
        np.testing.assert_array_equal(_sorted(got.records()),
                                      _sorted(want_rec))
        assert prep.containers == jprep.containers
        assert list(prep.id_len.items()) == list(jprep.id_len.items())


# --- the native feeder's two passes, the bulk registration and the columns
# a stream front end lends ---

from functools import partial  # noqa: E402

from kmergutsjava_tpu.config import EngineConfig as JaxConfig  # noqa: E402
from kmergutsjava_tpu.models.pipeline import Engine as JaxEngine  # noqa: E402
from kmergutsjava_tpu_torch.config import EngineConfig  # noqa: E402
from kmergutsjava_tpu_torch.formats.fasta import FastaRecord  # noqa: E402
from kmergutsjava_tpu_torch.lookup.stream import StreamLookup  # noqa: E402
from kmergutsjava_tpu_torch.models.pipeline import Engine  # noqa: E402
from kmergutsjava_tpu_torch.utils import native, timing  # noqa: E402

from corpus_util import build_corpus_data_dir, load_corpus  # noqa: E402


def _feeder_records(aa, seed):
    """Sequences of every kind the feeder meets: empty ones, ones shorter
    than a window, N, lower case, U, ambiguous letters and one long contig,
    over 2**20 characters in all, so that every thread count splits them."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYXUacdk*" if aa
                          else b"ACGT" * 6 + b"acgtuUNnRY", np.uint8)
    lens = ([0, 1, 5, 7, 8, 9, 0, 23, 24, 25, 26, 47, 48, 49, 50]
            + rng.integers(0, 900, 1500).tolist() + [400_000]
            + rng.integers(0, 300, 500).tolist())
    return [alpha[rng.integers(0, len(alpha), n)].tobytes() for n in lens]


@pytest.mark.parametrize("threads", [1, 2, 8])
@pytest.mark.parametrize("aa", [True, False])
def test_feeder_passes_match_numpy_twin(aa, threads, monkeypatch):
    """The count pass counts each record's windows, the write pass writes
    exactly that many rows and no more, and the rows are the numpy twin's
    records in the feeder's order (record by record, DNA frames +0 +1 +2
    -0 -1 -2, positions rising), at any thread count."""
    lib = native.load_feeder()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    monkeypatch.setenv("KMER_NATIVE_THREADS", str(threads))
    seqs = _feeder_records(aa, seed=5 if aa else 6)
    nrec, frames = len(seqs), 1 if aa else 6
    lens = np.array([len(s) for s in seqs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    blob = np.frombuffer(b"".join(seqs), np.uint8)
    assert len(blob) > 1 << 20
    counts = np.full(nrec, -1, np.int64)
    n = lib.feeder_count(aa, blob, starts, lens, nrec, counts)
    first = 7 * frames
    cols = [np.full(n + 1, -5, np.int64) for _ in range(3)]
    assert lib.feeder_write(aa, blob, starts, lens, nrec, counts, first,
                            *cols) == n == counts.sum()
    assert [c[n] for c in cols] == [-5] * 3
    twin = Collect()
    (prepare.prepare_aa_numpy if aa else prepare.prepare_dna_numpy)(
        [FastaRecord(f"q{i}", s.decode(), "") for i, s in enumerate(seqs)],
        twin, flush_chars=1 << 30)
    want = twin.records()
    want = want[np.lexsort((want[:, 2], want[:, 1]))]
    want[:, 1] += first
    np.testing.assert_array_equal(np.stack([c[:n] for c in cols], 1), want)
    np.testing.assert_array_equal(
        counts, np.bincount((want[:, 1] - first) // frames, minlength=nrec))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """A 200-protein corpus table, its proteins as FASTA, and 2,000 reads
    of 20-200 bases cut from the corpus contig (some with an N)."""
    prots, contig = load_corpus(200, 60_000)
    d = tmp_path_factory.mktemp("bulk_prepare")
    build_corpus_data_dir(str(d), prots)
    rng = np.random.default_rng(8)
    out = []
    for i in range(2000):
        a, n = int(rng.integers(0, len(contig.seq) - 200)), int(
            rng.integers(20, 200))
        seq = contig.seq[a:a + n]
        if i % 10 == 0:
            seq = seq[:n // 2] + "N" + seq[n // 2 + 1:]
        out.append(f">r{i} read {i}\n{seq}\n")
    return (str(d), "".join(f">{p.id} {p.descr}\n{p.seq}\n" for p in prots),
            "".join(out))


def _repeat_ids(fasta, name, at):
    """``fasta`` with the records at ``at`` renamed to ``name``."""
    recs = fasta.split(">")[1:]
    for i in at:
        recs[i] = name + recs[i][recs[i].index(" "):]
    return "".join(">" + r for r in recs)


def _port_report(d, fasta, aa, **kw):
    out = io.StringIO()
    Engine(EngineConfig(aa=aa, device="cpu", **kw)).run(
        d, None, out, stdout=True, query_stream=io.StringIO(fasta))
    return out.getvalue()


@pytest.mark.parametrize("aa", [True, False])
def test_bulk_registration_with_repeated_ids(reads, aa):
    """One id three times, with three lengths: the bulk prepare registers
    the records as the record-iterator path does (every record in file
    order; the id's first place in id_len, its last length; the same
    containers), and the report through the stream front end is the JAX
    package's, byte for byte."""
    d, faa, fna = reads
    fasta = _repeat_ids(faa if aa else fna, "dup", (3, 100, 180))
    bulk = prepare.try_prepare_bulk(None, io.StringIO(fasta), Collect(), aa)
    if bulk is None:
        pytest.skip("native toolchain unavailable")
    it = (prepare.prepare_aa_native if aa else prepare.prepare_dna_native)(
        read_fasta(io.StringIO(fasta)), Collect())
    frames = 1 if aa else 6
    assert bulk._rec_ids == [k[0] for k in it.containers[::frames]]
    assert bulk._rec_ids.count("dup") == 3
    assert list(bulk.id_len.items()) == list(it.id_len.items())
    seqs = [r.seq for r in read_fasta(io.StringIO(fasta)) if r.id == "dup"]
    assert len(set(map(len, seqs))) == 3
    assert bulk.id_len["dup"] == len(seqs[-1])
    assert list(bulk.id_len).index("dup") == 3
    assert bulk.num_containers() == it.num_containers() == len(
        it.containers)
    assert bulk.containers == it.containers
    want = io.StringIO()
    JaxEngine(JaxConfig(aa=aa)).run(d, None, want, stdout=True,
                                    query_stream=io.StringIO(fasta))
    got = _port_report(d, fasta, aa, backend="stream")
    assert "dup" in got and got == want.getvalue()


@pytest.mark.parametrize("aa", [True, False])
def test_stream_reuses_columns_only_after_their_pass(reads, monkeypatch, aa):
    """The stream front end lends the prepare each chunk's columns from its
    lookup's pool, and every query is written into them. In one pass
    (every chunk's columns out until finish) a second run lends the first
    run's columns again, allocating none. In several passes, with the feed
    paced and never held back and slow decodes on the pass thread, so the
    prepare writes on while passes wait to be decoded, columns come back
    only once their pass is decoded. Each report is the store-backed
    parity run's."""
    import threading
    import time

    from kmergutsjava_tpu_torch.lookup.stream import StreamingStreamLookup
    from kmergutsjava_tpu_torch.models import pipeline

    d, faa, fna = reads
    fasta = faa if aa else fna
    want = _port_report(d, fasta, aa, backend="parity")

    def run(flush_chars, **kw):
        monkeypatch.setattr(prepare, "try_prepare_bulk", partial(
            bulk_prepare, flush_chars=flush_chars))
        assert _port_report(d, fasta, aa, backend="stream", **kw) == want
        c = timing.recent_runs()[-1]["counters"]
        assert c["prepare.direct_queries"] == c["stream.queries"] > 0
        return c

    bulk_prepare = prepare.try_prepare_bulk
    monkeypatch.setattr(pipeline, "_LOOKUP_CACHE", {})
    one = [run(len(fasta) // 6) for _ in range(2)]
    assert one[0]["stream.passes"] == 1
    assert 2 <= one[0]["stream.fresh_columns"] <= 8  # within the pool's keep
    assert one[1]["stream.fresh_columns"] == 0

    decode, feed = StreamLookup._decode, StreamingStreamLookup.add_batch

    def slow_decode(self, *a, **k):
        if threading.current_thread() is not threading.main_thread():
            time.sleep(0.05)
        return decode(self, *a, **k)

    def paced_feed(self, *a):
        time.sleep(0.01)
        return feed(self, *a)

    monkeypatch.setattr(StreamLookup, "_decode", slow_decode)
    monkeypatch.setattr(StreamingStreamLookup, "add_batch", paced_feed)
    monkeypatch.setattr(StreamingStreamLookup, "FEED_CHUNKS", 1000)
    monkeypatch.setattr(pipeline, "_LOOKUP_CACHE", {})  # an empty pool
    c = run(4_000, input_size_limit=6_000)
    assert c["stream.passes"] >= 3 and c["stream.overlap_queries"] > 0
    assert c["stream.fresh_columns"] > 0


@pytest.mark.parametrize("backend", ["xla", "parity", "auto"])
def test_plain_columns_where_the_feed_lends_none(reads, backend):
    """The sparse front end, the bounded-RAM store and the deferred auto
    feed (a stream of unknown size) lend no columns: the prepare writes
    into plain ones, counts no direct query, and the report is the
    stream front end's."""
    d, _, fna = reads
    got = _port_report(d, fna, False, backend=backend)
    c = timing.recent_runs()[-1]["counters"]
    assert c["prepare.direct_queries"] == 0
    assert "stream.fresh_columns" not in c
    assert got == _port_report(d, fna, False, backend="stream")
