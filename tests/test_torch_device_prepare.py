"""The device prepare (``--prepare jax``: models/prepare.py prepare_aa and
prepare_dna over the k-mer window kernel's ragged entry,
ops/kmer_windows.py ragged_values) on the CPU, where the entry runs its
twin, against the JAX package's prepare at its edges: rows shorter than a
window, X and N, stop codons, a row that crosses the launch budget
(VALUES_LAUNCH_BYTES, shrunk here), a contig past it, and no input.
prepare_aa gives the JAX ``add_batch`` calls one for one and prepare_dna
the JAX rows in the JAX order; ``--prepare jax`` reports of the same
records equal the JAX engine's byte for byte."""
import io

import numpy as np
import pytest

from kmergutsjava_tpu.config import EngineConfig as JaxConfig
from kmergutsjava_tpu.models import prepare as jax_prepare
from kmergutsjava_tpu.models.pipeline import Engine as JaxEngine
from kmergutsjava_tpu_torch.config import EngineConfig
from kmergutsjava_tpu_torch.formats.fasta import FastaRecord
from kmergutsjava_tpu_torch.formats.table_tools import (
    signatures_from_proteins, write_data_dir)
from kmergutsjava_tpu_torch.models import prepare
from kmergutsjava_tpu_torch.models.pipeline import Engine
from kmergutsjava_tpu_torch.ops import kmer_windows

AA = "ACDEFGHIKLMNPQRSTVWY"
CODON = {"A": "GCT", "C": "TGT", "D": "GAT", "E": "GAA", "F": "TTT",
         "G": "GGT", "H": "CAT", "I": "ATT", "K": "AAA", "L": "CTT",
         "M": "ATG", "N": "AAT", "P": "CCT", "Q": "CAA", "R": "CGT",
         "S": "TCT", "T": "ACT", "V": "GTT", "W": "TGG", "Y": "TAT"}
BUDGET = 900  # VALUES_LAUNCH_BYTES in these tests


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
        if not self.calls:
            return [np.zeros(0, np.int64)] * 3
        return [np.concatenate([c[i] for c in self.calls])
                for i in range(3)]


def _proteins(case, rng):
    """Protein sequences of one edge case."""
    def prot(n):
        return "".join(rng.choice(list(AA), n))

    if case == "short":  # no window, one window (8, 9), one more
        return [prot(n) for n in (0, 1, 5, 7, 8, 9, 10, 3, 16)]
    if case == "x_and_stops":
        out = []
        for _ in range(12):
            s = list(prot(int(rng.integers(20, 120))))
            for i in rng.integers(0, len(s), 4):
                s[i] = rng.choice(["X", "*", "B", "x", "-"])
            out.append("".join(s))
        return out
    if case == "straddle":  # batches whose bytes cross the budget
        return [prot(int(rng.integers(30, 260))) for _ in range(40)]
    return []  # empty


def _contigs(case, rng):
    """DNA contigs of one edge case (a protein's codons, so that windows
    are valid, with N runs and stop codons put in)."""
    def contig(n_aa):
        return "".join(CODON[c] for c in rng.choice(list(AA), n_aa))

    if case == "short":  # under one window (24 bases) and just past it
        return [contig(n)[:m] for n, m in ((1, 2), (3, 7), (7, 23), (8, 24),
                                           (9, 26), (9, 27), (0, 0))]
    if case == "n_and_stops":
        out = []
        for _ in range(8):
            s = list(contig(int(rng.integers(20, 90))))
            for i in rng.integers(0, len(s) - 3, 3):
                s[i:i + 3] = rng.choice(["TAA", "TGA", "NNN", "RYK"])
            out.append("".join(s))
        return out
    if case == "above_limit":  # contigs around one past the budget
        return [contig(40), contig(700), contig(25), contig(60)]
    return []  # empty


def _records(seqs):
    return [FastaRecord(f"q{i}", s, "") for i, s in enumerate(seqs)]


@pytest.fixture
def small_budget(monkeypatch):
    monkeypatch.setattr(prepare, "VALUES_LAUNCH_BYTES", BUDGET)
    calls = []
    real = kmer_windows.ragged_values

    def counted(data, bounds, aa):
        calls.append((data.numel(), bounds.numel() - 1))
        return real(data, bounds, aa)

    monkeypatch.setattr(kmer_windows, "ragged_values", counted)
    return calls


@pytest.mark.parametrize("case", ["short", "x_and_stops", "straddle",
                                  "empty"])
def test_prepare_aa_edges_equal_jax_calls(small_budget, case):
    """prepare_aa through the ragged entry's twin: the JAX add_batch calls
    one for one (value, container, position), the same containers; the
    straddling case takes several launches, each under the budget unless
    one batch alone passes it."""
    recs = _records(_proteins(case, np.random.default_rng(len(case))))
    got, want = _Rows(), _Rows()
    p = prepare.prepare_aa(recs, got, batch_rows=5, min_bucket=32,
                           device="cpu")
    jp = jax_prepare.prepare_aa(recs, want, batch_rows=5, min_bucket=32)
    assert len(got.calls) == len(want.calls)
    for g, w in zip(got.calls, want.calls):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert p.containers == jp.containers and p.id_len == jp.id_len
    if case == "straddle":
        assert len(small_budget) > 2
        assert sum(n for n, _ in small_budget) == sum(len(r.seq)
                                                       for r in recs)
    if case == "empty":
        assert small_budget == [] and got.calls == []
    if case == "short":
        assert sum(len(c[0]) for c in got.calls) == 1 + 2 + 8


@pytest.mark.parametrize("case", ["short", "n_and_stops", "above_limit",
                                  "empty"])
def test_prepare_dna_edges_equal_jax_rows(small_budget, case):
    """prepare_dna through the ragged entry's twin: the JAX rows in the JAX
    order (contig, frame row, position), the same containers; a contig
    past the budget is a launch of its own."""
    recs = _records(_contigs(case, np.random.default_rng(len(case) + 1)))
    got, want = _Rows(), _Rows()
    p = prepare.prepare_dna(recs, got, device="cpu")
    jp = jax_prepare.prepare_dna(recs, want)
    for a, b in zip(got.rows(), want.rows()):
        np.testing.assert_array_equal(a, b)
    assert p.containers == jp.containers and p.id_len == jp.id_len
    assert len(got.calls) == len(small_budget)
    if case == "above_limit":
        assert [n for n, _ in small_budget] == [120, 2100, 255]
        assert len(want.rows()[0]) > 1000
    if case == "n_and_stops":
        assert 0 < len(got.rows()[0]) < sum(6 * len(r.seq) // 3
                                            for r in recs)


def _report(engine, cfg, d, fasta):
    out = io.StringIO()
    engine(cfg).run(d, None, out, stdout=True,
                    query_stream=io.StringIO(fasta))
    return out.getvalue()


@pytest.mark.parametrize("mode", ["aa", "dna"])
def test_prepare_jax_edge_reports_equal_jax(tmp_path, small_budget, mode):
    """``--prepare jax`` on the edge records of every case at once, with
    a protein that calls a function among them: the JAX engine's
    ``--prepare jax`` report, byte for byte."""
    rng = np.random.default_rng(5)
    fun = "".join(rng.choice(list(AA), 60))
    d = str(tmp_path / "d")
    write_data_dir(d, signatures_from_proteins([(fun, 0, 3)], weight=0.5),
                   ["funcA"])
    if mode == "aa":
        seqs = [s for c in ("short", "x_and_stops", "straddle")
                for s in _proteins(c, rng)] + [fun, fun[5:] + "X" + fun]
    else:
        seqs = [s for c in ("short", "n_and_stops", "above_limit")
                for s in _contigs(c, rng)] + ["".join(CODON[c] for c in fun)]
    # (a FASTA record holds one residue at least)
    fasta = "".join(f">q{i}\n{s}\n" for i, s in enumerate(seqs) if s)
    aa = mode == "aa"
    got = _report(Engine, EngineConfig(aa=aa, device="cpu",
                                       prepare_impl="jax", min_hits=2),
                  d, fasta)
    want = _report(JaxEngine, JaxConfig(aa=aa, prepare_impl="jax",
                                        min_hits=2), d, fasta)
    assert got == want and "CALL\t" in got
    assert len(small_budget) > 1
