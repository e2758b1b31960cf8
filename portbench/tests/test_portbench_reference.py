"""The plain reference against the checked-in goldens and against itself."""
import gzip
import os
import random

import numpy as np
import pytest

from portbench.core import corpus
from portbench.core.tables import write_data_dir
from portbench.reference import fasta, grouping, lookup, prepare
from portbench.reference.annotate import annotate
from portbench.reference.fasta import Record
from portbench.reference.javafmt import jformat
from portbench.reference.table import open_table

from .conftest import ROOT

GOLDENS = os.path.join(ROOT, "tests", "data")


@pytest.fixture(scope="module")
def corpus800(tmp_path_factory):
    """The goldens' table: the first 800 proteins' signatures at load 0.7
    (the recipe of tests/corpus_util.py), placed by the benchmark's own
    builder."""
    prots = corpus.proteome()[:800]
    d = str(tmp_path_factory.mktemp("corpus800"))
    write_data_dir(d, corpus.corpus_signatures(prots),
                   corpus.function_names(97), 0.7)
    return d, prots


def _golden(name):
    with gzip.open(os.path.join(GOLDENS, name), "rt") as fh:
        return fh.read()


def test_reference_reproduces_the_protein_golden(corpus800):
    d, prots = corpus800
    text = "".join(f">{i} {descr}\n{seq}\n" for i, descr, seq in prots)
    assert annotate(text, d, True) == _golden("golden_aa_800.txt.gz")


def test_reference_reproduces_the_dna_golden(corpus800):
    d, _ = corpus800
    gid, descr, seq = corpus.genome()
    text = f">{gid} {descr}\n{seq[:300_000]}\n"
    assert annotate(text, d, False) == _golden("golden_dna_800.txt.gz")


def test_control_differs_from_the_reference(corpus800):
    """The bfloat16 control fails the comparison the benchmark makes."""
    d, prots = corpus800
    text = "".join(f">{i}\n{seq}\n" for i, _, seq in prots)
    want = annotate(text, d, True)
    got = annotate(text, d, True, precision="bfloat16")
    assert got != want


@pytest.mark.parametrize("seed", range(6))
def test_probe_answers_as_the_scan(tmp_path, seed):
    """The per-query probe and the reference's forward-only scan give the
    same slot for every query, on crowded tables."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(200, 3000))
    kmers = np.unique(rng.integers(0, 20 ** 8, n))
    sig = dict(kmers=kmers, otu=np.zeros(len(kmers), np.int32),
               avg_from_end=np.zeros(len(kmers), np.int32),
               fi=np.zeros(len(kmers), np.int32),
               wt=np.ones(len(kmers), np.float32))
    write_data_dir(str(tmp_path), sig, ["f"], float(rng.uniform(0.5, 0.97)))
    table = open_table(str(tmp_path))
    queries = np.concatenate([rng.choice(kmers, n), rng.integers(
        0, 20 ** 8, n), kmers[:5], kmers[:5]])
    np.testing.assert_array_equal(lookup.probe(table, queries),
                                  lookup.scan(table, queries))


def _random_records(rnd, aa, same_length=False):
    alpha = "ACDEFGHIKLMNPQRSTVWYXU*acg" if aa else "ACGTNacgtRYKMu"
    length = rnd.randint(1, 70)
    return [Record(f"r{i}", "".join(
        rnd.choice(alpha) for _ in range(length if same_length
                                         else rnd.randint(1, 70))))
            for i in range(rnd.randint(1, 7))]


@pytest.mark.parametrize("aa", [True, False])
def test_count_is_the_number_of_queries(aa):
    rnd = random.Random(int(aa))
    for _ in range(200):
        recs = _random_records(rnd, aa, same_length=rnd.random() < 0.3)
        assert prepare.count(recs, aa) == len(prepare.queries(recs, aa)
                                              .values)


def test_equal_length_reads_take_the_general_path_s_frames():
    """Read sets (equal lengths) are laid out as a matrix; a contig of
    another length sends the same reads through the general layout, and
    their queries must not change."""
    rnd = random.Random(7)
    for _ in range(50):
        recs = _random_records(rnd, False, same_length=True)
        q = prepare.queries(recs, False)
        q2 = prepare.queries(recs + [Record("other", "ACGTACGTACGTACGTA"
                                                     "CGTACGTAC" * 3)],
                             False)
        mine = q2.container < 6 * len(recs)
        order = np.lexsort((q.pos, q.container))
        order2 = np.lexsort((q2.pos[mine], q2.container[mine]))
        np.testing.assert_array_equal(q.values[order],
                                      q2.values[mine][order2])


def test_java_rounding_is_half_up():
    assert jformat(0.0078125) == "0.007813"  # Python's %f gives 0.007812
    assert jformat(2.5, 0) == "3"
    assert jformat(-0.0) == "-0.000000"


def test_fasta_follows_the_reference_reader():
    text = "\n  >\n>a b c\n\nAC GT\nTT\n>b\tx\nGG\n"
    assert list(fasta.parse(text)) == [Record("a", "AC GTTT"),
                                       Record("b", "GG")]
    with pytest.raises(ValueError):
        list(fasta.parse(">a\n>b\nAC\n"))
    with pytest.raises(ValueError):
        list(fasta.parse("xx\n"))


def test_bfloat16_sum_rounds_each_step():
    ones = np.ones(300, np.float32)
    assert grouping.weight_sum(ones, "float32") == 300
    assert grouping.weight_sum(ones, "bfloat16") == 256
