"""The PyTorch package's host formats against the JAX package's: a table
built from the same signatures is byte-identical on disk, and FASTA and
function-index parsing agree record for record."""
import gzip
import io
import os

import numpy as np
import pytest

from kmergutsjava_tpu.formats import fasta as jax_fasta
from kmergutsjava_tpu.formats import function_index as jax_fi
from kmergutsjava_tpu.formats import kmer_table as jax_kt
from kmergutsjava_tpu.formats import table_tools as jax_tt
from kmergutsjava_tpu_torch.formats import fasta as port_fasta
from kmergutsjava_tpu_torch.formats import function_index as port_fi
from kmergutsjava_tpu_torch.formats import kmer_table as port_kt
from kmergutsjava_tpu_torch.formats import table_tools as port_tt

from corpus_util import corpus_path

AA = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(scope="module")
def proteins():
    return list(jax_fasta.read_fasta(
        corpus_path("Ecoli_K12_W3110.faa.gz")))[:300]


@pytest.mark.parametrize("load_factor", [0.5, 0.7, 0.9])
def test_table_bytes_identical(tmp_path, proteins, load_factor):
    triples = [(p.seq, i % 97, i % 20) for i, p in enumerate(proteins)]
    sig_j = jax_tt.signatures_from_proteins(triples)
    sig_p = port_tt.signatures_from_proteins(triples)
    for k in sig_j:
        np.testing.assert_array_equal(sig_j[k], sig_p[k])
    files = []
    for mod, sig, d in ((jax_kt, sig_j, "j"), (port_kt, sig_p, "p")):
        table = mod.build_table(**sig, load_factor=load_factor)
        path = str(tmp_path / d)
        mod.write_table(path, table, write_meta=False)
        files.append(open(path, "rb").read())
    assert files[0] == files[1]
    back = port_kt.read_table(str(tmp_path / "p"))
    assert back.num_sigs == jax_kt.read_table(str(tmp_path / "j")).num_sigs
    assert not back.truncated


def test_data_dir_identical(tmp_path, proteins):
    triples = [(p.seq, i % 7, i % 3) for i, p in enumerate(proteins[:50])]
    funcs = [f"function {i}" for i in range(7)]
    for mod, d in ((jax_tt, "j"), (port_tt, "p")):
        mod.write_data_dir(str(tmp_path / d),
                           mod.signatures_from_proteins(triples), funcs,
                           load_factor=0.7, gz=True)
    for name in sorted(os.listdir(tmp_path / "j")):
        a = (tmp_path / "j" / name).read_bytes()
        b = (tmp_path / "p" / name).read_bytes()
        if name.endswith(".gz"):
            a, b = gzip.decompress(a), gzip.decompress(b)
        assert a == b, name
    assert port_fi.load_function_index(
        str(tmp_path / "p" / "function.index.gz")) == funcs


FASTA_CASES = [
    ">P1 first protein\nACDEFGHIK\nLMNPQ\n>P2\n\nRSTVWY*\n",
    ">a\r\nAC DE\r\n>b  desc  with spaces \nxx\n>c\n",
    "junk before\n>x\nAAA\n>y\n",
    ">only header",
    "",
]


@pytest.mark.parametrize("text", FASTA_CASES)
def test_fasta_records_agree(text):
    def run(mod):
        try:
            return list(mod.read_fasta(io.StringIO(text)))
        except Exception as ex:  # noqa: BLE001 — compare the failure too
            return type(ex).__name__, str(ex)

    want = run(jax_fasta)
    got = run(port_fasta)
    if isinstance(want, tuple):
        assert got == want
    else:
        assert [tuple(r) for r in got] == [tuple(r) for r in want]


def test_fasta_corpus_bulk_arrays_agree():
    path = corpus_path("Ecoli_K12_W3110.faa.gz")
    a = jax_fasta.read_fasta_bulk_arrays(path)
    b = port_fasta.read_fasta_bulk_arrays(path)
    assert (a is None) == (b is None)
    if a is not None:
        assert a.nrec == b.nrec
        np.testing.assert_array_equal(a.rec, b.rec)
        # the buffer's tail past the last record is unused capacity
        end = int((a.rec[:, 0::2] + a.rec[:, 1::2]).max())
        np.testing.assert_array_equal(a.buf[:end], b.buf[:end])


def test_function_index_agrees(tmp_path):
    names = ["alpha", "beta gamma", "", "delta\tx"]
    jax_fi.write_function_index(str(tmp_path / "f"), names)
    port_fi.write_function_index(str(tmp_path / "g"), names)
    assert (tmp_path / "f").read_bytes() == (tmp_path / "g").read_bytes()
    assert (port_fi.load_function_index(str(tmp_path / "f"))
            == jax_fi.load_function_index(str(tmp_path / "f")))
