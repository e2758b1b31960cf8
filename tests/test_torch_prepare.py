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
