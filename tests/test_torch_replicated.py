"""The port's replicated lookup (kmergutsjava_tpu_torch/parallel/
replicated_lookup.py: the plane on every data device, the queries split,
B1 on each slice; on the CPU B1's plain twin) against the JAX package on
its eight virtual CPU devices: the hits and ``kmers_found`` equal the
parity scan's (as the JAX test holds its module), its first-pass answers
equal one device's, and the ``replicated`` backend's reports (aa and DNA)
the JAX engine's byte for byte. Exact."""
import numpy as np
import pytest
import torch

from kmergutsjava_tpu_torch.lookup.parity import lookup_stream
from kmergutsjava_tpu_torch.lookup.sparse import SparseLookup
from kmergutsjava_tpu_torch.parallel.mesh import make_mesh
from kmergutsjava_tpu_torch.parallel.replicated_lookup import ReplicatedLookup

from test_lookup import canon, make_queries
from test_torch_mesh import corpus, both  # noqa: F401  (a fixture)
from test_torch_sharded import tables


@pytest.mark.parametrize("n_dev,seed", [(2, 0), (8, 1), (3, 2)])
def test_replicated_matches_parity(n_dev, seed):
    rng, sig, _, pt = tables(seed, 2500, 0.75)
    rl = ReplicatedLookup(pt, make_mesh(n_dev, 1,
                                        [torch.device("cpu")] * 8))
    values, cnt, pos = make_queries(rng, sig["kmers"], 5001)
    a = lookup_stream(pt, values, cnt, pos)
    b = rl.lookup(values, cnt, pos)
    assert canon(a) == canon(b)
    assert a.kmers_found == b.kmers_found
    # the split answers are one device's, query for query
    one = SparseLookup(pt, device="cpu")
    assert rl.w1 == one.w1
    q_fp = (values % 65535).astype(np.uint16)
    homes = (values % pt.num_sigs).astype(np.int32)
    off, state = rl.resolve_probe(rl.dispatch_probe(q_fp, homes))
    want_off, want_state = one.resolve_probe(one.dispatch_probe(q_fp, homes))
    np.testing.assert_array_equal(off, want_off)
    np.testing.assert_array_equal(state, want_state)


@pytest.mark.parametrize("mode", ["aa", "dna"])
def test_replicated_backend_reports_equal_jax(corpus, mode):  # noqa: F811
    """``--backend replicated`` over all eight devices and at ``--mesh
    2x2`` (four data devices): the JAX engine's report."""
    d, texts, _ = corpus
    for shape in (None, (2, 2)):
        got, want = both(d, texts[mode], mode == "aa", backend="replicated",
                         mesh_shape=shape, min_hits=2)
        assert got == want and "CALL\t" in got
