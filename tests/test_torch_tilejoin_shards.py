"""The port's sharded sparse lookup (kmergutsjava_tpu_torch/parallel/
tilejoin_shards.py: each dispatch's queries routed to the shard that owns
their home, B1 on each shard's slice and halo; on the CPU B1's plain twin),
which the ``xla`` backend takes with ``--mesh`` over more than one device,
against the JAX package on its eight virtual CPU devices: the hits equal
the parity scan's and one device's, the first-pass answers equal one
device's query for query, the streaming front end drives it unchanged, the
engine's ``xla`` with a mesh holds this class (and, with too few devices,
the one-device lookup), and ``--mesh 2x2`` on ``xla`` gives the JAX
engine's reports (aa and DNA). Exact."""
import numpy as np
import pytest
import torch

from kmergutsjava_tpu_torch.lookup.parity import lookup_stream
from kmergutsjava_tpu_torch.lookup.sparse import SparseLookup, StreamingLookup
from kmergutsjava_tpu_torch.models import pipeline
from kmergutsjava_tpu_torch.parallel.mesh import make_mesh
from kmergutsjava_tpu_torch.parallel.tilejoin_shards import \
    TileJoinShardedLookup

from test_tilejoin import _mixed_queries, _sorted_cols
from test_torch_mesh import corpus, both, port_report  # noqa: F401
from test_torch_sharded import tables

CPU8 = [torch.device("cpu")] * 8


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(_sorted_cols(got), _sorted_cols(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_shards", [2, 8, 3])
def test_sharded_matches_parity_and_single(n_shards):
    _, sig, _, pt = tables(21 + n_shards, 60_000, 0.6)
    lk = TileJoinShardedLookup(pt, make_mesh(1, n_shards, CPU8),
                               chunk=4096)
    values = _mixed_queries(sig["kmers"], 6000, seed=22)
    cnt = np.zeros(len(values), np.int64)
    pos = np.arange(len(values), dtype=np.int64)
    want = lookup_stream(pt, values, cnt, pos)
    _equal(lk.lookup(values, cnt, pos), want)
    one = SparseLookup(pt, device="cpu", chunk=4096)
    _equal(one.lookup(values, cnt, pos), want)
    q = (values % 65535).astype(np.uint16)
    h = (values % pt.num_sigs).astype(np.int32)
    for a, b in zip(lk.resolve_probe(lk.dispatch_probe(q, h)),
                    one.resolve_probe(one.dispatch_probe(q, h))):
        np.testing.assert_array_equal(a, b)


def test_sharded_streaming_front_end():
    _, sig, _, pt = tables(23, 40_000, 0.6)
    lk = TileJoinShardedLookup(pt, make_mesh(1, 4, CPU8), chunk=2048)
    values = _mixed_queries(sig["kmers"], 5000, seed=24)
    want = lookup_stream(pt, values, np.zeros(len(values), np.int64),
                         np.arange(len(values), dtype=np.int64))
    st = StreamingLookup(lk, compute_kmers_found=True)
    for s in range(0, len(values), 1300):
        e = min(s + 1300, len(values))
        st.add_batch(values[s:e], 0, np.arange(s, e, dtype=np.int64))
    got = st.finish()
    _equal(got, want)
    assert got.kmers_found == want.kmers_found


def test_engine_xla_mesh_uses_sharded_lookup(corpus):  # noqa: F811
    """``xla`` with a 1x4 mesh caches this class; with 16 asked on 8
    devices (a ValueError of the mesh) the one-device lookup."""
    d, texts, _ = corpus
    port_report(d, texts["few"], True, backend="xla", mesh_shape=(1, 4))
    lk = next(iter(pipeline._LOOKUP_CACHE.values()))
    assert isinstance(lk, TileJoinShardedLookup) and lk.n_shards == 4
    port_report(d, texts["few"], True, backend="xla", mesh_shape=(4, 4))
    lk = next(iter(pipeline._LOOKUP_CACHE.values()))
    assert type(lk) is SparseLookup


@pytest.mark.parametrize("mode", ["aa", "dna"])
def test_xla_mesh_backend_reports_equal_jax(corpus, mode):  # noqa: F811
    d, texts, _ = corpus
    got, want = both(d, texts[mode], mode == "aa", backend="xla",
                     mesh_shape=(2, 2), min_hits=2)
    assert got == want and "CALL\t" in got
