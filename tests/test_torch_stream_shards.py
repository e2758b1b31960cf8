"""The port's sharded stream lookup (kmergutsjava_tpu_torch/parallel/
stream_shards.py: the plane and the tiles split into slot ranges, B2 on
each; on the CPU B2's plain twin) against the JAX package on its eight
virtual CPU devices: the hits and ``kmers_found`` equal the parity scan's
at the JAX test's shapes (a tiny table over 8 shards, several slot ranges
a shard), the packed answer equals one device's pass bit for bit, a dense
sweep of every slot, the JAX mesh's quirk (too few devices: fewer shards,
silently), and ``--mesh 2x2`` on the ``stream`` backend gives the JAX
engine's reports (aa and DNA). Exact."""
import numpy as np
import pytest
import torch

from kmergutsjava_tpu_torch.lookup.parity import lookup_stream
from kmergutsjava_tpu_torch.lookup.stream import StreamLookup, stream_probe
from kmergutsjava_tpu_torch.parallel.stream_shards import (
    StreamShardedLookup, make_stream_mesh, scatter_host)

from test_lookup import canon, make_queries
from test_torch_mesh import corpus, both  # noqa: F401  (a fixture)
from test_torch_sharded import tables

CPU8 = [torch.device("cpu")] * 8


@pytest.mark.parametrize("n_shards,n_sigs,seed", [
    (2, 2500, 0),
    (8, 2500, 1),     # tiny table: some shards hold a few slots
    (8, 40000, 2),
    (3, 60000, 3),    # slot ranges that do not divide evenly
])
def test_stream_sharded_matches_parity(n_shards, n_sigs, seed):
    rng, sig, _, pt = tables(seed, n_sigs, 0.7)
    lk = StreamShardedLookup(pt, make_stream_mesh(n_shards, CPU8))
    assert lk.n_shards == n_shards
    assert lk.ranges[0][0] == 0 and lk.ranges[-1][1] == lk.slots
    values, cnt, pos = make_queries(rng, sig["kmers"], 2 * n_sigs)
    a = lookup_stream(pt, values, cnt, pos)
    b = lk.lookup(values, cnt, pos)
    assert canon(a) == canon(b)
    assert a.kmers_found == b.kmers_found
    one = StreamLookup(pt, device="cpu")
    s = lk._sets.take()  # host tiles: the sharded lookup's own scatter
    scatter_host(values, s.tiles, s.occ, lk.num_sigs)
    np.testing.assert_array_equal(
        lk._probe(s), stream_probe(one.fp, torch.from_numpy(s.tiles),
                                   one.w, one.channels).numpy())


def test_stream_sharded_dense_sweep():
    """Every slot queried on three channels: the hits are exactly the
    parity scan's."""
    _, _, _, pt = tables(7, 30000, 0.65)
    lk = StreamShardedLookup(pt, make_stream_mesh(8, CPU8))
    s = np.int64(pt.num_sigs)
    slots = np.arange(s, dtype=np.int64)
    ch0 = np.where(pt.occupied, pt.slots["kmer"], slots)
    values = np.concatenate([ch0] + [slots + k * s for k in range(1, 3)])
    cnt = np.zeros(len(values), np.int64)
    pos = np.arange(len(values), dtype=np.int64)
    a = lookup_stream(pt, values, cnt, pos)
    b = lk.lookup(values, cnt, pos)
    assert canon(a) == canon(b)
    assert len(b) >= int(pt.occupied.sum())


def test_stream_mesh_takes_the_devices_there_are():
    """As the JAX package's make_stream_mesh: 16 shards asked on 8 devices
    give 8 shards, no error."""
    assert make_stream_mesh(16, CPU8).shape == {"data": 1, "table": 8}


@pytest.mark.parametrize("mode", ["aa", "dna"])
def test_stream_mesh_backend_reports_equal_jax(corpus, mode):  # noqa: F811
    d, texts, _ = corpus
    got, want = both(d, texts[mode], mode == "aa", backend="stream",
                     mesh_shape=(2, 2), min_hits=2)
    assert got == want and "CALL\t" in got
