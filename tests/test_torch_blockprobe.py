"""The PyTorch package's block probe (kmergutsjava_tpu_torch/lookup/
blockprobe.py, on the CPU through the kernel's plain twin) against the JAX
package: the twin, given queries in any order, must give ``probe_blocks``'s
(off, state) in interpret mode (its tile layout built from the same queries
sorted by home, the answers mapped back by the sort's permutation) cell for
cell, and ``BlockProbeLookup`` the hits of ``PallasLookup`` (in
interpret mode, in the same input order) and of the parity scan
``lookup_stream``, including a block whose queries overflow the TPU tile.
Exact everywhere: offsets and states are integers, weights are copied
table values."""
import numpy as np
import pytest
import torch

from kmergutsjava_tpu.constants import MAX_ENCODED
from kmergutsjava_tpu.formats.kmer_table import build_table
from kmergutsjava_tpu.lookup.pallas_kernel import (BLOCK, HALO, QCAP,
                                                   PallasLookup, probe_blocks)
from kmergutsjava_tpu.lookup.parity import lookup_stream
from kmergutsjava_tpu_torch.formats.kmer_table import \
    build_table as port_build_table
from kmergutsjava_tpu_torch.lookup import blockprobe
from kmergutsjava_tpu_torch.lookup.blockprobe import BlockProbeLookup

from test_lookup import make_queries
from test_table import random_signatures
from test_torch_stream import _same

FP_EMPTY = 65535


def _plane_and_queries(nblocks, n, w, seed):
    """A plane of ``nblocks`` blocks + halo over few distinct values (so
    fingerprint collisions are common) with 8% empties, except a run of
    1500 slots in block 1 that holds none (full windows); ``n`` queries,
    40% of them carrying the value found a random offset into their window
    (a candidate that may lie after an empty), the first 16 homed in the
    last slots of the last block."""
    rng = np.random.default_rng(seed)
    size = nblocks * BLOCK + HALO
    fp = rng.integers(0, 300, size).astype(np.uint16)
    empty = rng.random(size) < 0.08
    empty[BLOCK:BLOCK + 1500] = False
    fp[empty] = FP_EMPTY
    homes = rng.integers(0, nblocks * BLOCK, n)
    homes[:16] = nblocks * BLOCK - 1 - np.arange(16)
    qfp = rng.integers(0, 300, n).astype(np.uint16)
    planted = rng.random(n) < 0.4
    at = homes + rng.integers(0, w, n)
    qfp[planted] = np.where(fp[at[planted]] == FP_EMPTY, 5, fp[at[planted]])
    return fp, qfp, homes.astype(np.int32)


def _jax_probe(fp, q_sorted, h_sorted, nblocks, w):
    """The Pallas kernel in interpret mode on the TPU layout (overlapped
    [nblocks, 1, BLOCK + HALO] plane rows, [nblocks, 1, QCAP] query tiles)
    built from home-sorted queries (numpy arrays); answers in sorted
    order."""
    h = h_sorted.astype(np.int64)
    blk = h // BLOCK
    rank = np.arange(len(h)) - np.searchsorted(blk, blk)
    assert rank.max() < QCAP
    fp_blocks = np.ascontiguousarray(np.lib.stride_tricks.as_strided(
        fp, shape=(nblocks, BLOCK + HALO), strides=(BLOCK * 2, 2)))
    qt = np.full((nblocks, QCAP), FP_EMPTY, np.uint16)
    lt = np.zeros((nblocks, QCAP), np.int32)
    qt[blk, rank] = q_sorted
    lt[blk, rank] = h - blk * BLOCK
    off, state = probe_blocks(fp_blocks[:, None, :], qt[:, None, :],
                              lt[:, None, :], nblocks, w, interpret=True)
    return (np.asarray(off)[:, 0, :][blk, rank],
            np.asarray(state)[:, 0, :][blk, rank])


@pytest.mark.parametrize("order", ["random", "home"])
@pytest.mark.parametrize("w", [8, 16, 32, 64, 128])
def test_twin_matches_probe_blocks_interpret(w, order):
    nblocks = 3
    fp, qfp, homes = _plane_and_queries(nblocks, 4000, w, seed=w)
    if order == "home":
        p = np.argsort(homes, kind="stable")
        qfp, homes = qfp[p], homes[p]
    off, state = blockprobe.block_probe(torch.from_numpy(fp),
                                        torch.from_numpy(qfp),
                                        torch.from_numpy(homes), w)
    perm = np.argsort(homes, kind="stable")
    j_off, j_state = _jax_probe(fp, qfp[perm], homes[perm], nblocks, w)
    np.testing.assert_array_equal(off.numpy()[perm], j_off)
    np.testing.assert_array_equal(state.numpy()[perm], j_state)
    st = state.numpy()
    assert {0, 1, 2, 3} <= set(st.tolist())
    # a candidate reported after an empty slot: off > 0 with has_cand unset
    assert ((st == 2) & (off.numpy() > 0)).any()


def test_twin_chunking():
    """Chunk boundaries change nothing."""
    fp, qfp, homes = _plane_and_queries(4, 3000, 16, seed=2)
    args = [torch.from_numpy(a) for a in (fp, qfp, homes)]
    a = blockprobe.block_probe_reference(*args, 16)
    b = blockprobe.block_probe_reference(*args, 16, chunk=333)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_off_plane_window_is_unresolved():
    """A window that runs off the plane (home < 0 or home + w past its end)
    gives (off 0, state 0), never an index error; the last window that
    fits is answered."""
    w = 32
    fp, qfp, homes = _plane_and_queries(1, 50, w, seed=3)
    n = len(fp)
    homes[:5] = [-1, n - w + 1, n - 1, n, 1 << 30]
    homes[5] = n - w
    qfp[5] = fp[n - 1]
    off, state = blockprobe.block_probe_reference(
        *[torch.from_numpy(a) for a in (fp, qfp, homes)], w)
    assert off[:5].tolist() == [0] * 5 and state[:5].tolist() == [0] * 5
    assert int(state[5]) != 0


def _tables(seed, n_sigs, load):
    rng = np.random.default_rng(seed)
    sig = random_signatures(rng, n_sigs)
    jax_t = build_table(**sig, load_factor=load)
    port_t = port_build_table(**sig, load_factor=load)
    assert jax_t.slots.tobytes() == port_t.slots.tobytes()
    return rng, sig, jax_t, port_t


def _in_order(got, want):
    """Hits in the queries' input order, column for column."""
    for col in ("cnt_id", "pos", "otu", "avg_from_end", "fi", "wt"):
        a, b = getattr(got, col), getattr(want, col)
        assert a.dtype == b.dtype, col
        np.testing.assert_array_equal(a, b)
    assert got.kmers_found == want.kmers_found


@pytest.mark.parametrize("seed,load,nq", [(0, 0.6, 3000), (1, 0.9, 6000)])
def test_lookup_matches_pallas_lookup_and_parity(seed, load, nq):
    """The seeds of tests/test_pallas_lookup.py."""
    rng, sig, jax_t, port_t = _tables(seed, 3000, load)
    values, cnt, pos = make_queries(rng, sig["kmers"], nq)
    lk = BlockProbeLookup(port_t, device="cpu")
    jlk = PallasLookup(jax_t)
    assert lk.w == jlk.w
    got = lk.lookup(values, cnt, pos)
    assert len(got) > 0
    _in_order(got, jlk.lookup(values, cnt, pos))
    _same(got, lookup_stream(jax_t, values, cnt, pos))


def test_lookup_dense_queries():
    """Every signature queried once (density ~ the load factor)."""
    rng, sig, jax_t, port_t = _tables(7, 5000, 0.7)
    v = sig["kmers"]
    z, p = np.zeros(len(v)), np.arange(len(v))
    got = BlockProbeLookup(port_t, device="cpu").lookup(v, z, p)
    assert len(got) == len(v)
    _in_order(got, PallasLookup(jax_t).lookup(v, z, p))
    _same(got, lookup_stream(jax_t, v, z, p))


def test_block_past_tpu_tile_capacity():
    """3,000 queries home into block 0: the TPU tile holds 2,176 and the
    JAX lookup sends the rest to its exact path; the port has no capacity.
    The hits are equal."""
    rng, sig, jax_t, port_t = _tables(3, 20000, 0.6)
    s = port_t.num_sigs
    kmers = sig["kmers"]
    in_block0 = kmers[kmers % s < BLOCK]
    n_miss = 3000 - 2 * len(in_block0)
    misses = (rng.integers(0, BLOCK, n_miss)
              + s * rng.integers(1, MAX_ENCODED // s - 1, n_miss))
    values = np.concatenate([in_block0, in_block0, misses,
                             rng.choice(kmers, 500)]).astype(np.int64)
    rng.shuffle(values)
    assert (values % s < BLOCK).sum() > QCAP
    cnt = rng.integers(0, 7, len(values)).astype(np.int64)
    pos = np.arange(len(values), dtype=np.int64)
    got = BlockProbeLookup(port_t, device="cpu").lookup(values, cnt, pos)
    assert len(got) >= 2 * len(in_block0)
    _in_order(got, PallasLookup(jax_t).lookup(values, cnt, pos))
    _same(got, lookup_stream(jax_t, values, cnt, pos))


def test_empty_query_set():
    _, _, jax_t, port_t = _tables(4, 500, 0.6)
    z = np.zeros(0, dtype=np.int64)
    got = BlockProbeLookup(port_t, device="cpu").lookup(z, z, z)
    want = PallasLookup(jax_t).lookup(z, z, z)
    assert len(got) == len(want) == 0
    assert got.kmers_found == want.kmers_found
    off, state = blockprobe.block_probe(
        torch.zeros(BLOCK + HALO, dtype=torch.uint16),
        torch.zeros(0, dtype=torch.uint16), torch.zeros(0, dtype=torch.int32),
        16)
    assert off.numel() == state.numel() == 0


def test_window_past_128_is_the_jax_value_error():
    from types import SimpleNamespace

    fake = SimpleNamespace(max_probe=129, num_sigs=1000)
    with pytest.raises(ValueError, match="max_probe exceeds kernel halo"):
        BlockProbeLookup(fake, device="cpu")
