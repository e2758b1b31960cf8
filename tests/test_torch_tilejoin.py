"""The PyTorch package's tile-join probe (kmergutsjava_tpu_torch/lookup/
tilejoin.py) against the JAX package's: its plain twin must give the same
per-query (off, state) as the Pallas kernel run in interpret mode (decoded
by unpack_fst/decode_fst), and as the flat XLA probe for windows the TPU
kernel does not take. Exact: the codes are integers. The CUDA kernel itself
is compared with the twin on the card by test_torch_kernels.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmergutsjava_tpu.lookup.pallas_tilejoin import (TPG, band_geometry,
                                                    bin_queries_tiles,
                                                    decode_fst, plane_tiles,
                                                    tilejoin_probe,
                                                    unpack_fst)
from kmergutsjava_tpu.lookup.xla import probe_fingerprint_pass
from kmergutsjava_tpu_torch.lookup import tilejoin

from test_torch_kernels import B1_EDGES, FP_EMPTY, _b1_edge, _plane, _queries


def _twin(fp, qfp, homes, w):
    plane = np.concatenate([fp, np.full(w, FP_EMPTY, np.uint16)])
    off, state = tilejoin.tilejoin_probe(torch.from_numpy(plane),
                                         torch.from_numpy(qfp),
                                         torch.from_numpy(homes), w)
    return off.numpy(), state.numpy()


@pytest.mark.parametrize("form,cap,w", [("gather", 512, 16),
                                        ("gather", 512, 32),
                                        ("gather2b", 1024, 16),
                                        ("gather2b", 1024, 32)])
def test_twin_matches_pallas_tilejoin_interpret(form, cap, w):
    stride = 128 - w
    # a super-tile and a half of plane rows: two grid blocks
    n_slots = stride * 128 * TPG * 3 // 2
    fp = _plane(n_slots, seed=w)
    qfp, homes = _queries(fp, 3000, w, seed=cap + w)
    # the JAX kernel's layout: overlapped rows1 plane, transposed tiles
    nrows = -(-n_slots // stride)
    ext = np.concatenate([fp, np.full((nrows - 1) * stride + 128 - n_slots,
                                      FP_EMPTY, np.uint16)])
    fp2d = np.ascontiguousarray(np.lib.stride_tricks.as_strided(
        ext, shape=(nrows, 128), strides=(2 * stride, 2)))
    n_bands = band_geometry(w, cap // 128)[0] if form == "gather2b" else 1
    if form == "gather2b":
        assert n_bands == 8  # the production banded point
    ids, packed_b, block_of, rank_of = bin_queries_tiles(
        qfp, homes.astype(np.int64), stride, cap, n_bands=n_bands)
    assert len(ids) == 2
    assert (rank_of < TPG * cap).all()  # no bin overflow: every cell probed
    out = tilejoin_probe(plane_tiles(fp2d, form=form), jnp.asarray(ids),
                         jnp.asarray(packed_b), w, cap // 128, form=form,
                         interpret=True)
    want_off, want_state = decode_fst(
        unpack_fst(np.asarray(out), cap)[block_of, rank_of], w)
    got_off, got_state = _twin(fp, qfp, homes, w)
    np.testing.assert_array_equal(got_state, want_state)
    np.testing.assert_array_equal(got_off, want_off)
    assert set(np.unique(got_state)) == {0, 1, 2}


@pytest.mark.parametrize("w", [128, 256])
def test_twin_matches_flat_probe_wide_windows(w):
    fp = _plane(20_000, seed=w, empty_frac=0.02)
    qfp, homes = _queries(fp, 4000, w, seed=w + 1)
    plane = np.concatenate([fp, np.full(w, FP_EMPTY, np.uint16)])
    want_off, want_state = probe_fingerprint_pass(
        jnp.asarray(plane), jnp.asarray(qfp), jnp.asarray(homes), w)
    got_off, got_state = _twin(fp, qfp, homes, w)
    np.testing.assert_array_equal(got_state, np.asarray(want_state))
    np.testing.assert_array_equal(got_off, np.asarray(want_off))
    assert set(np.unique(got_state)) == {0, 1, 2}


def _flat_vs_twin(fp, qfp, homes, w, lead=0):
    """The twin (on a plane ``lead`` slots into its allocation) against the
    JAX package's flat first-event probe, every (off, state) equal."""
    plane = np.concatenate([fp, np.full(w, FP_EMPTY, np.uint16)])
    want_off, want_state = probe_fingerprint_pass(
        jnp.asarray(plane), jnp.asarray(qfp), jnp.asarray(homes), w)
    view = torch.cat([torch.zeros(lead, dtype=torch.uint16),
                      torch.from_numpy(plane)])[lead:]
    off, state = tilejoin.tilejoin_probe(view, torch.from_numpy(qfp),
                                         torch.from_numpy(homes), w)
    np.testing.assert_array_equal(state.numpy(), np.asarray(want_state))
    np.testing.assert_array_equal(off.numpy(), np.asarray(want_off))
    return state.numpy()


@pytest.mark.parametrize("w", [1, 7, 9, 16, 17, 64, 256])
def test_twin_matches_flat_probe_at_kernel_widths(w):
    """The widths the card's tests give the CUDA kernel (one vector, a
    vector and a slot, two vectors and a slot, the cap)."""
    fp = _plane(20_000, seed=w + 3, empty_frac=0.35 if w < 64 else 0.03)
    qfp, homes = _queries(fp, 4000, w, seed=w + 4)
    assert set(np.unique(_flat_vs_twin(fp, qfp, homes, w))) == {0, 1, 2}


@pytest.mark.parametrize("case", [c for c in B1_EDGES if c != "off_plane"])
def test_twin_matches_flat_probe_at_kernel_edges(case):
    """The card tests' in-plane edge cases (test_torch_kernels._b1_edge);
    off-plane homes are left out: the JAX gather clamps them, where the
    port leaves them unresolved."""
    fp, qfp, homes, w, lead = _b1_edge(case, n=8000)
    st = _flat_vs_twin(fp, qfp, homes, w, lead)
    assert st.any()
