"""The PyTorch package's tile-join kernel wrapper and its plain twin
(kmergutsjava_tpu_torch/lookup/tilejoin.py), without JAX, so the file also
runs on a GPU machine that has no JAX: there, from the repository root,

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

runs the ``cuda`` tests too, which compare the CUDA kernel with the twin on
the card (exact: the codes are integers). Elsewhere they skip."""
import numpy as np
import pytest
import torch

from kmergutsjava_tpu_torch.lookup import tilejoin

FP_EMPTY = 65535


def _plane(n_slots, seed, empty_frac=0.35):
    """Seeded u16 fingerprint plane with planted empties; its last fifth
    holds no empties, so full windows (state 0) occur too."""
    rng = np.random.default_rng(seed)
    fp = rng.integers(0, 60000, n_slots).astype(np.uint16)
    head = n_slots * 4 // 5
    fp[:head][rng.random(head) < empty_frac] = FP_EMPTY
    return fp


def _queries(fp, n, w, seed):
    """Half the queries carry the fingerprint found a random offset into
    their window (a candidate unless an empty comes first), half a random
    one."""
    rng = np.random.default_rng(seed)
    homes = rng.integers(0, len(fp), n).astype(np.int32)
    qfp = rng.integers(0, 60000, n).astype(np.uint16)
    planted = rng.random(n) < 0.5
    at = np.minimum(homes + rng.integers(0, w, n), len(fp) - 1)
    qfp[planted] = np.where(fp[at[planted]] == FP_EMPTY, 7,
                            fp[at[planted]])
    return qfp, homes


def _plane_t(fp, w):
    return torch.from_numpy(np.concatenate([fp, np.full(w, FP_EMPTY,
                                                        np.uint16)]))


def test_twin_chunking_and_off_plane_homes():
    """Chunk boundaries change nothing, and a home whose window runs off
    the plane is unresolved (the kernel's rule), never an index error."""
    fp = _plane(5000, seed=3)
    qfp, homes = _queries(fp, 3000, 16, seed=4)
    homes[:5] = [-1, 4990, 4999, 5000, 1 << 30]
    t = [torch.from_numpy(a) for a in (fp, qfp, homes)]
    off_a, st_a = tilejoin.first_event_reference(*t, 16)
    off_b, st_b = tilejoin.first_event_reference(*t, 16, chunk=700)
    assert torch.equal(off_a, off_b) and torch.equal(st_a, st_b)
    assert st_a[:5].tolist() == [0, 0, 0, 0, 0]
    assert (st_a[5:] > 0).any()


def test_cpu_wrapper_runs_twin_and_counts_no_launch():
    fp = _plane(3000, seed=5)
    qfp, homes = _queries(fp, 500, 16, seed=6)
    before = tilejoin.launches
    t = [_plane_t(fp, 16), torch.from_numpy(qfp), torch.from_numpy(homes)]
    got = tilejoin.tilejoin_probe(*t, 16)
    assert tilejoin.launches == before
    want = tilejoin.first_event_reference(*t, 16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("bad", ["w0", "w257", "homes_i64", "fp_i32",
                                 "strided", "length"])
def test_wrapper_rejects_bad_inputs(bad):
    fp = torch.zeros(100, dtype=torch.uint16)
    q = torch.zeros(10, dtype=torch.uint16)
    h = torch.zeros(10, dtype=torch.int32)
    w = {"w0": 0, "w257": 257}.get(bad, 16)
    if bad == "homes_i64":
        h = h.to(torch.int64)
    elif bad == "fp_i32":
        fp = torch.zeros(100, dtype=torch.int32)
    elif bad == "strided":
        h = torch.zeros(20, dtype=torch.int32)[::2]
    elif bad == "length":
        q = q[:9]
    with pytest.raises(tilejoin.KernelError):
        tilejoin.tilejoin_probe(fp, q, h, w)
    assert not issubclass(tilejoin.KernelError, ValueError)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 16, 64, 256])
def test_cuda_kernel_matches_twin(cuda_device, w):
    fp = _plane(300_000, seed=w)
    qfp, homes = _queries(fp, 200_000, w, seed=w + 9)
    homes[:3] = [-5, len(fp) + w - 1, 1 << 30]  # off-plane: unresolved
    args = [_plane_t(fp, w), torch.from_numpy(qfp), torch.from_numpy(homes)]
    want = tilejoin.first_event_reference(*args, w)
    before = tilejoin.launches
    got = tilejoin.tilejoin_probe(*[a.to(cuda_device) for a in args], w)
    torch.cuda.synchronize()
    assert tilejoin.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_cuda_streaming_lookup_matches_cpu(cuda_device):
    """The sparse lookup's streaming front end on the card (worker threads,
    the lookup's own stream) gives the CPU twin's hits."""
    from kmergutsjava_tpu_torch.constants import MAX_ENCODED
    from kmergutsjava_tpu_torch.formats.kmer_table import build_table
    from kmergutsjava_tpu_torch.lookup.sparse import (SparseLookup,
                                                      StreamingLookup)

    rng = np.random.default_rng(21)
    kmers = rng.choice(MAX_ENCODED, 300_000, replace=False).astype(np.int64)
    n = len(kmers)
    table = build_table(kmers, rng.integers(0, 20, n).astype(np.int32),
                        rng.integers(0, 500, n).astype(np.int32),
                        rng.integers(0, 97, n).astype(np.int32),
                        rng.random(n).astype(np.float32), load_factor=0.7)
    values = np.concatenate([rng.choice(kmers, 200_000),
                             rng.integers(0, MAX_ENCODED, 200_000)])
    pos = np.arange(len(values), dtype=np.int64)
    hits = {}
    for dev in ("cpu", str(cuda_device)):
        st = StreamingLookup(SparseLookup(table, chunk=1 << 15, device=dev),
                             compute_kmers_found=True)
        for s in range(0, len(values), 50_000):
            st.add_batch(values[s:s + 50_000], s // 50_000, pos[s:s + 50_000])
        hits[dev] = st.finish()
    a, b = hits["cpu"], hits[str(cuda_device)]
    assert len(a) > 0 and a.kmers_found == b.kmers_found
    for col in ("cnt_id", "pos", "otu", "avg_from_end", "fi", "wt"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))
