"""The PyTorch package's kernel wrappers and their plain twins (the
tile-join probe B1, kmergutsjava_tpu_torch/lookup/tilejoin.py; the stream
probe B2 and its repetition launch B5, lookup/stream.py; the merge-join
block probe B3, lookup/blockprobe.py; the lane-gather probe B4,
lookup/tjgather.py), without JAX, so the file also runs on a GPU machine
that has no JAX: there, from the repository root,

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

runs the ``cuda`` tests too, which compare each CUDA kernel with its twin on
the card (exact: the codes are integers). Elsewhere they skip."""
import numpy as np
import pytest
import torch

from kmergutsjava_tpu_torch.lookup import (blockprobe, stream, tilejoin,
                                           tjgather)

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


def _stream_inputs(n_slots, w, channels, seed):
    """A plane of ``n_slots`` (+ w FP_EMPTY slots) at load ~0.65 and tiles
    ``[channels, n_slots]``: half the cells hold the fingerprint found a
    random offset into their window, a fifth the unused-cell 0, the rest a
    random one."""
    rng = np.random.default_rng(seed)
    fp = np.concatenate([_plane(n_slots, seed),
                         np.full(w, FP_EMPTY, np.uint16)])
    tiles = rng.integers(0, 60000, (channels, n_slots)).astype(np.uint16)
    at = np.arange(n_slots) + rng.integers(0, w, (channels, n_slots))
    planted = rng.random((channels, n_slots)) < 0.5
    tiles[planted] = fp[at[planted]]
    tiles[rng.random((channels, n_slots)) < 0.2] = 0
    return torch.from_numpy(fp), torch.from_numpy(tiles)


def _unpack(out, channels):
    """Packed int32 [C/4, S] -> per-channel offsets [C, S]."""
    o = out.numpy().view(np.uint8).reshape(channels // 4, -1, 4)
    return o.transpose(0, 2, 1).reshape(channels, -1)


def test_stream_twin_chunking_and_contract():
    """Slot chunks change nothing, and every cell holds the first offset of
    its fingerprint in the window, or w."""
    w, c = 24, 8
    fp, tiles = _stream_inputs(3001, w, c, seed=31)
    a = stream.stream_probe_reference(fp, tiles, w, c)
    b = stream.stream_probe_reference(fp, tiles, w, c, chunk=700)
    assert torch.equal(a, b)
    off = _unpack(a, c)
    f, t = fp.numpy(), tiles.numpy()
    for ch, s in [(0, 0), (3, 1500), (7, 3000), (5, 2999)]:
        hits = np.nonzero(f[s:s + w] == t[ch, s])[0]
        assert off[ch, s] == (hits[0] if len(hits) else w)
    assert (off < w).mean() > 0.4 and (off == w).any()


def test_stream_cpu_wrapper_runs_twin_and_counts_no_launch():
    fp, tiles = _stream_inputs(2000, 16, 4, seed=32)
    before = stream.launches
    got = stream.stream_probe(fp, tiles, 16, 4)
    assert stream.launches == before
    assert torch.equal(got, stream.stream_probe_reference(fp, tiles, 16, 4))


@pytest.mark.parametrize("bad", ["w0", "w65", "c6", "c_mismatch", "short",
                                 "tiles_i32", "strided"])
def test_stream_wrapper_rejects_bad_inputs(bad):
    fp = torch.zeros(140, dtype=torch.uint16)
    tiles = torch.zeros((4, 100), dtype=torch.uint16)
    w = {"w0": 0, "w65": 65}.get(bad, 16)
    c = {"c6": 6, "c_mismatch": 8}.get(bad, 4)
    if bad == "short":
        fp = fp[:115]
    elif bad == "tiles_i32":
        tiles = tiles.to(torch.int32)
    elif bad == "strided":
        tiles = torch.zeros((4, 200), dtype=torch.uint16)[:, ::2]
    with pytest.raises(tilejoin.KernelError):
        stream.stream_probe(fp, tiles, w, c)


@pytest.mark.cuda
@pytest.mark.parametrize("w,channels", [(8, 4), (24, 4), (64, 4), (24, 8),
                                        (64, 8)])
def test_cuda_stream_kernel_matches_twin(cuda_device, w, channels):
    """B2 against its twin on the card, every int32 equal; the slot count is
    not a multiple of the kernel's block, so the ragged tail is covered."""
    fp, tiles = _stream_inputs(300_001, w, channels, seed=w + channels)
    want = stream.stream_probe_reference(fp, tiles, w, channels)
    before = stream.launches
    got = stream.stream_probe(fp.to(cuda_device), tiles.to(cuda_device), w,
                              channels)
    torch.cuda.synchronize()
    assert stream.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_streaming_stream_lookup_matches_cpu(cuda_device):
    """The stream lookup's front end on the card (scatter worker, several
    plane passes on the lookup's own stream) gives the CPU twin's hits."""
    from kmergutsjava_tpu_torch.constants import MAX_ENCODED
    from kmergutsjava_tpu_torch.formats.kmer_table import build_table
    from kmergutsjava_tpu_torch.lookup.stream import (StreamingStreamLookup,
                                                      StreamLookup)

    rng = np.random.default_rng(22)
    kmers = rng.choice(MAX_ENCODED, 300_000, replace=False).astype(np.int64)
    n = len(kmers)
    table = build_table(kmers, rng.integers(0, 20, n).astype(np.int32),
                        rng.integers(0, 500, n).astype(np.int32),
                        rng.integers(0, 97, n).astype(np.int32),
                        rng.random(n).astype(np.float32), load_factor=0.6)
    values = np.concatenate([rng.choice(kmers, 300_000),
                             rng.integers(0, MAX_ENCODED, 100_000)])
    pos = np.arange(len(values), dtype=np.int64)
    hits, passes = {}, {}
    for dev in ("cpu", str(cuda_device)):
        st = StreamingStreamLookup(StreamLookup(table, device=dev),
                                   compute_kmers_found=True,
                                   flush_limit=150_000)
        for s in range(0, len(values), 50_000):
            st.add_batch(values[s:s + 50_000], s // 50_000, pos[s:s + 50_000])
        hits[dev] = st.finish()
        passes[dev] = st.passes
    a, b = hits["cpu"], hits[str(cuda_device)]
    assert passes["cpu"] == passes[str(cuda_device)] == 3
    assert len(a) > 0 and a.kmers_found == b.kmers_found
    for col in ("cnt_id", "pos", "otu", "avg_from_end", "fi", "wt"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))


@pytest.mark.parametrize("reps", [1, 3])
def test_stream_reps_cpu_runs_twin_and_counts_no_launch(reps):
    fp, tiles = _stream_inputs(2000, 24, 4, seed=33)
    before = (stream.launches, stream.reps_launches)
    got = stream.stream_probe_reps(fp, tiles, 24, 4, reps)
    assert (stream.launches, stream.reps_launches) == before
    assert torch.equal(got, stream.stream_probe_reference(fp, tiles, 24, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("w,reps", [(16, 1), (24, 4), (64, 3)])
def test_cuda_stream_reps_matches_twin(cuda_device, w, reps):
    """B5: one launch of ``reps`` plane passes gives the twin's output,
    counted in ``reps_launches`` and not in ``launches``."""
    fp, tiles = _stream_inputs(300_001, w, 4, seed=w + reps)
    want = stream.stream_probe_reference(fp, tiles, w, 4)
    before = (stream.launches, stream.reps_launches)
    got = stream.stream_probe_reps(fp.to(cuda_device), tiles.to(cuda_device),
                                   w, 4, reps)
    torch.cuda.synchronize()
    assert (stream.launches, stream.reps_launches) == (before[0],
                                                       before[1] + 1)
    assert torch.equal(got.cpu(), want)


BLOCK = blockprobe.BLOCK


def _block_inputs(nblocks, n, w, seed):
    """A plane of ``nblocks`` blocks + halo (empties except in its last
    fifth, so full windows occur) and ``n`` queries homed in the blocks,
    half planted, sorted by home as BlockProbeLookup sorts them: (fp,
    q_sorted, h_sorted, starts, order) tensors."""
    fp = _plane(nblocks * BLOCK + blockprobe.HALO, seed)
    qfp, homes = _queries(fp[:nblocks * BLOCK], n, w, seed + 1)
    homes[:4] = nblocks * BLOCK - 1 - np.arange(4)  # the last block's end
    return (torch.from_numpy(fp),
            *blockprobe.sorted_args(torch.from_numpy(qfp),
                                    torch.from_numpy(homes), nblocks))


def test_block_probe_cpu_wrapper_runs_twin_and_counts_no_launch():
    args = _block_inputs(3, 2000, 16, seed=40)
    before = blockprobe.launches
    off, state = blockprobe.block_probe(*args, 16)
    assert blockprobe.launches == before
    want = blockprobe.block_probe_reference(*args, 16)
    assert torch.equal(off, want[0]) and torch.equal(state, want[1])
    assert set(state.tolist()) == {0, 1, 2, 3}


def test_block_probe_twin_contract():
    """Each answer, at its query's input position, is the window's first
    candidate offset (even after an empty slot) and has_cand +
    2 * empty_any, with has_cand a candidate before the first empty."""
    fp, q, h, starts, order = _block_inputs(2, 1500, 32, seed=41)
    off, state = blockprobe.block_probe_reference(fp, q, h, starts, order, 32)
    f = fp.numpy()
    for i in range(0, 1500, 7):
        win = f[int(h[i]):int(h[i]) + 32]
        cand = np.nonzero(win == int(q[i]))[0]
        emp = np.nonzero(win == FP_EMPTY)[0]
        fc = cand[0] if len(cand) else None
        fe = emp[0] if len(emp) else None
        has = fc is not None and (fe is None or fc < fe)
        at = int(order[i])
        assert int(off[at]) == (fc if fc is not None else 0)
        assert int(state[at]) == int(has) + 2 * (fe is not None)


@pytest.mark.parametrize("bad", ["w0", "w129", "homes_i64", "order_i32",
                                 "short_plane", "length"])
def test_block_probe_wrapper_rejects_bad_inputs(bad):
    fp = torch.zeros(2 * BLOCK + 128, dtype=torch.uint16)
    q = torch.zeros(10, dtype=torch.uint16)
    h = torch.zeros(10, dtype=torch.int32)
    starts = torch.tensor([0, 10, 10], dtype=torch.int64)
    order = torch.arange(10)
    w = {"w0": 0, "w129": 129}.get(bad, 16)
    if bad == "homes_i64":
        h = h.to(torch.int64)
    elif bad == "order_i32":
        order = order.to(torch.int32)
    elif bad == "short_plane":
        fp = fp[:2 * BLOCK + 127]
    elif bad == "length":
        order = order[:9]
    with pytest.raises(tilejoin.KernelError):
        blockprobe.block_probe(fp, q, h, starts, order, w)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 16, 128])
def test_cuda_block_probe_matches_twin(cuda_device, w):
    """B3 against its twin on the card, every (off, state) equal, with
    homes in the last block whose windows reach into the halo."""
    args = _block_inputs(150, 300_000, w, seed=w)
    want = blockprobe.block_probe_reference(*args, w)
    before = blockprobe.launches
    got = blockprobe.block_probe(*[a.to(cuda_device) for a in args], w)
    torch.cuda.synchronize()
    assert blockprobe.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_cuda_block_probe_empty_launch(cuda_device):
    e = torch.zeros(0, dtype=torch.int64, device=cuda_device)
    before = blockprobe.launches
    off, state = blockprobe.block_probe(
        torch.zeros(BLOCK + 128, dtype=torch.uint16, device=cuda_device),
        torch.zeros(0, dtype=torch.uint16, device=cuda_device),
        torch.zeros(0, dtype=torch.int32, device=cuda_device),
        torch.zeros(2, dtype=torch.int64, device=cuda_device), e, 16)
    torch.cuda.synchronize()
    assert off.numel() == state.numel() == 0
    assert blockprobe.launches == before


@pytest.mark.cuda
def test_cuda_block_probe_lookup_matches_cpu(cuda_device):
    """BlockProbeLookup on the card (device sort, one launch, the sparse
    lookup as its exact rest) gives the CPU twin's hits in input order."""
    from kmergutsjava_tpu_torch.constants import MAX_ENCODED
    from kmergutsjava_tpu_torch.formats.kmer_table import build_table
    from kmergutsjava_tpu_torch.lookup.blockprobe import BlockProbeLookup

    rng = np.random.default_rng(23)
    kmers = rng.choice(MAX_ENCODED, 300_000, replace=False).astype(np.int64)
    n = len(kmers)
    table = build_table(kmers, rng.integers(0, 20, n).astype(np.int32),
                        rng.integers(0, 500, n).astype(np.int32),
                        rng.integers(0, 97, n).astype(np.int32),
                        rng.random(n).astype(np.float32), load_factor=0.8)
    values = np.concatenate([rng.choice(kmers, 200_000),
                             rng.integers(0, MAX_ENCODED, 200_000)])
    cnt = rng.integers(0, 9, len(values))
    pos = np.arange(len(values), dtype=np.int64)
    hits = {dev: BlockProbeLookup(table, device=dev).lookup(values, cnt, pos)
            for dev in ("cpu", str(cuda_device))}
    a, b = hits["cpu"], hits[str(cuda_device)]
    assert len(a) > 0 and a.kmers_found == b.kmers_found
    for col in ("cnt_id", "pos", "otu", "avg_from_end", "fi", "wt"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))


def _tjgather_inputs(tiles, ids, cap128, seed, w=tjgather.W):
    """Plane tiles with 30% empties and packed cells at every offset (some
    windows run past the tile's last row), half of them carrying the value
    found a random offset (< w) into their column; ids that name no tile
    keep random cells."""
    rng = np.random.default_rng(seed)
    plane3 = rng.integers(0, 60000, (tiles, 128, 128)).astype(np.uint16)
    plane3[rng.random(plane3.shape) < 0.3] = FP_EMPTY
    ids = np.asarray(ids, np.int32)
    shape = (len(ids), tjgather.TPG, cap128, 128)
    rr = rng.integers(0, 128, shape)
    off = rng.integers(0, 128, shape)
    tile = np.clip(ids, 0, tiles // tjgather.TPG - 1)[:, None, None, None] \
        * tjgather.TPG + np.arange(tjgather.TPG)[None, :, None, None]
    at = np.minimum(off + rng.integers(0, w, shape), 127)
    v = plane3[np.broadcast_to(tile, shape), at, rr].astype(np.int64)
    q = np.where(rng.random(shape) < 0.5, v, rng.integers(0, 60000, shape))
    packed = ((q << 14) | (rr << 7) | off).astype(np.int32)
    return [torch.from_numpy(a) for a in (plane3, ids, packed)]


def test_tjgather_cpu_wrapper_runs_twin_and_counts_no_launch():
    args = _tjgather_inputs(32, [3, 0, 1, 2], 2, seed=50)
    before = tjgather.launches
    key = tjgather.tjgather_probe(*args)
    assert tjgather.launches == before
    assert torch.equal(key, tjgather.tjgather_reference(*args))
    k = key.numpy()
    assert ((k < 32) & (k % 2 == 0)).any() and (k % 2 == 1).any()


def test_tjgather_twin_matches_numpy_formula():
    """key = min over rel < w with off + rel < 128 of 2 * rel where the
    column holds the query's fingerprint, 2 * rel + 1 where it holds
    FP_EMPTY, else 2 * w; tile = ids[b] * TPG + t, rr = (p >> 7) & 127,
    off = p & 127, qfp = p >> 14."""
    w = tjgather.W
    plane3, ids, packed = _tjgather_inputs(16, [1, 0], 1, seed=51)
    key = tjgather.tjgather_reference(plane3, ids, packed).numpy()
    p3, pk = plane3.numpy(), packed.numpy()
    want = np.full(pk.shape, 2 * w)
    for b, t, g, lane in np.ndindex(*pk.shape):
        p = int(pk[b, t, g, lane])
        col = p3[int(ids[b]) * tjgather.TPG + t, :, (p >> 7) & 127]
        off, qfp = p & 127, p >> 14
        for rel in range(min(w, 128 - off)):
            if col[off + rel] == qfp or col[off + rel] == FP_EMPTY:
                want[b, t, g, lane] = 2 * rel + (col[off + rel] != qfp)
                break
    np.testing.assert_array_equal(key, want)
    assert (pk & 127).max() > 128 - w


@pytest.mark.parametrize("bad", ["plane_i16", "tpg", "tile_shape",
                                 "packed_i64", "ids_len"])
def test_tjgather_wrapper_rejects_bad_inputs(bad):
    plane3 = torch.zeros((16, 128, 128), dtype=torch.uint16)
    ids = torch.zeros(2, dtype=torch.int32)
    packed = torch.zeros((2, 8, 1, 128), dtype=torch.int32)
    if bad == "plane_i16":
        plane3 = plane3.view(torch.int16)
    elif bad == "tpg":  # 4 tiles a super-tile, not TPG
        packed = torch.zeros((2, 4, 1, 128), dtype=torch.int32)
    elif bad == "tile_shape":
        plane3 = torch.zeros((16, 128, 64), dtype=torch.uint16)
    elif bad == "packed_i64":
        packed = packed.to(torch.int64)
    elif bad == "ids_len":
        ids = ids[:1]
    with pytest.raises(tilejoin.KernelError):
        tjgather.tjgather_probe(plane3, ids, packed)


@pytest.mark.cuda
@pytest.mark.parametrize("cap128", [1, 4])
def test_cuda_tjgather_matches_twin(cuda_device, cap128):
    """B4 against its twin on the card, every key equal, in shuffled
    super-tile order with one id that names no tile."""
    rng = np.random.default_rng(cap128)
    ids = rng.permutation(256).astype(np.int32)
    ids[7] = 256
    args = _tjgather_inputs(2048, ids, cap128, seed=cap128 + 60)
    want = tjgather.tjgather_reference(*args)
    before = tjgather.launches
    got = tjgather.tjgather_probe(*[a.to(cuda_device) for a in args])
    torch.cuda.synchronize()
    assert tjgather.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert (want[7] == 32).all()


@pytest.mark.cuda
def test_cuda_tjgather_empty_launch(cuda_device):
    before = tjgather.launches
    key = tjgather.tjgather_probe(
        torch.zeros((8, 128, 128), dtype=torch.uint16, device=cuda_device),
        torch.zeros(0, dtype=torch.int32, device=cuda_device),
        torch.zeros((0, 8, 1, 128), dtype=torch.int32, device=cuda_device))
    torch.cuda.synchronize()
    assert key.shape == (0, 8, 1, 128) and tjgather.launches == before
