"""The PyTorch package's kernel wrappers and their plain twins (the
tile-join probe B1, kmergutsjava_tpu_torch/lookup/tilejoin.py; the stream
probe B2 and its repetition launch B5, lookup/stream.py; the block
probe B3, lookup/blockprobe.py; the lane-gather probe B4,
lookup/tjgather.py; the shard probe B12, parallel/shard_probe.py; the
routing bins B13, parallel/route_bins.py; the grouping kernel B11,
calls/scan_machine.py; the k-mer window kernel, ops/kmer_windows.py; the
fused step's kernel, parallel/fused_probe.py), without JAX, so the file also runs on a GPU machine
that has no JAX: there, from the repository root,

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

runs the ``cuda`` tests too, which compare each CUDA kernel with its twin on
the card (exact: the codes are integers), and ``test_cuda_soak_round``
holds every port run of tests/torch_soak_rounds.py's randomized rounds on
the card to the port's parity engine on the CPU (``-k soak``; its 400
slow seeds only with ``-m slow``). Elsewhere they skip."""
import glob
import os

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


def test_newer_header_rebuilds_a_kernel_library(tmp_path, monkeypatch):
    """build_cuda_library rebuilds a library that is older than its source
    or than a header the sources include (tilejoin.HEADERS: every .cuh in
    csrc/), and only then."""
    from kmergutsjava_tpu_torch.utils import native

    csrc = os.path.dirname(tilejoin.SOURCE)
    assert sorted(tilejoin.HEADERS) == sorted(
        glob.glob(os.path.join(csrc, "*.cuh")))
    src, hdr = tmp_path / "k.cu", tmp_path / "probe_common.cuh"
    src.write_text("// kernel")
    hdr.write_text("// header")
    so = tmp_path / "build" / "libk.so"
    so.parent.mkdir()
    so.write_text("a stand-in, not a library")
    os.utime(src, (100, 100))
    os.utime(hdr, (150, 150))
    os.utime(so, (200, 200))
    built = []
    monkeypatch.setattr(tilejoin, "HEADERS", (str(hdr),))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "compile_to",
                        lambda cmd, out: built.append((cmd[-1], out)))
    with pytest.raises(tilejoin.KernelError, match="cannot build or load"):
        tilejoin.build_cuda_library(str(src))
    assert built == []  # up to date: loaded as it is
    os.utime(hdr, (300, 300))
    with pytest.raises(tilejoin.KernelError):
        tilejoin.build_cuda_library(str(src))
    assert built == [("-o", str(so))]


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


def test_wrapper_answers_are_views_of_one_buffer():
    """off and state are views of one answer buffer (probe_answer's: off
    first, state at the next 16-byte boundary), and hold the twin's
    answers."""
    fp = _plane(3000, seed=7)
    for n in (0, 1, 17, 500):
        qfp, homes = _queries(fp, n, 16, seed=n)
        args = (_plane_t(fp, 16), torch.from_numpy(qfp),
                torch.from_numpy(homes), 16)
        buf = tilejoin.probe_answer(*args)
        at = -(-n // 16) * 16
        assert buf.dtype == torch.uint8 and buf.numel() == at + n
        off, state = tilejoin.tilejoin_probe(*args)
        assert off._base is not None and off._base is state._base
        assert off._base.numel() == at + n
        if n:
            assert state.data_ptr() == off.data_ptr() + at
        want = tilejoin.first_event_reference(*args)
        for got in (tilejoin.answer_views(buf.numpy(), n), (off, state)):
            np.testing.assert_array_equal(got[0], want[0].numpy())
            np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 7, 9, 16, 17, 64, 256])
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


B1_QUERIES = 4  # queries a thread of csrc/tilejoin.cu


def _b1_edge(case, n=40_000):
    """B1's operands at its edges: (plane without padding, q_fp, homes, w,
    lead), ``lead`` the slots by which the test places the plane past a
    16-byte boundary on the card.

    lead1/lead3/lead7: the plane 1, 3 or 7 slots past a boundary (its
    first and last vectors read slot by slot); n_mod1/2/3: a query count
    1, 2 or 3 past a multiple of the queries a thread (a ragged last
    thread); vec2/vec3: disjoint windows whose first event (a candidate or
    an empty, half each) lies in the window's second or third 16-byte
    vector; off_plane: homes whose window runs off the plane (below 0, past
    its end, up to the largest int32, where home + w overflows 32 bits);
    full: a plane without empties, so most windows hold no event."""
    w, lead = 16, 0
    if case.startswith("vec"):
        w = 32
        rng = np.random.default_rng(len(case) + int(case[-1]))
        homes = (np.arange(n, dtype=np.int64) * 64
                 + rng.integers(0, 32, n)).astype(np.int32)
        fp = rng.integers(0, 60000, n * 64 + 64).astype(np.uint16)
        qfp = rng.integers(0, 60000, n).astype(np.uint16)
        # the window offset of the vector's first slot: 8 - (home % 8) for
        # the second vector, 16 - (home % 8) for the third
        first = 8 * (int(case[-1]) - 1) - homes % 8
        at = homes + first + rng.integers(0, 8, n)
        for i in range(n):  # no earlier event in the window
            win = fp[homes[i]:at[i]]
            win[(win == qfp[i]) | (win == FP_EMPTY)] = 1 + qfp[i] % 7
        fp[at] = np.where(rng.random(n) < 0.5, qfp, FP_EMPTY)
        return fp, qfp, homes, w, lead
    fp = _plane(300_000, seed=len(case),
                empty_frac=0.0 if case == "full" else 0.35)
    if case.startswith("n_mod"):
        n = n - n % B1_QUERIES + int(case[-1])
    qfp, homes = _queries(fp, n, w, seed=len(case) + 1)
    if case.startswith("lead"):
        lead = int(case[-1])
    if case == "off_plane":
        homes[:9] = [-1, -5, len(fp) + 1, len(fp) + w + 1, len(fp) + 2 * w,
                     1 << 30, 2**31 - 1 - w, 2**31 - 2, 2**31 - 1]
    return fp, qfp, homes, w, lead


B1_EDGES = ["lead1", "lead3", "lead7", "n_mod1", "n_mod2", "n_mod3", "vec2",
            "vec3", "off_plane", "full"]


@pytest.mark.parametrize("case", B1_EDGES)
def test_b1_edge_operands(case):
    """Each edge case holds what its name says, on the twin."""
    fp, qfp, homes, w, lead = _b1_edge(case)
    off, state = tilejoin.first_event_reference(
        _plane_t(fp, w), torch.from_numpy(qfp), torch.from_numpy(homes), w)
    st = state.numpy()
    if case.startswith("vec"):
        lo = 8 * (int(case[-1]) - 1)
        first = np.where(st == 1, off.numpy(), -1)
        assert (st > 0).all() and set(np.unique(st)) == {1, 2}
        hit = st == 1
        assert ((first[hit] + homes[hit] % 8 >= lo)
                & (first[hit] + homes[hit] % 8 < lo + 8)).all()
    elif case == "off_plane":
        assert (st[:9] == 0).all() and (st[9:] > 0).any()
    elif case == "full":
        assert (st == 0).mean() > 0.4
    else:
        assert set(np.unique(st)) == {0, 1, 2}
    if case.startswith("n_mod"):
        assert len(homes) % B1_QUERIES == int(case[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", B1_EDGES)
def test_cuda_kernel_edges_match_twin(cuda_device, case):
    """B1 against its twin on the card at each edge case, every (off,
    state) equal."""
    fp, qfp, homes, w, lead = _b1_edge(case)
    args = [_plane_t(fp, w), torch.from_numpy(qfp), torch.from_numpy(homes)]
    want = tilejoin.first_event_reference(*args, w)
    plane = _offset_view(args[0], lead, cuda_device)
    assert plane.data_ptr() % 16 == 2 * lead
    before = tilejoin.launches
    got = tilejoin.tilejoin_probe(plane, *[a.to(cuda_device)
                                           for a in args[1:]], w)
    torch.cuda.synchronize()
    assert tilejoin.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_cuda_kernel_unaligned_views_and_empty_launch(cuda_device):
    """Fingerprints and homes as views one element past their allocation
    (the kernel's scalar path), and a launch of no queries."""
    fp = _plane(100_000, seed=70)
    qfp, homes = _queries(fp, 50_001, 16, seed=71)
    args = [_plane_t(fp, 16), torch.from_numpy(qfp), torch.from_numpy(homes)]
    want = tilejoin.first_event_reference(*args, 16)
    got = tilejoin.tilejoin_probe(args[0].to(cuda_device),
                                  _offset_view(args[1], 1, cuda_device),
                                  _offset_view(args[2], 1, cuda_device), 16)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    before = tilejoin.launches
    off, state = tilejoin.tilejoin_probe(
        args[0].to(cuda_device),
        torch.zeros(0, dtype=torch.uint16, device=cuda_device),
        torch.zeros(0, dtype=torch.int32, device=cuda_device), 16)
    torch.cuda.synchronize()
    assert off.numel() == state.numel() == 0
    assert tilejoin.launches == before


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


TILE_CASES = ("duplicates", "crowded", "collisions", "last_window")


def _tile_case(case, seed):
    """A table at load 0.8 and one pass's queries in three chunks, for the
    stream lookup's device scatter and resolve: ``duplicates`` (values
    repeated four times across the chunks, as read coverage does),
    ``crowded`` (homes with more distinct values than channels),
    ``collisions`` (distinct values of equal home and fingerprint) and
    ``last_window`` (homes in the table's last window); each with random
    values besides."""
    from kmergutsjava_tpu_torch.constants import MAX_ENCODED
    from kmergutsjava_tpu_torch.formats.kmer_table import build_table

    rng = np.random.default_rng(seed)
    kmers = rng.choice(MAX_ENCODED, 20_000, replace=False).astype(np.int64)
    n = len(kmers)
    table = build_table(kmers, rng.integers(0, 20, n).astype(np.int32),
                        rng.integers(0, 500, n).astype(np.int32),
                        rng.integers(0, 97, n).astype(np.int32),
                        rng.random(n).astype(np.float32), load_factor=0.8)
    ns = np.int64(table.num_sigs)
    rand = rng.integers(0, MAX_ENCODED, 5000)
    if case == "duplicates":
        values = np.repeat(np.concatenate([rng.choice(kmers, 6000), rand]),
                           4)
    elif case == "crowded":
        base = rng.choice(kmers, 300)
        values = np.repeat(np.concatenate(
            [(base[:, None] + ns * np.arange(9)).reshape(-1), rand]), 2)
    elif case == "collisions":
        base = rng.choice(kmers, 3000)
        values = np.concatenate([base, base + ns * 65535,
                                 base + 2 * ns * 65535, rand])
    else:
        tail = kmers[kmers % ns >= ns - 64]
        near = ns - 1 - rng.integers(0, 64, 3000)
        values = np.concatenate([np.repeat(tail, 3),
                                 near + ns * rng.integers(0, 1000, 3000),
                                 rand])
    rng.shuffle(values)
    return table, np.array_split(values.astype(np.int64), 3)


def _check_tile_split(values, tiles, occ, res, num_sigs):
    """A device scatter's outputs are a valid split: a placed query's cell
    holds its fingerprint below its home's count; an overflowed query's
    home has all C channels, none holding its fingerprint; a home's taken
    channels hold distinct fingerprints; cells past the count stay 0."""
    tiles, occ, res = (np.asarray(t) for t in (tiles, occ, res))
    channels = tiles.shape[0]
    homes = values % num_sigs
    fps = (values % 65535).astype(np.uint16)
    ok = res >= 0
    assert occ.max() <= channels and (res < channels).all()
    assert (res[ok] < occ[homes[ok]]).all()
    np.testing.assert_array_equal(tiles[res[ok], homes[ok]], fps[ok])
    assert (occ[homes[~ok]] == channels).all()
    assert not (tiles[:, homes[~ok]] == fps[~ok]).any()
    taken = np.arange(channels)[:, None] < occ[None, :]
    assert not tiles[~taken].any()
    held = np.sort(np.where(taken, tiles.astype(np.int64),
                            -1 - np.arange(channels)[:, None]), axis=0)
    assert not ((held[1:] == held[:-1]) & (held[1:] >= 0)).any()


def _tile_pass(lk, chunks):
    """One pass of ``chunks`` through the lookup's device stages, on its
    device: (the channels the scatter gave, the set's tiles and occupancy
    after it, the probe's answers, the resolved slots, the counts), all on
    the host."""
    from kmergutsjava_tpu_torch.lookup.sparse import on_stream
    from kmergutsjava_tpu_torch.lookup.stream_tiles import (resolve_tiles,
                                                            scatter_tiles)

    s = lk._sets.take()
    dev = lk.device
    parts = []
    with on_stream(lk._stream):
        for c in chunks:
            v = torch.from_numpy(c).to(dev)
            r = torch.empty(len(c), dtype=torch.int32, device=dev)
            scatter_tiles(v, s.tiles, s.occ, r, lk.num_sigs)
            parts.append((v, r))
        chans = torch.cat([r for _, r in parts]).cpu()
        answers = lk._probe(s)
        for v, r in parts:
            resolve_tiles(v, r, answers, lk.fe, lk.hk, lk.num_sigs, lk.w,
                          lk._exact.full_window, s.counts)
        got = (chans, *(t.to("cpu", copy=True) for t in (
            s.tiles, s.occ, answers, torch.cat([r for _, r in parts]),
            s.counts)))
        s.zero()
    lk._sets.give_back(s)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", TILE_CASES)
def test_cuda_stream_tiles_match_twin(cuda_device, case):
    """The device scatter and resolve kernels on the card: the scatter's
    split is valid and the resolved slots are the twins' (any valid split
    resolves every query to the same slot); the resolve kernel on the
    kernel's own channels and answers gives the twin's slots and counts
    bit for bit; one launch of each a chunk."""
    from kmergutsjava_tpu_torch.lookup import stream_tiles
    from kmergutsjava_tpu_torch.lookup.stream import StreamLookup

    table, chunks = _tile_case(case, seed=TILE_CASES.index(case) + 90)
    values = np.concatenate(chunks)
    before = (stream_tiles.scatter_launches, stream_tiles.resolve_launches)
    gpu = _tile_pass(StreamLookup(table, device=str(cuda_device)), chunks)
    assert (stream_tiles.scatter_launches - before[0],
            stream_tiles.resolve_launches - before[1]) == (3, 3)
    cpu_lk = StreamLookup(table, device="cpu")
    twin = _tile_pass(cpu_lk, chunks)
    chans, tiles, occ, answers, slots, counts = gpu
    _check_tile_split(values, tiles, occ, chans, table.num_sigs)
    np.testing.assert_array_equal(slots.numpy(), twin[4].numpy())
    assert counts[2] == twin[5][2] == int((slots >= 0).sum()) > 0
    np.testing.assert_array_equal(
        answers.numpy(), stream.stream_probe_reference(
            cpu_lk.fp, tiles, cpu_lk.w, cpu_lk.channels).numpy())
    res = chans.clone()
    again = torch.zeros(3, dtype=torch.int64)
    stream_tiles.resolve_tiles(torch.from_numpy(values), res, answers,
                               cpu_lk.fe, cpu_lk.hk, table.num_sigs,
                               cpu_lk.w, cpu_lk._exact.full_window, again)
    np.testing.assert_array_equal(res.numpy(), slots.numpy())
    np.testing.assert_array_equal(again.numpy(), counts.numpy())
    if case == "crowded":
        assert counts[0] > 0
    if case == "collisions":
        assert counts[1] > counts[0]


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


SPAN = 1024  # slots a CTA of the stream kernel owns (csrc/stream_probe.cu)


def _stream_adversarial(case):
    """Operands at the stream kernel's edges: (fp, tiles, w, channels).

    ragged: a slot count that is neither a multiple of the span nor of 4
    (the scalar path); span_edge: matches at offset w - 1 whose windows
    cross into the next span; zero_and_empty: fingerprints 0 and 65535 in
    both the plane and the tiles; all_channels: slots whose four channels
    all match; all_scan: a plane that holds 0 in every span, so every
    unused cell is a scan; unaligned: the plane as a view that is not
    16-byte aligned (the scalar path)."""
    rng = np.random.default_rng(len(case))
    w, c, n = 64, 4, 2 * SPAN + 100
    if case == "ragged":
        w, c, n = 24, 8, 3 * SPAN + 3
    fp = rng.integers(0, 65536, n + w).astype(np.uint16)
    fp[rng.random(n + w) < 0.35] = FP_EMPTY
    fp[n:] = FP_EMPTY
    tiles = rng.integers(0, 65536, (c, n)).astype(np.uint16)
    tiles[rng.random((c, n)) < 0.5] = 0
    at = np.arange(n) + rng.integers(0, w, (c, n))
    planted = rng.random((c, n)) < 0.3
    tiles[planted] = fp[at[planted]]
    if case == "span_edge":
        for s in (SPAN - 1, SPAN - w // 2, 2 * SPAN - 1):
            v = 40000 + s
            fp[s:s + w][fp[s:s + w] == v] = 1
            fp[s + w - 1] = v
            tiles[:, s] = v
    elif case == "zero_and_empty":
        fp[rng.random(n + w) < 0.05] = 0
        tiles[rng.random((c, n)) < 0.1] = FP_EMPTY
    elif case == "all_channels":
        for s in range(0, n, 7):
            tiles[:, s] = fp[s + np.arange(c) * (w // c)]
    elif case == "all_scan":
        fp[::SPAN // 2] = 0
        tiles[:] = 0
        tiles[:, ::5] = fp[np.arange(0, n, 5)]
    fp_t = torch.from_numpy(fp)
    if case == "unaligned":
        fp_t = torch.cat([torch.zeros(1, dtype=torch.uint16), fp_t])[1:]
    return fp_t, torch.from_numpy(tiles), w, c


STREAM_CASES = ["ragged", "span_edge", "zero_and_empty", "all_channels",
                "all_scan", "unaligned"]


@pytest.mark.parametrize("case", STREAM_CASES)
def test_stream_twin_on_adversarial_operands(case):
    """The twin gives, on each edge case, the first offset of every cell's
    fingerprint in its window, or w (a brute-force numpy scan)."""
    fp, tiles, w, c = _stream_adversarial(case)
    got = _unpack(stream.stream_probe_reference(fp, tiles, w, c), c)
    f, t = fp.numpy(), tiles.numpy()
    n = t.shape[1]
    want = np.full(t.shape, w)
    for l in reversed(range(w)):
        want = np.where(f[l:l + n][None, :] == t, l, want)
    np.testing.assert_array_equal(got, want)
    if case == "span_edge":
        assert (got[:, SPAN - 1] == w - 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [4, 8])
@pytest.mark.parametrize("w", [1, 8, 16, 24, 63, 64])
def test_cuda_stream_kernel_matches_twin(cuda_device, w, channels):
    """B2 against its twin on the card, every int32 equal; the slot count is
    not a multiple of the kernel's span, so the ragged tail is covered."""
    fp, tiles = _stream_inputs(300_001, w, channels, seed=w + channels)
    want = stream.stream_probe_reference(fp, tiles, w, channels)
    before = stream.launches
    got = stream.stream_probe(fp.to(cuda_device), tiles.to(cuda_device), w,
                              channels)
    torch.cuda.synchronize()
    assert stream.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", STREAM_CASES)
def test_cuda_stream_kernel_adversarial(cuda_device, case):
    """B2 against its twin on the card on each edge case, every int32
    equal."""
    fp, tiles, w, c = _stream_adversarial(case)
    want = stream.stream_probe_reference(fp, tiles, w, c)
    fp_d = torch.empty(fp.numel() + 1, dtype=torch.uint16,
                       device=cuda_device)
    if case == "unaligned":  # keep the view's misalignment on the card
        fp_d[1:] = fp.to(cuda_device)
        fp_d = fp_d[1:]
    else:
        fp_d = fp.to(cuda_device)
    got = stream.stream_probe(fp_d, tiles.to(cuda_device), w, c)
    torch.cuda.synchronize()
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
    from kmergutsjava_tpu_torch.lookup import stream_tiles
    from kmergutsjava_tpu_torch.utils import timing

    hits, passes, counters = {}, {}, {}
    launches = (stream_tiles.scatter_launches, stream_tiles.resolve_launches)
    for dev in ("cpu", str(cuda_device)):
        with timing.record("t.root"):
            st = StreamingStreamLookup(StreamLookup(table, device=dev),
                                       compute_kmers_found=True,
                                       flush_limit=150_000)
            for s in range(0, len(values), 50_000):
                st.add_batch(values[s:s + 50_000], s // 50_000,
                             pos[s:s + 50_000])
            hits[dev] = st.finish()
            st.close()
        passes[dev] = st.passes
        counters[dev] = timing.recent_runs()[-1]["counters"]
    a, b = hits["cpu"], hits[str(cuda_device)]
    assert passes["cpu"] == passes[str(cuda_device)] == 3
    assert len(a) > 0 and a.kmers_found == b.kmers_found
    for col in ("cnt_id", "pos", "otu", "avg_from_end", "fi", "wt"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))
    c = counters[str(cuda_device)]
    assert c["stream.bytes_up"] == 8 * c["stream.queries"] == 8 * len(values)
    # plain host arrays are staged in page-locked memory before they go up
    assert c["stream.staged_queries"] == len(values)
    assert c["stream.passes"] == 3
    assert {"stream.overflow_queries", "stream.fallback_queries"} <= set(c)
    # a scatter launch a chunk, a resolve launch a chunk
    assert (stream_tiles.scatter_launches - launches[0],
            stream_tiles.resolve_launches - launches[1]) == (8, 8)


@pytest.mark.cuda
def test_cuda_read_set_prepare_writes_into_page_locked_columns(
        cuda_device, tmp_path, monkeypatch):
    """A read set through the engine's stream front end on the card, in
    five chunks: the prepare writes every query into the columns the front
    end lends (``prepare.direct_queries`` is ``stream.queries``), their
    values page-locked, so no query is staged before its upload
    (``stream.staged_queries`` 0). In one pass a second run lends the first
    run's columns again, allocating none; in several passes too, every
    report is ``--backend parity``'s, byte for byte."""
    import io
    from functools import partial

    from kmergutsjava_tpu_torch.config import EngineConfig
    from kmergutsjava_tpu_torch.constants import GENETIC_CODE
    from kmergutsjava_tpu_torch.formats.table_tools import (
        signatures_from_proteins, write_data_dir)
    from kmergutsjava_tpu_torch.models import pipeline, prepare
    from kmergutsjava_tpu_torch.models.pipeline import Engine
    from kmergutsjava_tpu_torch.utils import timing

    rng = np.random.default_rng(24)
    alpha = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    prots = [alpha[rng.integers(0, 20, int(n))].tobytes().decode()
             for n in rng.integers(60, 300, 300)]
    d = str(tmp_path / "d")
    write_data_dir(d, signatures_from_proteins(
        [(p, i % 7, i % 11) for i, p in enumerate(prots)]),
        [f"f{i}" for i in range(7)])
    codon = {}
    for i, a in enumerate(GENETIC_CODE.tobytes().decode()):
        codon.setdefault(a, "ACGT"[i >> 4] + "ACGT"[(i >> 2) & 3]
                         + "ACGT"[i & 3])
    genome = "".join(codon[a] for p in prots for a in p)
    starts = rng.integers(0, len(genome) - 150, 3000)
    query = tmp_path / "reads.fna"
    query.write_text("".join(f">r{i}\n{genome[a:a + 150]}\n"
                             for i, a in enumerate(starts)))
    monkeypatch.setattr(prepare, "try_prepare_bulk",
                        partial(prepare.try_prepare_bulk,
                                flush_chars=100_000))
    monkeypatch.setattr(pipeline, "_LOOKUP_CACHE", {})
    reports, counters = [], []
    # one pass twice (every chunk's columns out until finish), several
    # passes, and the parity scan
    for backend, limit in (("stream", None), ("stream", None),
                           ("stream", 250_000), ("parity", None)):
        out = io.StringIO()
        kw = {} if limit is None else {"input_size_limit": limit}
        Engine(EngineConfig(aa=False, min_hits=2, backend=backend,
                            **kw)).run(d, str(query), out, stdout=True)
        reports.append(out.getvalue())
        counters.append(timing.recent_runs()[-1]["counters"])
    assert reports[0] == reports[1] == reports[2] == reports[3]
    assert "CALL\t" in reports[0]
    for c in counters[:3]:
        assert c["prepare.direct_queries"] == c["stream.queries"] > 0
        assert c["stream.staged_queries"] == 0
    assert counters[0]["stream.passes"] == counters[1]["stream.passes"] == 1
    assert counters[2]["stream.passes"] >= 3
    assert counters[0]["stream.fresh_columns"] == 5  # a chunk each
    assert counters[1]["stream.fresh_columns"] == 0


@pytest.mark.cuda
def test_cuda_stream_pass_sets_pinned_and_exact(cuda_device):
    """On the card the stream lookup's two pass sets live in device memory
    (their staging page-locked), beside the resident empty-distance plane
    and k-mer column; the device scatter of a batch is a valid split and a
    pass over its tiles gives the twin's answers; and a two-pass front end
    (the tail pass at finish) gives the one-shot lookup's hits, 8 B a query
    up, with both sets back and zero after it."""
    from kmergutsjava_tpu_torch.constants import MAX_ENCODED
    from kmergutsjava_tpu_torch.formats.kmer_table import build_table
    from kmergutsjava_tpu_torch.lookup.stream import (StreamingStreamLookup,
                                                      StreamLookup)
    from kmergutsjava_tpu_torch.utils import timing

    rng = np.random.default_rng(23)
    kmers = rng.choice(MAX_ENCODED, 300_000, replace=False).astype(np.int64)
    n = len(kmers)
    table = build_table(kmers, rng.integers(0, 20, n).astype(np.int32),
                        rng.integers(0, 500, n).astype(np.int32),
                        rng.integers(0, 97, n).astype(np.int32),
                        rng.random(n).astype(np.float32), load_factor=0.6)
    values = np.concatenate([rng.choice(kmers, 300_000),
                             rng.integers(0, MAX_ENCODED, 100_000)])
    cnt = np.repeat(np.arange(8, dtype=np.int64), 50_000)
    pos = np.arange(len(values), dtype=np.int64)
    lk = StreamLookup(table, device=str(cuda_device))
    for s in lk._sets.sets:
        for t in (s.tiles, s.occ, s.answers, s.counts):
            assert t.device.type == "cuda"
    assert lk.fe.device.type == lk.hk.device.type == "cuda"
    s = lk._sets.take()
    dv, res = lk._scatter_into(s, values)
    lk._stream.synchronize()
    tiles = s.tiles.cpu()
    with torch.cuda.stream(lk._stream):
        got = lk._probe(s).cpu()
    want = stream.stream_probe_reference(lk.fp.cpu(), tiles, lk.w,
                                         lk.channels)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    _check_tile_split(values, tiles, s.occ.cpu(), res.cpu(), lk.num_sigs)
    s.zero()
    lk._sets.give_back(s)
    one = lk.lookup(values, cnt, pos)
    with timing.record("t.root"):
        st = StreamingStreamLookup(lk, compute_kmers_found=True,
                                   flush_limit=200_000)
        for a in range(0, len(values), 60_000):
            st.add_batch(values[a:a + 60_000], cnt[a:a + 60_000],
                         pos[a:a + 60_000])
        two = st.finish()
        st.close()
    counters = timing.recent_runs()[-1]["counters"]
    assert st.passes == counters["stream.passes"] == 2
    assert counters["stream.fresh_sets"] == 0
    # only the values cross the link up: no tile
    assert counters["stream.bytes_up"] == 8 * len(values)
    assert {"stream.overflow_queries", "stream.fallback_queries"} <= set(
        counters)
    assert len(one) > 0 and one.kmers_found == two.kmers_found
    order = [np.lexsort((h.pos, h.cnt_id)) for h in (one, two)]
    for col in ("cnt_id", "pos", "otu", "avg_from_end", "fi", "wt"):
        np.testing.assert_array_equal(getattr(one, col)[order[0]],
                                      getattr(two, col)[order[1]])
    torch.cuda.synchronize()
    for s in lk._sets.sets:
        assert not s.tiles.view(torch.int16).any() and not s.occ.any()


@pytest.mark.parametrize("reps", [1, 3])
def test_stream_reps_cpu_runs_twin_and_counts_no_launch(reps):
    fp, tiles = _stream_inputs(2000, 24, 4, seed=33)
    before = (stream.launches, stream.reps_launches)
    got = stream.stream_probe_reps(fp, tiles, 24, 4, reps)
    assert (stream.launches, stream.reps_launches) == before
    assert torch.equal(got, stream.stream_probe_reference(fp, tiles, 24, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("w,reps", [(16, 1), (24, 4), (64, 3), (64, 1)])
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


def _block_inputs(n_slots, n, w, seed, order="random"):
    """A plane of ``n_slots`` + HALO slots (empties except in its last fifth,
    so full windows occur) and ``n`` queries homed in its first ``n_slots``,
    half planted, four of them in the last slots (windows reaching into the
    padding); in random order, or sorted by home (``order="home"``) as the
    bounded-RAM store feeds them: (fp, q_fp, homes) tensors."""
    fp = _plane(n_slots + blockprobe.HALO, seed)
    qfp, homes = _queries(fp[:n_slots], n, w, seed + 1)
    homes[:4] = n_slots - 1 - np.arange(4)
    if order == "home":
        p = np.argsort(homes, kind="stable")
        qfp, homes = qfp[p], homes[p]
    return [torch.from_numpy(a) for a in (fp, qfp, homes)]


def test_block_probe_cpu_wrapper_runs_twin_and_counts_no_launch():
    args = _block_inputs(6000, 2000, 16, seed=40)
    before = blockprobe.launches
    off, state = blockprobe.block_probe(*args, 16)
    assert blockprobe.launches == before
    want = blockprobe.block_probe_reference(*args, 16)
    assert torch.equal(off, want[0]) and torch.equal(state, want[1])
    assert set(state.tolist()) == {0, 1, 2, 3}


def test_block_probe_twin_contract():
    """Each answer, at its query's position, is the window's first
    candidate offset (even after an empty slot) and has_cand +
    2 * empty_any, with has_cand a candidate before the first empty."""
    fp, q, h = _block_inputs(4000, 1500, 32, seed=41)
    off, state = blockprobe.block_probe_reference(fp, q, h, 32)
    f = fp.numpy()
    for i in range(0, 1500, 7):
        win = f[int(h[i]):int(h[i]) + 32]
        cand = np.nonzero(win == int(q[i]))[0]
        emp = np.nonzero(win == FP_EMPTY)[0]
        fc = cand[0] if len(cand) else None
        fe = emp[0] if len(emp) else None
        has = fc is not None and (fe is None or fc < fe)
        assert int(off[i]) == (fc if fc is not None else 0)
        assert int(state[i]) == int(has) + 2 * (fe is not None)


@pytest.mark.parametrize("bad", ["w0", "w129", "homes_i64", "q_fp_i16",
                                 "strided", "length"])
def test_block_probe_wrapper_rejects_bad_inputs(bad):
    fp = torch.zeros(2000, dtype=torch.uint16)
    q = torch.zeros(10, dtype=torch.uint16)
    h = torch.zeros(10, dtype=torch.int32)
    w = {"w0": 0, "w129": 129}.get(bad, 16)
    if bad == "homes_i64":
        h = h.to(torch.int64)
    elif bad == "q_fp_i16":
        q = q.view(torch.int16)
    elif bad == "strided":
        h = torch.zeros(20, dtype=torch.int32)[::2]
    elif bad == "length":  # fingerprints and homes disagree in length
        q = q[:9]
    with pytest.raises(tilejoin.KernelError):
        blockprobe.block_probe(fp, q, h, w)


def _offset_view(t, lead, device):
    """``t`` on ``device`` as a view that starts ``lead`` elements into its
    allocation, so it is not aligned for vector loads."""
    buf = torch.empty(t.numel() + lead, dtype=t.dtype, device=device)
    buf[lead:] = t.to(device)
    return buf[lead:]


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["random", "home", "unaligned"])
@pytest.mark.parametrize("w", [8, 16, 128])
def test_cuda_block_probe_matches_twin(cuda_device, w, order):
    """B3 against its twin on the card, every (off, state) equal, with
    homes at the plane's start, homes in the last slots whose windows reach
    into the padding or end the plane, and homes whose windows run off the
    plane (one of them the largest int32, where home + w overflows 32
    bits). unaligned: random order, a query count that is not a multiple
    of 4, the plane a view a few slots past a 16-byte boundary (its first
    and last vectors are read slot by slot), and the fingerprints and homes
    views one element past theirs (the kernel's scalar path)."""
    n = 300_001 if order == "unaligned" else 300_000
    fp, q, h = _block_inputs(300_000, n, w, seed=w, order=order)
    h[4:9] = torch.tensor([0, 1, 2, 7, fp.numel() - w], dtype=torch.int32)
    h[-4:] = torch.tensor([-5, fp.numel() - w + 1, 1 << 30, 2**31 - 1],
                          dtype=torch.int32)
    want = blockprobe.block_probe_reference(fp, q, h, w)
    if order == "unaligned":
        lead = {8: 3, 16: 1, 128: 7}[w]
        args = [_offset_view(fp, lead, cuda_device),
                _offset_view(q, 1, cuda_device),
                _offset_view(h, 1, cuda_device)]
        assert args[0].data_ptr() % 16 == 2 * lead
    else:
        args = [a.to(cuda_device) for a in (fp, q, h)]
    before = blockprobe.launches
    got = blockprobe.block_probe(*args, w)
    torch.cuda.synchronize()
    assert blockprobe.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert (want[1][-4:] == 0).all()
    assert set(want[1].tolist()) == {0, 1, 2, 3}


@pytest.mark.cuda
def test_cuda_block_probe_empty_launch(cuda_device):
    before = blockprobe.launches
    off, state = blockprobe.block_probe(
        torch.zeros(256, dtype=torch.uint16, device=cuda_device),
        torch.zeros(0, dtype=torch.uint16, device=cuda_device),
        torch.zeros(0, dtype=torch.int32, device=cuda_device), 16)
    torch.cuda.synchronize()
    assert off.numel() == state.numel() == 0
    assert blockprobe.launches == before


@pytest.mark.cuda
def test_cuda_block_probe_lookup_matches_cpu(cuda_device):
    """BlockProbeLookup on the card (one launch, the sparse lookup as its
    exact rest) gives the CPU twin's hits in input order."""
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


# --- the k-mer window kernel (csrc/kmer_windows.cu, ops/kmer_windows.py) ---

from kmergutsjava_tpu_torch.ops import kmer_windows  # noqa: E402
from kmergutsjava_tpu_torch.parallel import fused_probe  # noqa: E402

AA_BYTES = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY" * 4 + b"acdwyXBZJUO*-.",
                         np.uint8)
NT_BYTES = np.frombuffer(b"ACGT" * 8 + b"acgtuUNnRYKMSWBDHV-", np.uint8)


def _kw_rows(aa, b, lpad, seed):
    """Seeded rows: letters of the alphabet (lowercase, IUPAC and junk
    among them), every fifth byte of one row in 128-255, a row of each
    length class (0, < 8, 8: num_starts 0 for aa, the bucket's edge), zero
    padding past each length. Returns (ascii u8 [b, lpad], counts int32 [b]: num_starts =
    length - 8 for aa rows, lengths for DNA rows)."""
    rng = np.random.default_rng(seed)
    mat = rng.choice(AA_BYTES if aa else NT_BYTES, (b, lpad)).astype(
        np.uint8)
    mat[0, ::5] = rng.integers(128, 256, mat[0, ::5].shape)
    lens = rng.integers(0, lpad + 1, b)
    lens[:4] = [lpad, 0, min(5, lpad), min(8, lpad)][:b]
    mat[np.arange(lpad)[None, :] >= lens[:, None]] = 0
    counts = lens - 8 if aa else lens
    return mat, counts.astype(np.int32)


def _kw_windowed(length, win_nt, seed):
    """One long contig cut by plan_windows: (ascii [W, win_nt], len_w,
    row_map, own_start, own_end), numpy."""
    from kmergutsjava_tpu_torch.parallel.seq_windows import plan_windows

    rng = np.random.default_rng(seed)
    seq = rng.choice(NT_BYTES, length).astype(np.uint8)
    plan = plan_windows(length, win_nt)
    a = np.full((len(plan["s"]), win_nt), ord("N"), np.uint8)
    for i, (s, e) in enumerate(zip(plan["s"], plan["e"])):
        a[i, :e - s] = seq[s:e]
    return (a, *(plan[k].astype(np.int32) for k in
                 ("len_w", "row_map", "own_start", "own_end")))


KW_CASES = [("aa", 1, 8), ("aa", 5, 9), ("aa", 33, 256), ("aa", 7, 1100),
            ("dna", 1, 24), ("dna", 6, 256), ("dna", 9, 301),
            ("dna", 3, 3000), ("windowed", 1200, 150)]


def _kw_call(case, num_sigs):
    """The window twin (``windows_reference``) on a KW_CASES case."""
    kind, x, y = case
    if kind == "windowed":
        a, lens, *extra = map(torch.from_numpy, _kw_windowed(x, y, seed=x))
        return kmer_windows.windows_reference(a, lens, False, num_sigs,
                                              *extra)
    mat, counts = _kw_rows(kind == "aa", x, y, seed=x * 1000 + y)
    return kmer_windows.windows_reference(
        torch.from_numpy(mat), torch.from_numpy(counts), kind == "aa",
        num_sigs)


@pytest.mark.parametrize("case", KW_CASES)
def test_kmer_windows_cpu_runs_twin_and_counts_no_launch(case):
    """The window twin (the fused kernel's windows, the ragged entry's
    values): a window that is not valid has home -1, fingerprint 0, value
    -1, and valid windows carry the residues of their values."""
    homes, fps = _kw_call(case, 1_000_003)
    assert homes.dtype == torch.int32 and fps.dtype == torch.uint16
    bad = homes < 0
    assert (homes[bad] == -1).all() and (fps.view(torch.int16)[bad] == 0).all()
    if case[0] != "windowed":
        values = _kw_call(case, None)
        assert torch.equal(values < 0, bad)
        ok = ~bad
        assert torch.equal(homes[ok].long(), values[ok] % 1_000_003)
        assert torch.equal(tilejoin._widen(fps)[ok].long(),
                           values[ok] % 65535)


@pytest.mark.parametrize("bad", ["ascii_i32", "ascii_1d", "ascii_strided",
                                 "counts_i64", "counts_short", "ns0",
                                 "ns_big", "rowmap_alone", "rowmap_shape"])
def test_kmer_windows_wrapper_rejects_bad_inputs(bad):
    """The window checks (``kmer_windows._check``) as the fused entry makes
    them."""
    a = torch.zeros((4, 30), dtype=torch.uint8)
    c = torch.zeros(4, dtype=torch.int32)
    six = torch.zeros((4, 6), dtype=torch.int32)
    ns = 101
    extra = {}
    if bad == "ascii_i32":
        a = a.to(torch.int32)
    elif bad == "ascii_1d":
        a = a.view(-1)
    elif bad == "ascii_strided":
        a = torch.zeros((4, 60), dtype=torch.uint8)[:, ::2]
    elif bad == "counts_i64":
        c = c.long()
    elif bad == "counts_short":
        c = c[:3]
    elif bad == "ns0":
        ns = 0
    elif bad == "ns_big":
        ns = 1 << 31
    elif bad == "rowmap_alone":
        extra = {"row_map": six}
    elif bad == "rowmap_shape":
        extra = {"row_map": six[:, :5].contiguous(), "own_start": six,
                 "own_end": six}
    with pytest.raises(tilejoin.KernelError):
        fused_probe.first_event(torch.zeros(200, dtype=torch.uint16), a, c,
                                False, ns, 8, **extra)


def test_kmer_windows_reciprocal_is_exact():
    """The kernel's residue: floor(v * M / 2^66) == v // d with M =
    ceil(2^66 / d), for every k-mer value v < 20^8 at the divisors' edges
    (checked here in exact integers; the card's multiply-high gives the
    same high word)."""
    rng = np.random.default_rng(11)
    top = 20 ** 8 - 1
    divisors = [5, 6, 7, 11, 65535, 1_000_003, 40_009_777, 97_612_893,
                2 ** 31 - 1, *rng.integers(5, 2 ** 31, 40).tolist()]
    for d in divisors:
        m = kmer_windows.reciprocal(int(d))
        assert 0 < m < 1 << 64
        vs = {0, 1, d - 1, d, d + 1, top, top - 1, top // d * d,
              top // d * d - 1, *rng.integers(0, top, 200).tolist()}
        for v in vs:
            assert (v * m >> 64) >> 2 == v // d, (v, d)
    assert kmer_windows.reciprocal(4) == 0  # the kernel's plain % below 5


# the ragged entry (--prepare jax): unpadded rows, compacted windows
RAGGED_CASES = [(kind, case) for kind in ("aa", "dna")
                for case in ("empty", "no_rows", "short", "mixed",
                             "tiny_rows", "long", "empties")]


def _ragged_rows(kind, case):
    """Seeded unpadded rows (the protein alphabet above; for DNA ACGT with
    N, lowercase, IUPAC and junk bytes among them, stop codons by chance):
    ``short`` rows under 8 (aa) or 24 (DNA) bytes,
    ``mixed`` lengths 0-600, ``tiny_rows`` 3,000 rows of 1-12 bytes (a
    block's rows past its table of 256), ``long`` two rows of 9,000 bytes
    (rows over several blocks), ``empties`` runs of empty rows around
    five rows; ``empty`` one empty row, ``no_rows`` none."""
    rng = np.random.default_rng(len(case) * 7 + (kind == "aa"))
    alpha = AA_BYTES if kind == "aa" else np.concatenate(
        [np.frombuffer(b"ACGT" * 24, np.uint8), NT_BYTES[32:]])

    def rows(n, lo, hi):
        return [rng.choice(alpha, rng.integers(lo, hi)).astype(np.uint8)
                for _ in range(n)]

    made = {"empty": lambda: rows(1, 0, 1), "no_rows": lambda: [],
            "short": lambda: rows(40, 0, 8 if kind == "aa" else 24),
            "mixed": lambda: rows(60, 0, 600),
            "tiny_rows": lambda: rows(3000, 1, 13),
            "long": lambda: rows(2, 9000, 9001),
            "empties": lambda: (rows(300, 0, 1) + rows(5, 200, 3000)
                                + rows(300, 0, 1))}[case]()
    bounds = np.zeros(len(made) + 1, np.int32)
    np.cumsum([len(r) for r in made], out=bounds[1:])
    data = np.concatenate(made) if made else np.zeros(0, np.uint8)
    return data, bounds


@pytest.mark.parametrize("kind,case", RAGGED_CASES)
def test_ragged_values_twin_is_padded_entry_compacted(kind, case):
    """On the CPU the ragged entry is its twin and launches nothing; its
    windows are the valid ones of the window twin's values (every row
    padded to one width), in np.nonzero's order, and its counts theirs a
    container (a row, or a row's frame)."""
    data, bounds = _ragged_rows(kind, case)
    aa = kind == "aa"
    before = kmer_windows.ragged_launches
    values, pos, counts = kmer_windows.ragged_values(
        torch.from_numpy(data), torch.from_numpy(bounds), aa)
    assert kmer_windows.ragged_launches == before
    assert (values.dtype, pos.dtype, counts.dtype) == (
        torch.int64, torch.int32, torch.int32)
    lens = np.diff(bounds)
    width = max(int(lens.max(initial=0)), 32)
    mat = np.zeros((len(lens), width), np.uint8)
    for r, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        mat[r, :b - a] = data[a:b]
    padded = kmer_windows.windows_reference(
        torch.from_numpy(mat), torch.from_numpy(
            (lens - 8 if aa else lens).astype(np.int32)), aa).numpy()
    nz = np.nonzero(padded >= 0)
    np.testing.assert_array_equal(values.numpy(), padded[nz])
    np.testing.assert_array_equal(pos.numpy(), nz[-1])
    container = nz[0] if aa else nz[0] * 6 + nz[1]
    np.testing.assert_array_equal(counts.numpy(), np.bincount(
        container, minlength=len(lens) * (1 if aa else 6)))
    if case in ("mixed", "long", "empties"):
        assert len(values) > 100


@pytest.mark.parametrize("bad", ["bytes_i32", "bytes_2d", "bytes_strided",
                                 "bounds_i64", "bounds_empty",
                                 "two_devices"])
def test_ragged_values_wrapper_rejects_bad_inputs(bad):
    data = torch.zeros(40, dtype=torch.uint8)
    bounds = torch.tensor([0, 10, 40], dtype=torch.int32)
    if bad == "bytes_i32":
        data = data.to(torch.int32)
    elif bad == "bytes_2d":
        data = data.view(4, 10)
    elif bad == "bytes_strided":
        data = torch.zeros(80, dtype=torch.uint8)[::2]
    elif bad == "bounds_i64":
        bounds = bounds.long()
    elif bad == "bounds_empty":
        bounds = bounds[:0]
    elif bad == "two_devices":
        data = data.to("meta")
    with pytest.raises(tilejoin.KernelError):
        kmer_windows.ragged_values(data, bounds, True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,case", RAGGED_CASES)
def test_cuda_ragged_values_match_twin(cuda_device, kind, case):
    """The ragged entry's kernels against the twin, every value, position
    and count equal; one call counted (none without a byte)."""
    data, bounds = _ragged_rows(kind, case)
    args = (torch.from_numpy(data), torch.from_numpy(bounds))
    want = kmer_windows.ragged_values(*args, kind == "aa")
    before = kmer_windows.ragged_launches
    got = kmer_windows.ragged_values(*(a.to(cuda_device) for a in args),
                                     kind == "aa")
    torch.cuda.synchronize()
    assert kmer_windows.ragged_launches == before + (len(data) > 0)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)


def _many_tile_rows(kind):
    """About 400 KB of seeded unpadded rows: groups of eight rows of 50-3,000
    bytes, then runs of 30 rows of 100-400 X (aa) or N (DNA) bytes and of 20
    rows under 8 bytes, none of which has a valid window, so whole blocks
    post a count of 0."""
    rng = np.random.default_rng(11 + (kind == "aa"))
    alpha = AA_BYTES if kind == "aa" else np.frombuffer(b"ACGT", np.uint8)
    bad = ord("X") if kind == "aa" else ord("N")
    made = []
    for _ in range(20):
        made += [rng.choice(alpha, rng.integers(50, 3000)).astype(np.uint8)
                 for _ in range(8)]
        made += [np.full(rng.integers(100, 400), bad, np.uint8)
                 for _ in range(30)]
        made += [rng.choice(alpha, rng.integers(0, 8)).astype(np.uint8)
                 for _ in range(20)]
    bounds = np.zeros(len(made) + 1, np.int32)
    np.cumsum([len(r) for r in made], out=bounds[1:])
    return np.concatenate(made), bounds


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["aa", "dna"])
def test_cuda_ragged_values_many_tiles_match_twin(cuda_device, kind):
    """Past a hundred blocks of 2,048 positions (aa one a byte, DNA two),
    so that a block's look-back walks past the 32 blocks before it and
    meets blocks that have not posted yet: the ragged entry equals its
    twin in each of five calls."""
    data, bounds = _many_tile_rows(kind)
    per_byte = 1 if kind == "aa" else 2
    assert len(data) * per_byte // 2048 >= 100
    args = (torch.from_numpy(data), torch.from_numpy(bounds))
    want = kmer_windows.ragged_values(*args, kind == "aa")
    assert len(want[0]) > 10_000 and int((want[2] == 0).sum()) > 500
    on_card = [a.to(cuda_device) for a in args]
    for _ in range(5):
        before = kmer_windows.ragged_launches
        got = kmer_windows.ragged_values(*on_card, kind == "aa")
        torch.cuda.synchronize()
        assert kmer_windows.ragged_launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


# --- the fused step's kernel (csrc/fused_probe.cu, parallel/fused_probe.py) --


def _fused_rows(kind, b, lpad, seed):
    """Seeded rows of mostly clean letters (1% junk), so that most windows
    are valid, a row of each length class (full, 0, < 8, 8); counts as
    _kw_rows gives them."""
    rng = np.random.default_rng(seed)
    aa = kind == "aa"
    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY" if aa else b"ACGTacgt",
                            np.uint8)
    mat = rng.choice(letters, (b, lpad)).astype(np.uint8)
    mat[rng.random((b, lpad)) < 0.01] = ord("X" if aa else "N")
    lens = rng.integers(0, lpad + 1, b)
    lens[:4] = [lpad, 0, min(5, lpad), min(8, lpad)][:b]
    mat[np.arange(lpad)[None, :] >= lens[:, None]] = 0
    return mat, (lens - 8 if aa else lens).astype(np.int32)


# the window kernel's cases (junk-heavy rows) and clean ones: (kind, rows,
# Lpad) or (windowed kind, contig length, win_nt)
FUSED_CASES = [*KW_CASES[:9], ("clean aa", 512, 256), ("clean aa", 300, 9),
               ("clean dna", 512, 256), ("clean dna", 200, 26),
               ("clean dna", 3, 3000), ("clean windowed", 40_000, 12288)]


def _fused_inputs(case):
    """(aa, ascii, counts, extra) of a FUSED_CASES case, numpy."""
    kind, x, y = case
    if kind.endswith("windowed"):
        a, lens, rm, os_, oe = _kw_windowed(x, y, seed=x)
        if kind.startswith("clean"):  # the same windows of a clean contig
            rng = np.random.default_rng(x)
            clean = rng.choice(np.frombuffer(b"ACGT", np.uint8), a.shape)
            inside = np.arange(y)[None, :] < lens[:, None]
            a = np.where(inside, clean, a).astype(np.uint8)
        return False, a, lens, (rm, os_, oe)
    base = kind.split()[-1]
    mat, counts = (_fused_rows(base, x, y, seed=x + y) if kind.startswith(
        "clean") else _kw_rows(base == "aa", x, y, seed=x * 1000 + y))
    return base == "aa", mat, counts, ()


def _fused_plane(length, homes, fps, w, seed, lo=0):
    """A seeded u16 plane of ``length`` slots (global slots from ``lo``)
    with 35% empties; half the valid windows' fingerprints planted in their
    window (half of those in its first three slots)."""
    rng = np.random.default_rng(seed)
    plane = rng.integers(0, FP_EMPTY, length).astype(np.uint16)
    plane[rng.random(length) < 0.35] = FP_EMPTY
    pick = np.nonzero((homes >= 0) & (rng.random(len(homes)) < 0.5))[0]
    near = rng.random(len(pick)) < 0.5
    at = homes[pick].astype(np.int64) - lo + np.where(
        near, rng.integers(0, min(w, 3), len(pick)),
        rng.integers(0, w, len(pick)))
    keep = (at >= 0) & (at < length)
    plane[at[keep]] = fps[pick][keep]
    return plane


def _card_plane(plane, device, unaligned):
    """The plane on the card; with ``unaligned`` a view that starts one
    slot into its allocation (the kernels' unaligned path)."""
    if not unaligned:
        return torch.from_numpy(plane).to(device)
    big = torch.from_numpy(np.concatenate([[7], plane]).astype(np.uint16))
    return big.to(device)[1:]


def test_fused_cpu_entries_run_twins_and_count_no_launch():
    """On the CPU both fused entries are the composition of the window
    kernel's twin with B1's or B12's, and launch nothing."""
    aa, mat, counts, _ = _fused_inputs(("clean aa", 40, 64))
    a, c = torch.from_numpy(mat), torch.from_numpy(counts)
    homes, fps = kmer_windows.windows_reference(a, c, True, 1009)
    plane = torch.from_numpy(_fused_plane(
        1025, homes.view(-1).numpy(), tilejoin._widen(fps).view(-1).numpy(),
        16, seed=2))
    before = fused_probe.launches
    got = fused_probe.first_event(plane, a, c, True, 1009, 16)
    want = tilejoin.probe_answer(plane, fps.view(-1), homes.view(-1), 16)
    n = homes.numel()
    s = -(-n // 16) * 16
    assert torch.equal(got[:n], want[:n])
    assert torch.equal(got[s:s + n], want[s:s + n])
    from kmergutsjava_tpu_torch.parallel import shard_probe

    got = fused_probe.shard_first_match(plane[300:], a, c, True, 1009, 300,
                                        400, 16)
    want = shard_probe.shard_probe_reference(plane[300:], fps.view(-1),
                                             homes.view(-1), 300, 400, 16)
    assert torch.equal(got, want) and (got > 0).any()
    assert fused_probe.launches == before


def test_fused_kernel_divisions_are_exact():
    """The fused kernel's index divisions (csrc/fused_probe.cu div_of):
    (x * m) >> (31 + s) == x // d with s = ceil(log2 d) and m =
    ceil(2^(31+s) / d), for every x < 2^31 at the divisors' edges and at
    random, the product within 64 bits (checked here in exact integers)."""
    rng = np.random.default_rng(12)
    top = (1 << 31) - 1
    divisors = [1, 2, 3, 6, 7, 8, 9, 15, 78, 85, 249, 256, 4089, 4096,
                (1 << 30) - 7, (1 << 30) + 6,
                *rng.integers(1, 1 << 30, 40).tolist()]
    for d in divisors:
        sh = max(int(d - 1).bit_length(), 0)
        m = -(-(1 << (31 + sh)) // d)
        assert top * m < 1 << 64
        xs = {0, 1, d - 1, d, d + 1, top, top - 1, top // d * d,
              top // d * d - 1, *rng.integers(0, top, 300).tolist()}
        for x in xs:
            assert (x * m) >> (31 + sh) == x // d, (x, d)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FUSED_CASES)
def test_cuda_fused_first_event_matches_twin(cuda_device, case):
    """The fused kernel's first-event entry (the fused step on one card)
    against its twin, off and state of every window equal, one launch a
    call: tables of 4 and 11 slots (the plain % path) and of 1,000,003 and
    40,009,777; windows 1 to 256; a padded plane, one shorter than the
    table (windows off its end) and one that starts one slot into its
    allocation."""
    aa, mat, counts, extra = _fused_inputs(case)
    cpu = [torch.from_numpy(x) for x in (mat, counts, *extra)]
    card = [x.to(cuda_device) for x in cpu]
    for ns, ws in ((4, (1, 16)), (11, (7, 16)), (1_000_003, (1, 16, 128, 256)),
                   (40_009_777, (16,))):
        homes, fps = kmer_windows.windows_reference(cpu[0], cpu[1], aa, ns,
                                                    *cpu[2:])
        h = homes.view(-1).numpy()
        f = tilejoin._widen(fps).view(-1).numpy()
        for w in ws:
            for form in ("padded", "short", "unaligned"):
                length = ns // 2 + 1 if form == "short" else ns + w
                plane = _fused_plane(length, h, f, w, seed=w + ns % 97)
                if form != "short":
                    plane[ns:] = FP_EMPTY
                want = fused_probe.first_event(torch.from_numpy(plane),
                                               cpu[0], cpu[1], aa, ns, w,
                                               *cpu[2:])
                before = fused_probe.launches
                got = fused_probe.first_event(
                    _card_plane(plane, cuda_device, form == "unaligned"),
                    card[0], card[1], aa, ns, w, *card[2:])
                torch.cuda.synchronize()
                assert fused_probe.launches == before + 1
                n = h.size
                s = -(-n // 16) * 16
                got = got.cpu()
                assert torch.equal(got[:n], want[:n]), (ns, w, form)
                assert torch.equal(got[s:s + n], want[s:s + n]), (ns, w, form)
    if case[0].startswith("clean"):
        st = want[s:s + n]
        assert (st == 1).any() and (st == 2).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", FUSED_CASES)
def test_cuda_fused_shard_probe_matches_twin(cuda_device, case):
    """The fused kernel's shard entry (the fused step at a mesh position)
    against its twin, every int32 equal, one launch a call: each of three
    table shards of a 1,000,003- and a 97-slot table (homes at the shards'
    edges and in their halos), windows 1 to 128, the slice starting one
    slot into its allocation for odd windows."""
    aa, mat, counts, extra = _fused_inputs(case)
    cpu = [torch.from_numpy(x) for x in (mat, counts, *extra)]
    card = [x.to(cuda_device) for x in cpu]
    for ns in (97, 1_000_003):
        homes, fps = kmer_windows.windows_reference(cpu[0], cpu[1], aa, ns,
                                                    *cpu[2:])
        h = homes.view(-1).numpy()
        f = tilejoin._widen(fps).view(-1).numpy()
        for w in (1, 8, 16, 24, 128):
            s_loc = -(-ns // 3)
            full = _fused_plane(3 * s_loc + w, h, f, w, seed=w)
            for t in range(3):
                lo = t * s_loc
                plane = full[lo:lo + s_loc + w].copy()
                want = fused_probe.shard_first_match(
                    torch.from_numpy(plane), cpu[0], cpu[1], aa, ns, lo,
                    s_loc, w, *cpu[2:])
                before = fused_probe.launches
                got = fused_probe.shard_first_match(
                    _card_plane(plane, cuda_device, w % 2 == 1), card[0],
                    card[1], aa, ns, lo, s_loc, w, *card[2:])
                torch.cuda.synchronize()
                assert fused_probe.launches == before + 1
                assert torch.equal(got.cpu(), want), (ns, w, t)
    if case[0].startswith("clean"):
        assert (want > 0).any()


@pytest.mark.cuda
def test_cuda_fused_empty_and_device_checks(cuda_device):
    """Rows with no window launch nothing; a plane on another device than
    the rows raises KernelError."""
    plane = torch.zeros(64, dtype=torch.uint16, device=cuda_device)
    before = fused_probe.launches
    for aa, shape in ((True, (3, 7)), (True, (0, 64)), (False, (2, 23))):
        a = torch.zeros(shape, dtype=torch.uint8, device=cuda_device)
        c = torch.zeros(shape[0], dtype=torch.int32, device=cuda_device)
        assert fused_probe.first_event(plane, a, c, aa, 40, 16).numel() == 0
        assert fused_probe.shard_first_match(plane, a, c, aa, 40, 0, 40,
                                             16).numel() == 0
    assert fused_probe.launches == before
    a = torch.zeros((2, 30), dtype=torch.uint8, device=cuda_device)
    c = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(tilejoin.KernelError):
        fused_probe.first_event(plane.cpu(), a, c, True, 40, 16)


def _kw_table(seed, n_sigs=20_000):
    """A seeded table whose signatures include 8-mers of random proteins
    (so candidates and hits occur), and those proteins."""
    from kmergutsjava_tpu_torch.constants import AA_OFF_LUT, POW20
    from kmergutsjava_tpu_torch.formats.kmer_table import build_table

    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    prots = [rng.choice(letters, int(rng.integers(5, 900))).astype(np.uint8)
             for _ in range(300)]
    vals = set()
    for p in prots[::2]:
        o = AA_OFF_LUT[p].astype(np.int64)
        for i in range(0, len(p) - 8, 3):
            vals.add(int((o[i:i + 8] * POW20).sum()))
    kmers = np.unique(np.concatenate([np.array(sorted(vals), np.int64),
                                      rng.integers(0, 20 ** 8, n_sigs)]))
    n = len(kmers)
    table = build_table(kmers, rng.integers(0, 20, n).astype(np.int32),
                        rng.integers(0, 500, n).astype(np.int32),
                        rng.integers(0, 97, n).astype(np.int32),
                        rng.random(n).astype(np.float32), load_factor=0.7)
    table.compute_max_probe()
    return table, prots


CODON = dict(zip(b"ACDEFGHIKLMNPQRSTVWY", (
    b"GCT", b"TGT", b"GAT", b"GAA", b"TTT", b"GGT", b"CAT", b"ATT", b"AAA",
    b"CTT", b"ATG", b"AAT", b"CCT", b"CAA", b"CGT", b"TCT", b"ACT", b"GTT",
    b"TGG", b"TAT")))


def _kw_contigs(prots, seed, width=3000):
    """Contigs coding for ``prots`` (their first 990 residues), every
    third one reverse-complemented, behind a few random bases: rows
    [len(prots), width] and their lengths."""
    rng = np.random.default_rng(seed)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    mat = np.zeros((len(prots), width), np.uint8)
    lens = np.zeros(len(prots), np.int64)
    for i, p in enumerate(prots):
        nt = b"".join(CODON[c] for c in p[:990].tobytes())
        if i % 3 == 0:
            nt = nt.translate(comp)[::-1]
        nt = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                        i % 4).tobytes() + nt
        mat[i, :len(nt)] = np.frombuffer(nt, np.uint8)
        lens[i] = len(nt)
    return mat, lens


def test_contigs_of_the_fused_step_test_hit():
    """The cuda test's contigs have candidates (on the CPU, the twins)."""
    from kmergutsjava_tpu_torch.parallel import annotate_step as st

    table, prots = _kw_table(5)
    mat, lens = _kw_contigs(prots[::2][:64], seed=9)
    step, planes = st.make_dna_step(table, max(8, table.max_probe), "cpu")
    idx, off = st.read_candidates(*step(planes["fp"], mat, lens))
    assert len(off) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("aa", [True, False])
def test_cuda_fused_step_decodes_to_twin_hits(cuda_device, aa):
    """The fused step (one launch of the fused kernel's first-event entry,
    and no window kernel or B1 launch) on the card: its answer (off and
    state) equals the CPU step's (the twins), and so do its decoded,
    verified hits."""
    from kmergutsjava_tpu_torch.ops import hostvalues
    from kmergutsjava_tpu_torch.parallel import annotate_step as st
    from kmergutsjava_tpu_torch.parallel.sharded_lookup import \
        gather_hit_metadata

    table, prots = _kw_table(5)
    pw = max(8, table.max_probe)
    if aa:
        mat = np.zeros((len(prots), 1024), np.uint8)
        for i, p in enumerate(prots):
            mat[i, :len(p)] = p
        lens = np.array([len(p) for p in prots])
        make = st.make_annotate_step
    else:
        mat, lens = _kw_contigs(prots[::2][:64], seed=9)
        make = st.make_dna_step
    hits = {}
    for dev in (cuda_device, torch.device("cpu")):
        step, planes = make(table, pw, dev)
        before = (fused_probe.launches, tilejoin.launches)
        answer, shape = step(planes["fp"], mat, lens)
        assert (fused_probe.launches, tilejoin.launches) == (
            (before[0] + 1, before[1]) if dev.type == "cuda" else before)
        # off and state views (the bytes between them are not written)
        hits[dev.type] = [v.clone() for v in tilejoin.answer_views(
            answer.cpu(), int(np.prod(shape)))]
        idx, off = st.read_candidates(answer, shape)
        vals = (hostvalues.aa_values_at(mat, *idx) if aa else
                hostvalues.dna_values_at(mat, lens, *idx))
        found = gather_hit_metadata(
            table, st.candidate_slots(vals, off, table.num_sigs),
            values=vals, probe_window=pw)
        hits[dev.type] += [*idx, off, *found]
        assert found[0].sum() > 100
    for got, want in zip(hits["cuda"], hits["cpu"]):
        assert (torch.equal(got, want) if isinstance(got, torch.Tensor)
                else np.array_equal(got, want))


def _mesh_table(seed, n=200_000):
    from kmergutsjava_tpu_torch.constants import MAX_ENCODED
    from kmergutsjava_tpu_torch.formats.kmer_table import build_table

    rng = np.random.default_rng(seed)
    kmers = rng.choice(MAX_ENCODED, n, replace=False).astype(np.int64)
    table = build_table(kmers, rng.integers(0, 20, n).astype(np.int32),
                        rng.integers(0, 500, n).astype(np.int32),
                        rng.integers(0, 97, n).astype(np.int32),
                        rng.random(n).astype(np.float32), load_factor=0.7)
    values = np.concatenate([rng.choice(kmers, 150_000),
                             rng.integers(0, MAX_ENCODED, 150_001)])
    rng.shuffle(values)
    return table, values


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 16, 24, 64, 128])
@pytest.mark.parametrize("unaligned", [False, True])
def test_cuda_shard_probe_matches_twin(cuda_device, w, unaligned):
    """B12 on the card equals its twin (int32, exact) for a middle shard of
    a 300,000-slot plane: homes inside and outside its range, negative
    ones, planted matches behind empty slots; the plane's slice starting
    at an odd slot when ``unaligned``. One launch."""
    from kmergutsjava_tpu_torch.parallel import shard_probe

    fp = _plane(300_000, seed=w)
    s_loc, lo = 90_001, 100_003
    sl = slice(lo + unaligned, lo + unaligned + s_loc + w)
    plane = torch.from_numpy(fp[sl].copy())
    qfp, homes = _queries(fp, 400_000, w, seed=w + 1)
    homes[::97] = -5
    args = (torch.from_numpy(qfp), torch.from_numpy(homes))
    want = shard_probe.shard_probe_reference(plane, *args, lo + unaligned,
                                             s_loc, w)
    # an odd slot's slice of a card tensor: the kernel's unaligned path
    big = torch.from_numpy(fp[sl.start - 1:sl.stop].copy()).to(cuda_device)
    on_card = big[1:] if unaligned else plane.to(cuda_device)
    before = shard_probe.launches
    got = shard_probe.shard_probe(on_card, *(a.to(cuda_device) for a in args),
                                  lo + unaligned, s_loc, w)
    torch.cuda.synchronize()
    assert shard_probe.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert int((want > 0).sum()) > 10_000


B12_EDGES = ["edges", "all_owned", "none_owned", "n_odd", "w1", "w128"]


def _b12_edge(case):
    """(plane, q_fp, homes, lo, s_loc, w) numpy: a shard [lo, lo + s_loc)
    of a seeded plane with planted matches behind empty slots. ``edges``
    puts homes at lo - 1, lo, lo + s_loc - 1, lo + s_loc and negative
    (-1, -2^31) among the others; ``all_owned``/``none_owned`` every home
    inside or outside the range; ``n_odd`` a count that is no multiple of
    a block's 256 queries; ``w1`` and ``w128`` the window's limits."""
    w = {"w1": 1, "w128": 128}.get(case, 16)
    n = {"n_odd": 128 * 301 + 37}.get(case, 40_000)
    rng = np.random.default_rng(len(case))
    lo, s_loc = 50_003, 30_011
    plane = _plane(s_loc + w, seed=len(case) + 3)
    homes = rng.integers(lo - 2_000, lo + s_loc + 2_000, n)
    if case == "all_owned":
        homes = rng.integers(lo, lo + s_loc, n)
    elif case == "none_owned":
        homes = np.where(rng.random(n) < 0.5, rng.integers(-9, lo, n),
                         rng.integers(lo + s_loc, lo + 2 * s_loc, n))
    elif case == "edges":
        homes[::5] = rng.choice([lo - 1, lo, lo + s_loc - 1, lo + s_loc, -1,
                                 -2 ** 31], homes[::5].shape)
    homes = homes.astype(np.int32)
    local = np.clip(homes.astype(np.int64) - lo, 0, s_loc - 1)
    q = rng.integers(0, 65535, n).astype(np.uint16)
    plant = rng.random(n) < 0.5
    q[plant] = plane[local[plant] + rng.integers(0, w, int(plant.sum()))]
    return plane, q, homes, lo, s_loc, w


def _b12_scan(plane, q, homes, lo, s_loc, w):
    """B12's answers by a plain scan: the global slot + 1 of the first slot
    of each owned home's window holding its fingerprint, else 0."""
    out = np.zeros(len(homes), np.int32)
    for i, (h, f) in enumerate(zip(homes.astype(np.int64), q)):
        if lo <= h < lo + s_loc:
            hit = np.nonzero(plane[h - lo:h - lo + w] == f)[0]
            if len(hit):
                out[i] = h + hit[0] + 1
    return out


@pytest.mark.parametrize("case", B12_EDGES)
def test_b12_twin_on_edge_operands(case):
    """B12's twin at the window's and the shard's edges equals a plain
    scan."""
    from kmergutsjava_tpu_torch.parallel import shard_probe

    plane, q, homes, lo, s_loc, w = _b12_edge(case)
    got = shard_probe.shard_probe(torch.from_numpy(plane),
                                  torch.from_numpy(q),
                                  torch.from_numpy(homes), lo, s_loc, w)
    want = _b12_scan(plane, q, homes, lo, s_loc, w)
    np.testing.assert_array_equal(got.numpy(), want)
    owned = ((homes >= lo) & (homes < lo + s_loc)).sum()
    assert owned == {"all_owned": len(homes), "none_owned": 0}.get(
        case, owned)
    found = int((want > 0).sum())
    assert found == 0 if case == "none_owned" else found > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("case", B12_EDGES)
def test_cuda_shard_probe_edges_match_twin(cuda_device, case):
    """B12 on the card equals its twin at the edges, also on views whose
    homes, fingerprints and answers lie off the kernel's vector
    alignment."""
    from kmergutsjava_tpu_torch.parallel import shard_probe

    plane, q, homes, lo, s_loc, w = _b12_edge(case)
    want = shard_probe.shard_probe(*(torch.from_numpy(a) for a in
                                     (plane, q, homes)), lo, s_loc, w)
    for lead in (0, 1):
        qd = torch.from_numpy(np.concatenate([q[:lead], q])).to(
            cuda_device)[lead:]
        hd = torch.from_numpy(np.concatenate([homes[:lead], homes])).to(
            cuda_device)[lead:]
        before = shard_probe.launches
        got = shard_probe.shard_probe(torch.from_numpy(plane).to(cuda_device),
                                      qd, hd, lo, s_loc, w)
        torch.cuda.synchronize()
        assert shard_probe.launches == before + 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_shard_probe_empty_and_device_checks(cuda_device):
    from kmergutsjava_tpu_torch.parallel import shard_probe

    plane = torch.zeros(40, dtype=torch.uint16, device=cuda_device)
    e16 = torch.zeros(0, dtype=torch.uint16, device=cuda_device)
    e32 = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    assert shard_probe.shard_probe(plane, e16, e32, 0, 20, 16).numel() == 0
    with pytest.raises(tilejoin.KernelError):
        shard_probe.shard_probe(plane, e16, e32.cpu(), 0, 20, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("n,shards,cap", [
    (1000, 1, 64), (100_000, 2, 100_000), (300_001, 4, 64),
    (300_001, 8, 30_000), (70_000, 256, 200), (5, 3, 1)])
def test_cuda_route_bins_match_twin(cuda_device, n, shards, cap):
    """B13 on the card equals its twins exactly: the bins (fingerprints and
    homes, FP_EMPTY and 0 in unused cells), each query's cell (-1 for an
    overflow or a padded query) and the un-binned answers; with uniform
    homes, homes skewed onto one shard and small caps (overflow)."""
    from kmergutsjava_tpu_torch.parallel import route_bins

    rng = np.random.default_rng(n + shards)
    num_sigs = 1_000_003
    homes = rng.integers(0, num_sigs, n).astype(np.int32)
    homes[rng.random(n) < 0.3] = rng.integers(0, 1000)  # a skewed share
    qfp = rng.integers(0, 65535, n).astype(np.uint16)
    s_loc = -(-num_sigs // shards)
    n_valid = n - n // 7
    cpu = [torch.from_numpy(qfp), torch.from_numpy(homes)]
    want = route_bins.bins_reference(*cpu, n_valid, s_loc, shards, cap)
    before = (route_bins.launches, route_bins.unbin_launches)
    got = route_bins.bins(*(x.to(cuda_device) for x in cpu), n_valid, s_loc,
                          shards, cap)
    back = torch.from_numpy(rng.integers(0, 256, (shards, 2, cap)).astype(
        np.uint8))
    want_u = route_bins.unbin_reference(want[2], back)
    got_u = route_bins.unbin(got[2], back.to(cuda_device))
    torch.cuda.synchronize()
    assert (route_bins.launches, route_bins.unbin_launches) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip((*got, got_u), (*want, want_u)):
        assert torch.equal(a.cpu(), b)
    assert int((want[2] < 0).sum()) >= n // 7


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tiles_past_1024", "one_owner",
                                  "all_overflow", "shards_1", "shards_4",
                                  "shards_256"])
def test_cuda_route_bins_edge_cases(cuda_device, case):
    """B13 on the card equals its twins: 1,100,000 queries (1,075 tiles,
    past one scan block of 1,024 tiles, so the scan carries a total), every
    query of one owner, every query overflowing (all padded), and 1, 4 and
    256 shards; one launch of each entry."""
    from kmergutsjava_tpu_torch.parallel import route_bins

    rng = np.random.default_rng(len(case))
    num_sigs = 1_000_003
    n, shards, cap, n_valid = {
        "tiles_past_1024": (1_100_000, 4, 300_000, 1_099_990),
        "one_owner": (200_000, 4, 150_000, 200_000),
        "all_overflow": (50_000, 4, 1000, 0),
        "shards_1": (300_000, 1, 250_000, 299_000),
        "shards_4": (300_000, 4, 70_000, 299_000),
        "shards_256": (300_000, 256, 1500, 299_000)}[case]
    homes = rng.integers(0, num_sigs, n).astype(np.int32)
    if case == "one_owner":
        homes = rng.integers(0, num_sigs // shards, n).astype(np.int32)
    qfp = rng.integers(0, 65535, n).astype(np.uint16)
    s_loc = -(-num_sigs // shards)
    cpu = [torch.from_numpy(qfp), torch.from_numpy(homes)]
    want = route_bins.bins_reference(*cpu, n_valid, s_loc, shards, cap)
    before = (route_bins.launches, route_bins.unbin_launches)
    got = route_bins.bins(*(x.to(cuda_device) for x in cpu), n_valid, s_loc,
                          shards, cap)
    back = torch.from_numpy(rng.integers(0, 256, (shards, 2, cap)).astype(
        np.uint8))
    want_u = route_bins.unbin_reference(want[2], back)
    got_u = route_bins.unbin(got[2], back.to(cuda_device))
    torch.cuda.synchronize()
    assert (route_bins.launches, route_bins.unbin_launches) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip((*got, got_u), (*want, want_u)):
        assert torch.equal(a.cpu(), b)
    if case == "all_overflow":
        assert bool((want[2] < 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["phase_13", "tails", "empty",
                                  "all_overflow", "shards_256"])
def test_cuda_route_unbin_matches_twin(cuda_device, case):
    """B13's un-binning on the card equals its twin exactly, one launch a
    call: at chip_smoke phase 13's shape (shard 0 of the routed run over 4:
    1,009,459 queries, cap 504,729, cells in owner runs, a few overflows),
    at every length from 1 to 40 (each tail mod 16 and mod 8), no query,
    every query overflowing and 256 owners."""
    from kmergutsjava_tpu_torch.parallel import route_bins

    rng = np.random.default_rng(len(case))
    shards, cap = {"phase_13": (4, 504_729), "shards_256": (256, 3000)}.get(
        case, (4, 1000))
    sizes = {"phase_13": [1_009_459], "tails": range(1, 41), "empty": [0],
             "all_overflow": [70_001], "shards_256": [300_007]}[case]
    back = torch.from_numpy(rng.integers(0, 256, (shards, 2, cap)).astype(
        np.uint8))
    for n in sizes:
        owner = np.sort(rng.integers(0, shards, n))
        cell = (owner * cap + rng.integers(0, cap, n)).astype(np.int32)
        cell[rng.random(n) < 0.01] = -1
        if case == "all_overflow":
            cell[:] = -1
        cpu = torch.from_numpy(cell)
        want = route_bins.unbin_reference(cpu, back)
        before = route_bins.unbin_launches
        got = route_bins.unbin(cpu.to(cuda_device), back.to(cuda_device))
        torch.cuda.synchronize()
        assert route_bins.unbin_launches == before + (1 if n else 0)
        assert got.shape == want.shape and torch.equal(got.cpu(), want)


def _placement(cuda_device, placement):
    """Four mesh positions: all on the one card, or on four distinct cards
    (skipped where the machine has fewer)."""
    if placement == "one_card":
        return [cuda_device] * 4
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    return [torch.device("cuda", i) for i in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["one_card", "distinct_cards"])
@pytest.mark.parametrize("backend", ["sharded", "routed", "replicated",
                                     "xla", "stream"])
def test_cuda_mesh_lookups_match_cpu(cuda_device, backend, placement):
    """Each mesh lookup with four positions, on the one card (each its own
    stream) or on four cards (the collectives' copies between cards),
    gives the CPU twins' hits, and launches its kernels."""
    from kmergutsjava_tpu_torch.parallel import (mesh, replicated_lookup,
                                                 route_bins, routed_lookup,
                                                 shard_probe, sharded_lookup,
                                                 stream_shards,
                                                 tilejoin_shards)

    table, values = _mesh_table(31)
    cnt = np.zeros(len(values), np.int64)
    pos = np.arange(len(values), dtype=np.int64)
    cards = _placement(cuda_device, placement)
    kernel = {"sharded": shard_probe, "routed": route_bins,
              "replicated": tilejoin, "xla": tilejoin,
              "stream": stream}[backend]
    got = {}
    for dev in ("cpu", "cuda"):
        devs = [torch.device("cpu")] * 4 if dev == "cpu" else cards
        before = kernel.launches
        if backend == "sharded":
            lk = sharded_lookup.ShardedLookup(
                table, mesh.make_mesh(2, 2, devs), max(8, table.max_probe))
        elif backend == "routed":
            lk = routed_lookup.RoutedLookup(
                table, mesh.make_mesh(1, 4, devs),
                probe_window=max(16, table.max_probe))
        elif backend == "replicated":
            lk = replicated_lookup.ReplicatedLookup(
                table, mesh.make_mesh(4, 1, devs))
        elif backend == "xla":
            lk = tilejoin_shards.TileJoinShardedLookup(
                table, mesh.make_mesh(1, 4, devs),
                chunk=1 << 16)
        else:
            lk = stream_shards.StreamShardedLookup(
                table, stream_shards.make_stream_mesh(4, devs))
        got[dev] = lk.lookup(values, cnt, pos).pos
        # four positions: four launches (a dispatch's, for xla)
        assert kernel.launches - before == (0 if dev == "cpu" else
                                            20 if backend == "xla" else 4)
    assert len(got["cpu"]) > 100_000
    np.testing.assert_array_equal(np.sort(got["cpu"]), np.sort(got["cuda"]))


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["one_card", "distinct_cards"])
@pytest.mark.parametrize("aa", [True, False])
def test_cuda_spmd_mesh_step_matches_cpu(cuda_device, aa, placement):
    """The fused step on a (2, 2) mesh (the fused kernel's shard entry on
    every position, the sum over the table axis) on the card gives the CPU
    twins' int32 answer, bit for bit, with four launches of it and none of
    the window kernel or B12."""
    from kmergutsjava_tpu_torch.parallel import annotate_step as st
    from kmergutsjava_tpu_torch.parallel import mesh, shard_probe

    table, prots = _kw_table(5)
    pw = max(8, table.max_probe)
    if aa:
        mat = np.zeros((len(prots), 1024), np.uint8)
        for i, p in enumerate(prots):
            mat[i, :len(p)] = p
        lens = np.array([len(p) for p in prots])
        make = st.make_sharded_annotate_step
    else:
        mat, lens = _kw_contigs(prots[::2][:63], seed=9)
        make = st.make_sharded_dna_step
    got = {}
    for dev in ("cpu", "cuda"):
        devs = ([torch.device("cpu")] * 4 if dev == "cpu"
                else _placement(cuda_device, placement))
        m = mesh.make_mesh(2, 2, devs)
        step, planes = make(m, table, pw)
        before = (fused_probe.launches, shard_probe.launches)
        got[dev] = step(planes["fp"], mat, lens).read()
        assert (fused_probe.launches - before[0],
                shard_probe.launches - before[1]) == (
            (0, 0) if dev == "cpu" else (4, 0))
    assert int((got["cpu"] > 0).sum()) > 1000
    np.testing.assert_array_equal(got["cuda"], got["cpu"])


def _scan_batch(seed, n_cont=400, cap_container=False):
    """Seeded containers of position-sorted hits for the grouping kernel
    (B11): lengths 0-300 (empty ones too), one to four functions, gaps
    around the tested max_gap; with ``cap_container`` a first container of
    40,030 hits of one function but for its last 20 (past the append cap)."""
    from kmergutsjava_tpu_torch.calls import scan_machine

    rng = np.random.default_rng(seed)
    cs = []
    if cap_container:
        n = 40_030
        fi = np.zeros(n, np.int32)
        fi[-20:] = rng.integers(0, 3, 20)
        cs.append((np.arange(n, dtype=np.int64) * 2,
                   rng.integers(0, 5, n).astype(np.int32),
                   rng.integers(0, 300, n).astype(np.int32), fi,
                   rng.choice([0.25, 1.0], n).astype(np.float32)))
    for _ in range(n_cont):
        n = int(rng.choice([0, rng.integers(1, 40), rng.integers(40, 300)]))
        pos = np.sort(rng.choice(4000, n, replace=False)).astype(np.int64)
        cs.append((pos, rng.integers(0, 5, n).astype(np.int32),
                   rng.integers(0, 300, n).astype(np.int32),
                   rng.integers(0, int(rng.integers(1, 5)), n).astype(
                       np.int32),
                   rng.choice([0.1, 0.25, 1.0, 2.5, 1 / 3], n).astype(
                       np.float32)))
    return scan_machine.pack_containers(cs)


def _scan_equal(got, want):
    """Flags equal everywhere, records at the emitting steps."""
    flags, recs = (x.cpu() for x in got)
    assert torch.equal(flags, want[0])
    emit = (want[0] & 2) != 0
    assert torch.equal(recs[emit], want[1][emit])
    return int(emit.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("order_constraint", [False, True])
@pytest.mark.parametrize("min_weighted", [0, 3])
@pytest.mark.parametrize("min_hits", [2, 5])
def test_cuda_scan_machine_matches_twin(cuda_device, order_constraint,
                                        min_weighted, min_hits):
    """B11 on the card equals its twin on a ragged batch of 400 containers
    (flags at every step, records where a step emits); one launch."""
    from kmergutsjava_tpu_torch.calls import scan_machine

    hits, offsets = _scan_batch(7 + min_hits)
    kw = dict(min_hits=min_hits, min_weighted=min_weighted, max_gap=60,
              order_constraint=order_constraint)
    cpu = [torch.from_numpy(hits), torch.from_numpy(offsets)]
    want = scan_machine.scan_containers_reference(*cpu, **kw)
    before = scan_machine.launches
    got = scan_machine.scan_containers(*(x.to(cuda_device) for x in cpu),
                                       **kw)
    torch.cuda.synchronize()
    assert scan_machine.launches == before + 1
    assert _scan_equal(got, want) > 0


@pytest.mark.cuda
def test_cuda_scan_machine_past_the_append_cap(cuda_device):
    """A container of 40,030 hits (the append cap is 39,998) and a few
    short ones: B11 equals its twin; the empty batch launches nothing."""
    from kmergutsjava_tpu_torch.calls import scan_machine

    hits, offsets = _scan_batch(3, n_cont=20, cap_container=True)
    kw = dict(min_hits=2, min_weighted=0, max_gap=200,
              order_constraint=False)
    cpu = [torch.from_numpy(hits), torch.from_numpy(offsets)]
    want = scan_machine.scan_containers_reference(*cpu, **kw)
    got = scan_machine.scan_containers(*(x.to(cuda_device) for x in cpu),
                                       **kw)
    assert _scan_equal(got, want) > 0
    before = scan_machine.launches
    empty = scan_machine.scan_containers(
        torch.zeros((0, 5), dtype=torch.int32, device=cuda_device),
        torch.zeros(1, dtype=torch.int64, device=cuda_device), **kw)
    assert scan_machine.launches == before
    assert empty[0].numel() == 0


def _scan_container(rng, n, n_fi=None, span=4000):
    """One seeded container of ``n`` position-sorted hits."""
    pos = np.sort(rng.choice(max(span, n), n, replace=False)).astype(np.int64)
    n_fi = n_fi or int(rng.integers(1, 5))
    return (pos, rng.integers(0, 5, n).astype(np.int32),
            rng.integers(0, 300, n).astype(np.int32),
            rng.integers(0, n_fi, n).astype(np.int32),
            rng.choice([0.1, 0.25, 1.0, 2.5, 1 / 3], n).astype(np.float32))


def _scan_on_card(cuda_device, containers, **kw):
    """B11 on the card against its twin on ``containers``: one launch,
    flags at every step and records at the emitting steps equal. Returns
    the twin's (flags, recs)."""
    from kmergutsjava_tpu_torch.calls import scan_machine

    hits, offsets = scan_machine.pack_containers(containers)
    cpu = [torch.from_numpy(hits), torch.from_numpy(offsets)]
    want = scan_machine.scan_containers_reference(*cpu, **kw)
    before = scan_machine.launches
    got = scan_machine.scan_containers(*(x.to(cuda_device) for x in cpu),
                                       **kw)
    torch.cuda.synchronize()
    assert scan_machine.launches == before + 1
    _scan_equal(got, want)
    return want


SCAN_KW = [dict(min_hits=2, min_weighted=0, max_gap=60,
                order_constraint=False),
           dict(min_hits=3, min_weighted=2, max_gap=200,
                order_constraint=True)]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", SCAN_KW)
def test_cuda_scan_machine_edge_lengths(cuda_device, kw):
    """B11 with containers of 0, 1, 2, 31, 32 and 33 hits, a staging chunk
    (8 hits) and one either side of it, two chunks and the ring of four,
    4,096 hits (SCAN_BIG), each beside the others in one batch, in turn
    with every length alone, and with a total whose rows end mid 16-byte
    block."""
    rng = np.random.default_rng(31)
    lens = [0, 1, 2, 31, 32, 33, 7, 8, 9, 15, 16, 17, 32, 33, 4096]
    _scan_on_card(cuda_device, [_scan_container(rng, n) for n in lens], **kw)
    for n in lens:
        _scan_on_card(cuda_device, [_scan_container(rng, n)], **kw)
    for extra in range(4):  # 5 * hits % 16: every tail of the array
        _scan_on_card(cuda_device, [_scan_container(rng, int(n)) for n in
                                    rng.integers(0, 70, 45)]
                      + [_scan_container(rng, extra + 1)], **kw)


@pytest.mark.cuda
def test_cuda_scan_machine_mixed_length_profiles(cuda_device):
    """B11 on one batch that mixes a proteome's containers (hundreds to
    thousands of hits) with a read set's (0 to 43), shuffled, so that the
    length order moves nearly every container; and with the batch order
    given instead of the length order."""
    from kmergutsjava_tpu_torch.calls import scan_machine

    rng = np.random.default_rng(32)
    lens = np.concatenate([np.minimum(rng.lognormal(5.3, 0.8, 300), 2400),
                           rng.integers(0, 44, 3000)]).astype(int)
    rng.shuffle(lens)
    cs = [_scan_container(rng, int(n), span=max(4000, 2 * int(n)))
          for n in lens]
    kw = SCAN_KW[0]
    want = _scan_on_card(cuda_device, cs, **kw)
    hits, offsets = (torch.from_numpy(x).to(cuda_device)
                     for x in scan_machine.pack_containers(cs))
    batch = torch.arange(len(cs), dtype=torch.int32, device=cuda_device)
    _scan_equal(scan_machine.scan_containers(hits, offsets, order=batch,
                                             **kw), want)


@pytest.mark.cuda
def test_cuda_scan_machine_earliest_seed_pairs(cuda_device):
    """Containers that keep a seed pair as early as the machine can (hits
    of functions X, Y, Y: the pair trigger at step 2 retains steps 1 and
    2; no retain is reachable while S_L2STEP is still its first 0), with
    hit 0 weighted apart from the others, so that a weight read from the
    wrong step shows; and later retains after gap closes. The retained
    pair's records (start step 1) must occur and equal the twin's."""
    rng = np.random.default_rng(33)
    cs = []
    for i in range(400):
        n = int(rng.integers(3, 40))
        pos = np.cumsum(rng.integers(1, 4, n)).astype(np.int64)
        if i % 3 == 0:
            pos[n // 2:] += 500  # a gap close mid-container
        fi = rng.integers(0, 3, n).astype(np.int32)
        fi[:3] = (i % 3, (i + 1) % 3, (i + 1) % 3)
        wt = rng.choice([0.25, 1.0, 1 / 3], n).astype(np.float32)
        wt[0] = 7.5
        cs.append((pos, rng.integers(0, 5, n).astype(np.int32),
                   rng.integers(0, 300, n).astype(np.int32), fi, wt))
    flags, recs = _scan_on_card(cuda_device, cs, min_hits=2, min_weighted=0,
                                max_gap=60, order_constraint=False)
    emit = (flags & 2) != 0
    assert int((recs[emit][:, 4] == 1).sum()) > 0


@pytest.mark.cuda
def test_cuda_scan_machine_refuses_bad_inputs(cuda_device):
    """On the card the wrapper raises KernelError for hits that do not
    start on a 16-byte boundary and for an order of another type, length
    or device; it launches nothing then."""
    from kmergutsjava_tpu_torch.calls import scan_machine

    rng = np.random.default_rng(34)
    hits, offsets = scan_machine.pack_containers(
        [_scan_container(rng, 10) for _ in range(6)])
    h = torch.from_numpy(hits).to(cuda_device)
    o = torch.from_numpy(offsets).to(cuda_device)
    kw = SCAN_KW[0]
    before = scan_machine.launches
    padded = torch.zeros((h.shape[0] + 1, 5), dtype=torch.int32,
                         device=cuda_device)
    padded[1:] = h
    with pytest.raises(scan_machine.KernelError):
        scan_machine.scan_containers(padded[1:], o, **kw)  # 20 B off
    good = scan_machine.length_order(o)
    for order in (good.long(), good[:5], good.cpu()):
        with pytest.raises(scan_machine.KernelError):
            scan_machine.scan_containers(h, o, order=order, **kw)
    assert scan_machine.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("aa", [True, False])
def test_cuda_scan_grouping_report_matches_cpu(cuda_device, aa, tmp_path):
    """The engine with grouping_impl="scan" on the card writes the CPU
    run's report (and the host grouping's), through one B11 launch."""
    import io

    from kmergutsjava_tpu_torch.calls import scan_machine
    from kmergutsjava_tpu_torch.config import EngineConfig
    from kmergutsjava_tpu_torch.formats.table_tools import (
        signatures_from_proteins, write_data_dir)
    from kmergutsjava_tpu_torch.models.pipeline import Engine

    rng = np.random.default_rng(21)
    alpha = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    prots = [alpha[rng.integers(0, 20, int(n))].tobytes().decode()
             for n in rng.integers(15, 200, 300)]
    d = str(tmp_path / "d")
    write_data_dir(d, signatures_from_proteins(
        [(p, i % 7, i % 11) for i, p in enumerate(prots)]),
        [f"f{i}" for i in range(7)])
    if aa:
        fasta = "".join(f">p{i}\n{p}\n" for i, p in enumerate(prots))
    else:
        dna = np.frombuffer(b"ACGT", np.uint8)
        fasta = "".join(f">c{i}\n{dna[rng.integers(0, 4, 600)].tobytes().decode()}\n"
                        for i in range(40))
    out = {}
    for dev, impl in (("cpu", "host"), ("cpu", "scan"), ("cuda", "scan")):
        buf = io.StringIO()
        before = scan_machine.launches
        Engine(EngineConfig(aa=aa, min_hits=2, grouping_impl=impl,
                            device=dev, backend="xla")).run(
            d, None, buf, stdout=True, query_stream=io.StringIO(fasta))
        assert scan_machine.launches - before == (dev == "cuda")
        out[dev, impl] = buf.getvalue()
    assert out["cuda", "scan"] == out["cpu", "scan"] == out["cpu", "host"]
    assert "CALL\t" in out["cpu", "host"] or not aa


@pytest.mark.cuda
def test_cuda_device_sort_probe_matches_unsorted(cuda_device):
    """B1 on a chunk in home order on the card (``probe_answer_sorted``:
    the sort and the un-permutation on the device) answers as the plain
    probe does in the queries' order; one B1 launch."""
    from kmergutsjava_tpu_torch.lookup.sparse import probe_answer_sorted

    fp = _plane(400_000, seed=11)
    qfp, homes = _queries(fp, 300_000, 16, seed=12)
    t = [x.to(cuda_device) for x in (_plane_t(fp, 16), torch.from_numpy(qfp),
                                     torch.from_numpy(homes))]
    want = tilejoin.probe_answer(*t, 16)
    before = tilejoin.launches
    got = probe_answer_sorted(*t, 16)
    assert tilejoin.launches == before + 1
    n = homes.size
    for a, b in zip(tilejoin.answer_views(got, n),
                    tilejoin.answer_views(want, n)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_cuda_multi_process_lookups(cuda_device, tmp_path, backend):
    """tests/test_torch_multiprocess.py's worker on the cards: four ranks
    of one card each under NCCL (the mesh's collectives on the cards), or
    two ranks sharing card 0 under gloo (staged through the host). Every
    rank's sharded (2, 2), routed 4, stream-shard 4 and sharded sparse
    probe (tilejoin-shards 4) hits are the parity scan's, each launching
    its kernels; every rank's fused-step (2, 2) hits equal the
    single-process ones, launching the fused kernel's shard entry, and the
    reports made from them equal the port's engine's single run on the
    card; and the merged engine shards are the single run's report."""
    import io

    import test_torch_multiprocess as mp

    from kmergutsjava_tpu_torch.config import EngineConfig
    from kmergutsjava_tpu_torch.models.pipeline import Engine
    from kmergutsjava_tpu_torch.parallel.multihost import merge_report_shards

    if backend == "nccl" and torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices (NCCL takes one rank a card)")
    world = 4 if backend == "nccl" else 2
    mp.write_corpus(str(tmp_path))
    outs = mp.run_ranks(str(tmp_path), world, backend, "cuda", timeout=300)
    mp.check_ranks(outs)
    for _, out in outs:  # every rank holds positions of these meshes
        for line in out.splitlines():
            if line.startswith(("MP-OK sharded", "MP-OK routed 4",
                                "MP-OK stream", "MP-OK tilejoin")):
                assert "{'B1': 0, 'B2': 0, 'B12': 0, 'B13': 0}" not in line
            if line.startswith("MP-OK spmd"):
                assert "{'fused_probe': 0}" not in line

    def port_report(workdir, query, aa):
        out = io.StringIO()
        Engine(EngineConfig(aa=aa, min_hits=2)).run(
            os.path.join(workdir, "d"), os.path.join(workdir, query), out,
            stdout=True)
        return out.getvalue()

    mp.check_spmd_reports(tmp_path, world, port_report)
    single = io.StringIO()
    Engine(EngineConfig(aa=True, min_hits=2)).run(
        str(tmp_path / "d"), str(tmp_path / "corpus.faa"), single,
        stdout=True)
    assert merge_report_shards([
        (tmp_path / f"report_{r}.txt").read_text()
        for r in range(world)]) == single.getvalue()


# the randomized differential on the card (tests/torch_soak_rounds.py's
# rounds): these seeds in the default run, the CPU soak's 400 slow seeds
# (tests/test_torch_soak.py) only under -m slow
CUDA_SOAK_SEEDS = tuple(range(10, 50))
CUDA_SOAK_SLOW_SEEDS = tuple(range(1000, 1400))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [*CUDA_SOAK_SEEDS, *(
    pytest.param(s, marks=pytest.mark.slow) for s in CUDA_SOAK_SLOW_SEEDS)])
def test_cuda_soak_round(cuda_device, seed, tmp_path, monkeypatch, request):
    """Every port run of the seed's round on the card (each backend, the
    mesh backends on positions of card 0, the grouping kernel's, the
    home-sorted and the device prepare's runs, a checkpoint run) writes
    the report of the port's parity engine on the CPU, byte for byte."""
    if (seed in CUDA_SOAK_SLOW_SEEDS
            and "slow" not in (request.config.getoption("markexpr") or "")):
        pytest.skip("the 400 slow rounds run only under -m slow")
    from torch_soak_rounds import make_round, parity_report, port_reports

    tmp = str(tmp_path)
    rng, d, fasta, kw = make_round(seed, tmp)
    base = parity_report(d, fasta, kw)
    for label, got in port_reports(seed, tmp, rng, d, fasta, kw, "cuda",
                                   monkeypatch.setenv):
        assert got == base, (f"seed {seed}: {label} diverged from the "
                             "port's parity engine on the CPU")
