"""The PyTorch package's stream probe (kmergutsjava_tpu_torch/lookup/
stream.py, on the CPU through the kernel's plain twin) against the JAX
package: the twin must give the Pallas stream kernel's packed output (run in
interpret mode, its layout converted) bit for bit, and ``StreamLookup`` /
``StreamingStreamLookup`` the hits of ``PallasStreamLookup`` and of the
parity scan ``lookup_stream``, one-shot, chunked, in several bounded-memory
passes, with channel overflow and with 8 channels. The native scatter and
decode are held against their numpy twins in the port's ``[C, S]`` layout.
Exact everywhere: offsets and hits are integers, weights are copied table
values."""
import numpy as np
import pytest
import torch

from kmergutsjava_tpu.lookup.pallas_stream import (BLOCK, HALO, ROWS,
                                                   PallasStreamLookup,
                                                   stream_probe_blocks)
from kmergutsjava_tpu.lookup.parity import lookup_stream
from kmergutsjava_tpu_torch.lookup import stream
from kmergutsjava_tpu_torch.lookup.stream import (StreamingStreamLookup,
                                                  StreamLookup)
from kmergutsjava_tpu_torch.utils import native

from test_torch_kernels import _stream_inputs
from test_torch_lookup import _queries, _tables


@pytest.mark.parametrize("w,channels", [(8, 4), (24, 4), (64, 4), (8, 8),
                                        (24, 8), (64, 8)])
def test_twin_matches_pallas_stream_interpret(w, channels):
    """Two superblocks of the TPU layout: overlapped [nsuper, ROWS,
    BLOCK + HALO] plane rows, [nsuper, C, ROWS, BLOCK] tiles and output."""
    nsuper = 2
    n_slots = nsuper * ROWS * BLOCK
    fp, tiles = _stream_inputs(n_slots, w, channels, seed=w * channels)
    got = stream.stream_probe(fp, tiles, w, channels)
    flat = np.concatenate([fp.numpy(),
                           np.full(HALO - w, 65535, np.uint16)])
    fp_blocks = np.ascontiguousarray(np.lib.stride_tricks.as_strided(
        flat, shape=(nsuper * ROWS, BLOCK + HALO), strides=(2 * BLOCK, 2)))
    qt = tiles.numpy().reshape(channels, nsuper, ROWS, BLOCK)
    out = stream_probe_blocks(
        fp_blocks.reshape(nsuper, ROWS, BLOCK + HALO),
        np.ascontiguousarray(qt.transpose(1, 0, 2, 3)), nsuper, w, channels,
        interpret=True, form="i32")
    want = np.asarray(out).transpose(1, 0, 2, 3).reshape(channels // 4, -1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and (want != want[0, 0]).any()


def _canon(hits):
    order = np.lexsort((hits.wt, hits.fi, hits.otu, hits.pos, hits.cnt_id))
    return [np.asarray(c)[order] for c in
            (hits.cnt_id, hits.pos, hits.otu, hits.avg_from_end, hits.fi,
             hits.wt)]


def _same(got, want):
    """Hit multisets (the stream decode's order is not the sparse one's)."""
    assert len(got) == len(want)
    for a, b in zip(_canon(got), _canon(want)):
        np.testing.assert_array_equal(a, b)
    assert got.kmers_found == want.kmers_found


@pytest.mark.parametrize("seed,load,nq", [(0, 0.6, 3000), (1, 0.9, 6000)])
def test_stream_lookup_matches_jax_and_parity(seed, load, nq):
    jax_t, port_t, kmers = _tables(3000, seed=seed, load_factor=load)
    values, cnt, pos = _queries(kmers, nq, seed=seed + 50)
    lk = StreamLookup(port_t, device="cpu")
    jlk = PallasStreamLookup(jax_t, form="i32")
    assert lk.w == jlk.w
    np.testing.assert_array_equal(lk.fe_plane[:port_t.num_sigs],
                                  jlk.fe_plane[:jax_t.num_sigs])
    got = lk.lookup(values, cnt, pos)
    assert len(got) > 0
    _same(got, jlk.lookup(values, cnt, pos))
    _same(got, lookup_stream(jax_t, values, cnt, pos))


def test_stream_dense_queries():
    """Every signature queried once: the kernel's own regime."""
    jax_t, port_t, kmers = _tables(5000, seed=7, load_factor=0.6)
    z = np.zeros(len(kmers), np.int64)
    p = np.arange(len(kmers), dtype=np.int64)
    got = StreamLookup(port_t, device="cpu").lookup(kmers, z, p)
    assert len(got) == len(kmers)
    _same(got, lookup_stream(jax_t, kmers, z, p))


@pytest.mark.parametrize("channels", [4, 8])
def test_stream_channel_overflow(channels):
    """Many distinct values share home slots: ranks beyond C take the exact
    fallback; 8 channels use both packed output planes."""
    jax_t, port_t, kmers = _tables(2000, seed=11, load_factor=0.6)
    rng = np.random.default_rng(12)
    base = kmers[:40]
    values = np.concatenate([
        np.repeat(base, 6),
        (base[:, None] + np.int64(port_t.num_sigs)
         * np.arange(1, 11)).reshape(-1),       # same homes, other values
        rng.integers(0, 10**9, 500, dtype=np.int64), kmers])
    rng.shuffle(values)
    cnt = np.arange(len(values), dtype=np.int64) % 9
    pos = np.arange(len(values), dtype=np.int64)
    lk = StreamLookup(port_t, device="cpu", channels=channels)
    _, _, _, shift = lk._scatter(values)
    assert (shift < 0).any() and (shift == 24).any()
    got = lk.lookup(values, cnt, pos)
    _same(got, lookup_stream(jax_t, values, cnt, pos))
    _same(got, PallasStreamLookup(jax_t, channels=channels,
                                  form="i32").lookup(values, cnt, pos))


def test_stream_empty_input():
    _, port_t, _ = _tables(100, seed=3, load_factor=0.6)
    z = np.zeros(0, dtype=np.int64)
    assert len(StreamLookup(port_t, device="cpu").lookup(z, z, z)) == 0
    s = StreamingStreamLookup(StreamLookup(port_t, device="cpu"))
    assert len(s.finish()) == 0 and s.passes == 0
    assert len(s.partial_hits()) == 0


def test_non_pow2_probe_window():
    """w rounds max_probe up to a multiple of 8, not a power of two."""
    jax_t, port_t, kmers = _tables(30000, seed=7, load_factor=0.9)
    lk = StreamLookup(port_t, device="cpu")
    assert 16 < port_t.max_probe <= 64
    assert lk.w % 8 == 0 and port_t.max_probe <= lk.w < port_t.max_probe + 8
    values, cnt, pos = _queries(kmers, 30000, seed=8)
    _same(lk.lookup(values, cnt, pos), lookup_stream(jax_t, values, cnt, pos))


def test_window_over_64_is_a_value_error():
    from types import SimpleNamespace

    fake = SimpleNamespace(max_probe=65, num_sigs=1000)
    with pytest.raises(ValueError, match="64"):
        StreamLookup(fake, device="cpu")


@pytest.mark.parametrize("n_chunks", [1, 7, 23])
def test_streaming_matches_oneshot_and_jax(n_chunks):
    """Chunk-by-chunk tile accumulation equals the one-shot scatter: the
    occupancy counter carries collision ranks across chunks."""
    from kmergutsjava_tpu.lookup.pallas_stream import \
        StreamingStreamLookup as JaxStreaming

    jax_t, port_t, kmers = _tables(2000, seed=n_chunks, load_factor=0.8)
    values, cnt, pos = _queries(kmers, 9000, seed=n_chunks + 1)
    values[::5] = values[0]  # cross-chunk duplicates of one home
    lk = StreamLookup(port_t, device="cpu")
    a = lk.lookup(values, cnt, pos)
    s = StreamingStreamLookup(lk, compute_kmers_found=True)
    js = JaxStreaming(PallasStreamLookup(jax_t, form="i32"),
                      compute_kmers_found=True)
    for part in np.array_split(np.arange(len(values)), n_chunks):
        s.add_batch(values[part], cnt[part], pos[part])
        js.add_batch(values[part], cnt[part], pos[part])
    b = s.finish()
    assert s.passes == 1
    _same(b, a)
    _same(b, js.finish())


@pytest.mark.parametrize("flush_limit,n_chunks",
                         [(500, 7), (1, 5), (10**9, 3), (1000, 4),
                          (1500, 3)])
def test_streaming_multipass_matches_oneshot(flush_limit, n_chunks):
    """Bounded memory, one plane pass per flush_limit queries: the hits and
    the cross-pass kmers-found union match the one-shot path, with
    duplicates that span passes (their dedup state resets with the
    tiles)."""
    jax_t, port_t, kmers = _tables(1500, seed=41, load_factor=0.8)
    values, cnt, pos = _queries(kmers, 4000, seed=42)
    values[::4] = values[0]
    lk = StreamLookup(port_t, device="cpu")
    s = StreamingStreamLookup(lk, compute_kmers_found=True,
                              flush_limit=flush_limit)
    want_passes, since = 0, 0
    for part in np.array_split(np.arange(len(values)), n_chunks):
        s.add_batch(values[part], cnt[part], pos[part])
        since += len(part)
        if since >= flush_limit:  # a pass over everything fed so far
            want_passes, since = want_passes + 1, 0
    b = s.finish()
    _same(b, lk.lookup(values, cnt, pos))
    _same(b, lookup_stream(jax_t, values, cnt, pos))
    assert s.passes == want_passes + (since > 0)  # and one for the tail


def test_streaming_worker_error_surfaces_at_finish(monkeypatch):
    _, port_t, kmers = _tables(800, seed=5, load_factor=0.6)
    lk = StreamLookup(port_t, device="cpu")

    def broken(tiles):
        raise stream.KernelError("launch refused")

    monkeypatch.setattr(lk, "_probe", broken)
    s = StreamingStreamLookup(lk, flush_limit=100)
    values, cnt, pos = _queries(kmers, 600, seed=6)
    with pytest.raises(stream.KernelError, match="launch refused"):
        for part in np.array_split(np.arange(len(values)), 6):
            s.add_batch(values[part], cnt[part], pos[part])
        s.finish()


def _no_native(monkeypatch):
    monkeypatch.setattr(native, "load_scatter", lambda: None)


@pytest.mark.parametrize("seed,load", [(0, 0.6), (1, 0.9)])
def test_native_scatter_and_decode_match_numpy(monkeypatch, seed, load):
    if native.load_scatter() is None:
        pytest.skip("native toolchain unavailable")
    jax_t, port_t, kmers = _tables(3000, seed=seed + 60, load_factor=load)
    values, cnt, pos = _queries(kmers, 8000, seed=seed + 61)
    values[::7] = values[0]  # heavy duplication
    lk = StreamLookup(port_t, device="cpu")
    a = lk.lookup(values, cnt, pos)
    s = StreamingStreamLookup(lk, compute_kmers_found=True, flush_limit=3000)
    for part in np.array_split(np.arange(len(values)), 5):
        s.add_batch(values[part], cnt[part], pos[part])
    b = s.finish()
    _no_native(monkeypatch)
    _same(a, lk.lookup(values, cnt, pos))
    _same(b, a)
    _same(a, lookup_stream(jax_t, values, cnt, pos))


def test_native_scatter_layout_invariants():
    """In the rows=1, block=S layout a placed query's flat index and shift
    name its home slot and a tile cell holding its fingerprint; duplicates
    share a cell; a home never takes more than C cells."""
    lib = native.load_scatter()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    _, port_t, kmers = _tables(1500, seed=17, load_factor=0.6)
    lk = StreamLookup(port_t, device="cpu")
    values, _, _ = _queries(kmers, 5000, seed=18)
    values[::3] = values[2]
    tiles, homes, flat, shift = lk._scatter_native(lib, values)
    assert tiles.shape == (lk.channels, lk.slots)
    assert lk.slots % stream.SLOT_ALIGN == 0 and lk.slots >= port_t.num_sigs
    np.testing.assert_array_equal(homes, values % port_t.num_sigs)
    ok = shift >= 0
    np.testing.assert_array_equal(flat[ok] % lk.slots, homes[ok])
    ch = 4 * (flat[ok] // lk.slots) + shift[ok] // 8
    np.testing.assert_array_equal(tiles[ch, homes[ok]],
                                  (values[ok] % 65535).astype(np.uint16))
    dup = ok & (values == values[2])
    assert len(set(zip(flat[dup].tolist(), shift[dup].tolist()))) == 1
    cells = {}
    for h, f, s_ in zip(homes[ok].tolist(), flat[ok].tolist(),
                        shift[ok].tolist()):
        cells.setdefault(h, set()).add((f, s_))
    assert max(len(c) for c in cells.values()) <= lk.channels


def test_native_decode_matches_numpy_on_random_output(monkeypatch):
    """Random packed bytes drive every decode branch (failed verification,
    stop-at-empty, fallback windows, overflow); the native and numpy
    decodes give the same hits."""
    lib = native.load_scatter()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    _, port_t, kmers = _tables(20000, seed=29, load_factor=0.9)
    lk = StreamLookup(port_t, device="cpu")
    n = 20000
    values, cnt, pos = _queries(kmers, n, seed=30)
    _, homes, flat, shift = lk._scatter_native(lib, values)
    shift[::11] = -1
    rng = np.random.default_rng(31)
    out = rng.integers(0, 2**31, (lk.channels // 4, lk.slots),
                       dtype=np.int64).astype(np.int32)
    chunk = [(values, cnt, pos, homes, flat, shift)]
    a, av = lk._decode(out, chunk, n, None, True, want_values=True)
    b, bv = lk._decode_numpy(out, chunk, n, None, True, want_values=True)
    assert len(a) > 0
    _same(a, b)
    np.testing.assert_array_equal(np.sort(av), np.sort(bv))
