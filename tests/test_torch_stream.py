"""The PyTorch package's stream probe (kmergutsjava_tpu_torch/lookup/
stream.py, on the CPU through the kernel's plain twin) against the JAX
package: the twin must give the Pallas stream kernel's packed output (run in
interpret mode, its layout converted) bit for bit, and ``StreamLookup`` /
``StreamingStreamLookup`` the hits of ``PallasStreamLookup`` and of the
parity scan ``lookup_stream``, one-shot, chunked, in several bounded-memory
passes, with channel overflow and with 8 channels. The native scatter and
decode are held against their numpy twins in the port's ``[C, S]`` layout.
The double-buffered passes (a pass on its own thread while the worker
scatters into the lookup's other set) keep the hits and their pass order,
reuse the lookup's two sets and give them back zeroed, also after a failure,
and hold no more queries than one pass and four queued chunks; the pool of
host columns the front end lends the prepare keeps and lends its buffers
by size. Exact
everywhere: offsets and hits are integers, weights are copied table
values."""
import os
import sys
import threading
import time

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
from kmergutsjava_tpu_torch.parallel.stream_shards import (
    StreamShardedLookup, make_stream_mesh, scatter_host, scatter_native)
from kmergutsjava_tpu_torch.utils import native, timing
from kmergutsjava_tpu_torch.utils.timing import record

from test_torch_kernels import (TILE_CASES, _check_tile_split,
                                _stream_inputs, _tile_case, _tile_pass)
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
    _, _, shift = scatter_host(  # the sharded lookup's host scatter
        values, np.zeros((channels, lk.slots), np.uint16),
        np.zeros(port_t.num_sigs, np.uint8), port_t.num_sigs)
    assert (shift < 0).any() and (shift == 24).any()
    s = lk._sets.take()
    _, ch = lk._scatter_into(s, values)  # the device path's channels
    assert (ch < 0).any() and (ch == channels - 1).any()
    s.zero()
    lk._sets.give_back(s)
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


def _slow_decode(monkeypatch, lk, seconds=0.25):
    """Decodes off the main thread (the pass thread's) take ``seconds``
    more, so a pass is still in flight while the worker fills the other
    set. Returns the per-pass query counts, in decode order."""
    orig = lk._decode
    decoded = []

    def slow(out, chunks, n_total, *a, **k):
        if threading.current_thread() is not threading.main_thread():
            time.sleep(seconds)
        got = orig(out, chunks, n_total, *a, **k)
        decoded.append(n_total)
        return got

    monkeypatch.setattr(lk, "_decode", slow)
    return decoded


def _feed(fronts, values, cnt, pos, n_chunks):
    """Every front end of ``fronts`` fed the same chunks, in turns."""
    for part in np.array_split(np.arange(len(values)), n_chunks):
        for s in fronts:
            s.add_batch(values[part], cnt[part], pos[part])


def _pool_back_and_zero(lk):
    """Both of the lookup's sets are free again, all zero."""
    pool = lk._sets
    assert len(pool.sets) == 2
    assert {id(s) for s in pool._free} == {id(s) for s in pool.sets}
    for s in pool.sets:
        assert not s.tiles.view(torch.int16).any() and not s.occ.any()


def _pass_bounds(n, n_chunks, flush_limit):
    """Where the passes of ``n`` queries fed in ``n_chunks`` chunks end."""
    bounds, since = [0], 0
    for part in np.array_split(np.arange(n), n_chunks):
        since += len(part)
        if since >= flush_limit:
            bounds.append(int(part[-1]) + 1)
            since = 0
    return bounds + ([n] if bounds[-1] < n else [])


@pytest.mark.parametrize("n_chunks", [8, 9])   # 9: a tail pass at finish
@pytest.mark.parametrize("kmers_found", [True, False])
def test_streaming_double_buffered_passes(monkeypatch, kmers_found,
                                          n_chunks):
    """Several passes, each decoded slowly on the pass thread while the
    worker scatters into the other set: the hits equal the one-shot lookup
    of each pass's queries, concatenated in pass order, the one-shot
    lookup's and the parity scan's; the kmers-found union holds across
    passes."""
    jax_t, port_t, kmers = _tables(1500, seed=43, load_factor=0.8)
    values, cnt, pos = _queries(kmers, 4000, seed=44)
    values[::4] = values[0]
    lk = StreamLookup(port_t, device="cpu")
    want = lk.lookup(values, cnt, pos, compute_kmers_found=kmers_found)
    bounds = _pass_bounds(len(values), n_chunks, 800)
    in_order = [lk.lookup(values[a:b], cnt[a:b], pos[a:b])
                for a, b in zip(bounds, bounds[1:])]
    decoded = _slow_decode(monkeypatch, lk)
    with record("t.root"):
        s = StreamingStreamLookup(lk, compute_kmers_found=kmers_found,
                                  flush_limit=800)
        _feed([s], values, cnt, pos, n_chunks)
        got = s.finish()
        s.close()
    counters = timing.recent_runs()[-1]["counters"]
    assert s.passes == len(in_order) >= 4
    assert sorted(decoded) == sorted(np.diff(bounds).tolist())
    assert counters["stream.overlap_queries"] > 0
    assert counters["stream.fresh_sets"] == 0
    _same(got, want)
    par = lookup_stream(jax_t, values, cnt, pos)
    for a, b in zip(_canon(got), _canon(par)):
        np.testing.assert_array_equal(a, b)
    assert got.kmers_found == (par.kmers_found if kmers_found else -1)
    for col in ("cnt_id", "pos", "otu", "avg_from_end", "fi", "wt"):
        np.testing.assert_array_equal(
            getattr(got, col),
            np.concatenate([getattr(h, col) for h in in_order]))
    _pool_back_and_zero(lk)


def test_front_ends_in_a_row_reuse_the_two_sets(monkeypatch):
    """Two front ends one after another run every pass on the lookup's
    own two sets (the same buffers), and give both back all zero by the
    end of finish(), before close()."""
    _, port_t, kmers = _tables(1200, seed=45, load_factor=0.7)
    values, cnt, pos = _queries(kmers, 3000, seed=46)
    lk = StreamLookup(port_t, device="cpu")
    want = lk.lookup(values, cnt, pos)
    pool_tiles = {s.tiles.data_ptr() for s in lk._sets.sets}
    orig, used = lk._pass, []

    def spy(s, chunks, queries):
        used.append(s.tiles.data_ptr())
        return orig(s, chunks, queries)

    monkeypatch.setattr(lk, "_pass", spy)
    for _ in range(2):
        used.clear()
        s = StreamingStreamLookup(lk, compute_kmers_found=True,
                                  flush_limit=1000)
        _feed([s], values, cnt, pos, 6)
        _same(s.finish(), want)
        _pool_back_and_zero(lk)
        s.close()
        assert s.passes == 3 and set(used) == pool_tiles
        _pool_back_and_zero(lk)


def test_two_live_front_ends_stay_exact():
    """Two front ends fed in turns hold a set each; the first one's second
    set is a fresh one, counted (the other's is fresh too, or the first's
    once it is zeroed), and both stay exact."""
    _, port_t, kmers = _tables(1200, seed=47, load_factor=0.7)
    values, cnt, pos = _queries(kmers, 3000, seed=48)
    lk = StreamLookup(port_t, device="cpu")
    want = lk.lookup(values, cnt, pos)
    with record("t.root"):
        fronts = [StreamingStreamLookup(lk, compute_kmers_found=True,
                                        flush_limit=1000) for _ in range(2)]
        _feed(fronts, values, cnt, pos, 6)
        got = [s.finish() for s in fronts]
        for s in fronts:
            s.close()
    for g in got:
        _same(g, want)
    assert timing.recent_runs()[-1]["counters"]["stream.fresh_sets"] in (
        1, 2)
    _pool_back_and_zero(lk)


@pytest.mark.parametrize("where", ["worker", "pass"])
def test_streaming_error_gives_the_sets_back(monkeypatch, where):
    """A failure in the worker's scatter or in a pass on the pass thread
    surfaces by finish(), and the lookup gets both sets back, zeroed."""
    _, port_t, kmers = _tables(800, seed=49, load_factor=0.6)
    lk = StreamLookup(port_t, device="cpu")
    name = "_scatter_into" if where == "worker" else "_decode"
    orig, calls = getattr(lk, name), []

    def broken(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError(f"{where} broke")
        return orig(*a, **k)

    monkeypatch.setattr(lk, name, broken)
    s = StreamingStreamLookup(lk, flush_limit=100)
    values, cnt, pos = _queries(kmers, 600, seed=50)
    with pytest.raises(RuntimeError, match=f"{where} broke"):
        _feed([s], values, cnt, pos, 6)
        s.finish()
    s.close()
    assert not s._passer.is_alive() and s._worker is None
    _pool_back_and_zero(lk)


def test_streaming_holds_no_more_than_a_pass_and_four_chunks(monkeypatch):
    """With every pass decoded slowly, the queries fed and not yet decoded
    never pass the largest pass plus the feed's four chunks (what the
    front end held when the pass ran on its worker), though chunks are
    scattered beside the passes. The threads switch often."""
    _, port_t, kmers = _tables(1500, seed=51, load_factor=0.7)
    values, cnt, pos = _queries(kmers, 6000, seed=52)
    lk = StreamLookup(port_t, device="cpu")
    decoded = _slow_decode(monkeypatch, lk, seconds=0.15)
    chunk, fed, peak = 200, 0, 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with record("t.root"):
            s = StreamingStreamLookup(lk, flush_limit=700)
            for a in range(0, len(values), chunk):
                s.add_batch(values[a:a + chunk], cnt[a:a + chunk],
                            pos[a:a + chunk])
                fed += len(values[a:a + chunk])
                peak = max(peak, fed - sum(decoded))
            s.finish()
            s.close()
    finally:
        sys.setswitchinterval(old)
    assert s.passes >= 7
    assert timing.recent_runs()[-1]["counters"][
        "stream.overlap_queries"] > 0
    assert max(decoded) + s.FEED_CHUNKS * chunk >= peak > max(decoded)


def test_column_pool_lends_the_smallest_fit_and_keeps_the_largest():
    """The pool's buffers are three int64 columns of a power-of-two
    capacity; a chunk takes the smallest free buffer that holds it, else a
    fresh one (counted); only the ``KEEP`` largest free ones are kept."""
    pool = stream.ColumnPool(pinned=False)
    with record("t.root"):
        small, big = pool.take(100), pool.take(1000)
        assert [len(c) for c in small] == [128] * 3
        assert [c.dtype for c in big] == [np.int64] * 3
        assert len(big[0]) == 1024 and len(pool.take(1)[0]) == 2
        pool.give_back([big, None, small])
        assert pool.take(50) is small and pool.take(128) is big
        huge = pool.take(2000)
        assert len(huge[0]) == 2048
        tiny = [pool.take(3) for _ in range(pool.KEEP)]
        pool.give_back([small, huge, big, *tiny])
        assert len(pool._free) == pool.KEEP  # three of the tiny dropped
        got = [pool.take(10) for _ in range(3)]
        assert got[0] is small and got[1] is big and got[2] is huge
        assert any(pool.take(3) is t for t in tiny)
    counters = timing.recent_runs()[-1]["counters"]
    assert counters["stream.fresh_columns"] == 4 + pool.KEEP


def test_column_pool_never_lends_a_buffer_twice_under_contention():
    """More threads than cores taking and giving back columns, switching
    often: no buffer is ever out to two takers at once, and every one
    comes back."""
    pool = stream.ColumnPool(pinned=False)
    out, lock, errors = set(), threading.Lock(), []
    threads, each = 4 * (os.cpu_count() or 1), 200

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(each):
            buf = pool.take(int(rng.integers(1, 5000)))
            with lock:
                if id(buf) in out:
                    errors.append("lent twice")
                out.add(id(buf))
            buf[0][:1] = seed
            with lock:
                out.discard(id(buf))
            pool.give_back([buf])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker, args=(i,))
              for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert errors == [] and out == set()
    assert 0 < len(pool._free) <= pool.KEEP


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
    # the device path's numpy emit over passes of two chunks: the hits of
    # emit_hits_at in the same order
    s = StreamingStreamLookup(lk, compute_kmers_found=True, flush_limit=3000)
    for part in np.array_split(np.arange(len(values)), 5):
        s.add_batch(values[part], cnt[part], pos[part])
    c = s.finish()
    s.close()
    assert c.kmers_found == b.kmers_found
    for col in ("cnt_id", "pos", "otu", "avg_from_end", "fi", "wt"):
        np.testing.assert_array_equal(getattr(c, col), getattr(b, col))



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
    tiles = np.zeros((lk.channels, lk.slots), np.uint16)
    homes, flat, shift = scatter_native(
        lib, values, tiles, np.zeros(port_t.num_sigs, np.uint8),
        port_t.num_sigs)
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
    lk = StreamShardedLookup(port_t, make_stream_mesh(1, [torch.device(
        "cpu")]))
    n = 20000
    values, cnt, pos = _queries(kmers, n, seed=30)
    s = lk._sets.take()
    homes, flat, shift = scatter_native(lib, values, s.tiles, s.occ,
                                        port_t.num_sigs)
    shift[::11] = -1
    rng = np.random.default_rng(31)
    out = rng.integers(0, 2**31, (lk.channels // 4, lk.slots),
                       dtype=np.int64).astype(np.int32)
    chunk = [(values, cnt, pos, homes, flat, shift)]
    a, av = lk._decode(out, chunk, n, None, True, want_values=True)
    b, bv = lk._decode_numpy(out, chunk)
    assert len(a) > 0
    b.kmers_found = int(np.unique(bv).size)
    _same(a, b)
    np.testing.assert_array_equal(np.sort(av), np.sort(bv))


@pytest.mark.parametrize("case", TILE_CASES)
def test_device_stage_twins_match_native_scatter_and_resolve(case):
    """The device path's scatter and resolve twins against the host path's
    native ``scatter_chunk`` and ``resolve_slots`` on the same chunks of one
    pass: the twin's split is valid (another one than the native scatter's)
    and every query resolves to the native decode's slot; the counts are
    the overflow and fallback queries and the hits."""
    lib = native.load_scatter()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    table, chunks = _tile_case(case, seed=TILE_CASES.index(case) + 70)
    values = np.concatenate(chunks)
    lk = StreamLookup(table, device="cpu")
    chans, tiles, occ, _, slots, counts = _tile_pass(lk, chunks)
    _check_tile_split(values, tiles.numpy(), occ.numpy(), chans.numpy(),
                      table.num_sigs)
    host_tiles = np.zeros((lk.channels, lk.slots), dtype=np.uint16)
    host_occ = np.zeros(table.num_sigs, dtype=np.uint8)
    parts = [scatter_host(c, host_tiles, host_occ, table.num_sigs)
             for c in chunks]
    out = stream.stream_probe(lk.fp, torch.from_numpy(host_tiles), lk.w,
                              lk.channels).numpy().reshape(-1)
    want = []
    for c, (h, fl, sh) in zip(chunks, parts):
        got = np.empty(len(c), dtype=np.int64)
        lib.resolve_slots(c, h, fl, sh, len(c), out, lk.fe_plane,
                          lk._exact.host_kmer, len(lk._exact.host_kmer),
                          lk.w, lk._exact.full_window, got)
        want.append(got)
    want = np.concatenate(want)
    np.testing.assert_array_equal(slots.numpy(), want)
    over = int((chans < 0).sum())
    assert counts.tolist()[0] == over
    assert counts.tolist()[2] == int((want >= 0).sum()) > 0
    assert over <= counts.tolist()[1] <= len(values)
    if case == "crowded":
        assert over > 0
    if case == "collisions":
        assert counts[1] > 0
