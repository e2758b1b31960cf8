"""The PyTorch package's sparse lookup (kmergutsjava_tpu_torch/lookup/
sparse.py, on the CPU through the kernel's plain twin) against the JAX
package: the parity scan ``lookup_stream`` and ``XlaLookup`` with the
tile-join probe in interpret mode must give identical hit columns, one-shot
and through the streaming front end. Exact: hits are integers and the
weights are copied table values."""
from types import SimpleNamespace

import numpy as np
import pytest

from kmergutsjava_tpu.constants import MAX_ENCODED
from kmergutsjava_tpu.formats.kmer_table import build_table
from kmergutsjava_tpu.lookup.parity import lookup_stream
from kmergutsjava_tpu.lookup.xla import StreamingLookup as JaxStreaming
from kmergutsjava_tpu.lookup.xla import XlaLookup
from kmergutsjava_tpu_torch.formats.kmer_table import \
    build_table as port_build_table
from kmergutsjava_tpu_torch.lookup import tilejoin
from kmergutsjava_tpu_torch.lookup.sparse import (SparseLookup,
                                                  StreamingLookup)


def _signatures(n_sigs, seed):
    rng = np.random.default_rng(seed)
    kmers = rng.choice(MAX_ENCODED, size=n_sigs, replace=False).astype(
        np.int64)
    return dict(kmers=kmers,
                otu=rng.integers(0, 100, n_sigs).astype(np.int32),
                avg_from_end=rng.integers(0, 500, n_sigs).astype(np.int32),
                fi=rng.integers(0, 50, n_sigs).astype(np.int32),
                wt=rng.random(n_sigs).astype(np.float32))


def _tables(n_sigs, seed, load_factor):
    """The same signatures built by both packages (byte-identical slots)."""
    sig = _signatures(n_sigs, seed)
    jax_t = build_table(**sig, load_factor=load_factor)
    port_t = port_build_table(**sig, load_factor=load_factor)
    assert jax_t.slots.tobytes() == port_t.slots.tobytes()
    return jax_t, port_t, sig["kmers"]


def _queries(kmers, n, seed, zipf=False):
    rng = np.random.default_rng(seed)
    if zipf:
        # heavy repeats of a few signatures: skewed homes
        hit = kmers[(rng.zipf(1.3, n // 2) - 1) % len(kmers)]
    else:
        hit = rng.choice(kmers, size=n // 2)
    miss = rng.integers(0, MAX_ENCODED, size=n - n // 2, dtype=np.int64)
    v = np.concatenate([hit, miss])
    rng.shuffle(v)
    return (v, rng.integers(0, 9, n).astype(np.int64),
            np.arange(n, dtype=np.int64))


def _cols(hits):
    order = np.lexsort((hits.pos, hits.cnt_id))
    return [np.asarray(c)[order] for c in
            (hits.cnt_id, hits.pos, hits.otu, hits.avg_from_end, hits.fi,
             hits.wt)]


def _port_lookup(lk, values, cnt, pos):
    """The port's lookup of one query batch through its streaming front
    end (the only way the engine drives it)."""
    st = StreamingLookup(lk, compute_kmers_found=True)
    st.add_batch(values, cnt, pos)
    return st.finish()


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(_cols(got), _cols(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.kmers_found == want.kmers_found


@pytest.mark.parametrize("load_factor,zipf", [(0.5, False), (0.8, False),
                                              (0.6, True)])
def test_sparse_lookup_matches_jax(load_factor, zipf):
    jax_t, port_t, kmers = _tables(4000, seed=3, load_factor=load_factor)
    values, cnt, pos = _queries(kmers, 3000, seed=11, zipf=zipf)
    lk = SparseLookup(port_t, chunk=1024, device="cpu")
    got = _port_lookup(lk, values, cnt, pos)
    assert len(got) > 0
    _assert_same(got, lookup_stream(jax_t, values, cnt, pos))
    jlk = XlaLookup(jax_t, probe_impl="tilejoin")
    assert (lk.w1, lk.full_window) == (jlk.w1, jlk.full_window)
    _assert_same(got, jlk.lookup(values, cnt, pos))


def test_streaming_front_end_matches_jax():
    jax_t, port_t, kmers = _tables(2500, seed=5, load_factor=0.7)
    values, cnt, pos = _queries(kmers, 9000, seed=6)
    st = StreamingLookup(SparseLookup(port_t, chunk=512, device="cpu"),
                         compute_kmers_found=True)
    jst = JaxStreaming(XlaLookup(jax_t, chunk=512),
                       compute_kmers_found=True)
    rng = np.random.default_rng(7)
    i = 0
    while i < len(values):  # ragged pieces, several dispatches
        j = min(len(values), i + int(rng.integers(1, 700)))
        st.add_batch(values[i:j], cnt[i:j], pos[i:j])
        jst.add_batch(values[i:j], cnt[i:j], pos[i:j])
        i = j
    got = st.finish()
    _assert_same(got, jst.finish())
    _assert_same(got, lookup_stream(jax_t, values, cnt, pos))


@pytest.mark.parametrize("n", [2, 1001, 3000])
def test_packed_dispatch_and_read_back_match_parity(n, monkeypatch):
    """dispatch_probe sends homes and fingerprints up as one host buffer
    and resolve_probe reads the probe's one answer buffer back in one copy:
    its (off, state) are the twin's on separate tensors, and
    SparseLookup.lookup and StreamingLookup give the port's parity
    backend's hits."""
    import torch

    from kmergutsjava_tpu_torch.lookup.parity import \
        lookup_stream as port_parity

    _, port_t, kmers = _tables(3000, seed=30, load_factor=0.7)
    values, cnt, pos = _queries(kmers, n, seed=31)
    lk = SparseLookup(port_t, chunk=512, device="cpu")
    homes = (values % port_t.num_sigs).astype(np.int32)
    q_fp = (values % 65535).astype(np.uint16)
    copies = {"up": 0, "down": 0}
    from_numpy, cpu = torch.from_numpy, torch.Tensor.cpu

    def up(a):
        copies["up"] += 1
        return from_numpy(a)

    def down(t, *args, **kwargs):
        copies["down"] += 1
        return cpu(t, *args, **kwargs)

    monkeypatch.setattr(torch, "from_numpy", up)
    monkeypatch.setattr(torch.Tensor, "cpu", down)
    off, state = lk.resolve_probe(lk.dispatch_probe(q_fp, homes))
    assert copies == {"up": 1, "down": 1}
    monkeypatch.undo()
    want = tilejoin.first_event_reference(lk.fp, torch.from_numpy(q_fp),
                                          torch.from_numpy(homes), lk.w1)
    np.testing.assert_array_equal(off, want[0].numpy())
    np.testing.assert_array_equal(state, want[1].numpy())
    parity = port_parity(port_t, values, cnt, pos)
    assert len(parity) > 0
    _assert_same(lk.lookup(values, cnt, pos), parity)
    _assert_same(_port_lookup(lk, values, cnt, pos), parity)


def test_from_numpy_takes_a_jax_lookups_arrays():
    """SparseLookup.from_numpy on a JAX XlaLookup's w1, full_window,
    host_kmer and unpadded fingerprint plane computes what the port's own
    table-built lookup computes."""
    jax_t, port_t, kmers = _tables(6000, seed=8, load_factor=0.75)
    jlk = XlaLookup(jax_t, probe_impl="rows1")
    s = jax_t.num_sigs
    # the overlapped rows1 plane: row r holds slots [r*stride, +128)
    fp_flat = np.asarray(jlk.tbl_fp)[:, :jlk.stride].reshape(-1)[:s]
    lk_np = SparseLookup.from_numpy(port_t, fp_flat, jlk.host_kmer, jlk.w1,
                                    jlk.full_window, "cpu")
    lk = SparseLookup(port_t, device="cpu")
    assert (lk.w1, lk.full_window) == (lk_np.w1, lk_np.full_window)
    values, cnt, pos = _queries(kmers, 4000, seed=9)
    homes = (values % s).astype(np.int32)
    q_fp = (values % 65535).astype(np.uint16)
    a = lk.resolve_probe(lk.dispatch_probe(q_fp, homes))
    b = lk_np.resolve_probe(lk_np.dispatch_probe(q_fp, homes))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    _assert_same(_port_lookup(lk_np, values, cnt, pos),
                 jlk.lookup(values, cnt, pos))


def test_oneshot_lookup_and_progress_match_jax():
    """SparseLookup.lookup (the engine's xla backend on buffered queries),
    in several dispatches, gives XlaLookup.lookup's hits and progress
    lines; the host half alone builds the same k-mer column and window and
    holds no device plane."""
    from kmergutsjava_tpu.utils.timing import ProgressReporter as JaxProgress
    from kmergutsjava_tpu_torch.lookup.sparse import HostWindow
    from kmergutsjava_tpu_torch.utils.timing import ProgressReporter

    jax_t, port_t, kmers = _tables(5000, seed=19, load_factor=0.75)
    values, cnt, pos = _queries(kmers, 6000, seed=20)
    lk = SparseLookup(port_t, chunk=1000, device="cpu")
    jlk = XlaLookup(jax_t, chunk=1000)
    lines, jlines = [], []
    got = lk.lookup(values, cnt, pos, ProgressReporter(6000, lines.append))
    want = jlk.lookup(values, cnt, pos, JaxProgress(6000, jlines.append))
    _assert_same(got, want)
    _assert_same(got, lookup_stream(jax_t, values, cnt, pos))

    def masked(ls):
        return [l.split(", time=")[0] + l.split(" ms.")[1] for l in ls]

    assert len(lines) == 6 and masked(lines) == masked(jlines)
    host = HostWindow(port_t)
    assert host.full_window == lk.full_window
    np.testing.assert_array_equal(host.host_kmer, lk.host_kmer)
    assert not hasattr(host, "fp")
    z = np.zeros(0, np.int64)
    assert len(lk.lookup(z, z, z)) == 0


def test_verify_emit_matches_jax_native_and_numpy(monkeypatch):
    """The verify/compact stage on an adversarial (off, state) mix: the
    port's native and numpy paths and the JAX package's agree."""
    from kmergutsjava_tpu_torch.utils import native

    if native.load_scatter() is None:
        pytest.skip("native toolchain unavailable")
    jax_t, port_t, kmers = _tables(20_000, seed=10, load_factor=0.75)
    lk = SparseLookup(port_t, device="cpu")
    jlk = XlaLookup(jax_t, probe_impl="rows1")
    rng = np.random.default_rng(12)
    n = 10_000
    values, cnt, pos = _queries(kmers, n, seed=13)
    homes = (values % port_t.num_sigs).astype(np.int32)
    state = rng.choice(np.array([0, 1, 2], np.uint8), n, p=[0.1, 0.5, 0.4])
    off = rng.integers(0, lk.w1, n).astype(np.uint8)
    want = jlk._verify_emit(values, homes, off, state, cnt, pos, True)
    got = lk._verify_emit(values, homes, off, state, cnt, pos, True)
    monkeypatch.setattr(native, "load_scatter", lambda: None)
    got_np = lk._verify_emit(values, homes, off, state, cnt, pos, True)
    for res in (got, got_np):
        for a, b in zip(res[0], want[0]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(res[1], want[1])


def test_worker_error_surfaces_at_finish(monkeypatch):
    _, port_t, kmers = _tables(1000, seed=14, load_factor=0.6)
    lk = SparseLookup(port_t, chunk=256, device="cpu")

    def broken(q_fp, homes):
        raise tilejoin.KernelError("launch refused")

    monkeypatch.setattr(lk, "dispatch_probe", broken)
    st = StreamingLookup(lk)
    values, cnt, pos = _queries(kmers, 600, seed=15)
    with pytest.raises(tilejoin.KernelError, match="launch refused"):
        st.add_batch(values, cnt, pos)
        st.finish()


def test_window_and_int32_guards():
    fake = SimpleNamespace(max_probe=300, num_sigs=1000,
                           occupied=np.ones(1000, bool))
    with pytest.raises(ValueError, match="256"):
        SparseLookup(fake, device="cpu")
    huge = SimpleNamespace(max_probe=8, num_sigs=1 << 31)
    with pytest.raises(ValueError, match="2\\^31"):
        SparseLookup(huge, device="cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        SparseLookup.from_numpy(huge, np.zeros(0, np.uint16),
                                np.zeros(0, np.int64), 16, 16, "cpu")


def test_cuda_device_without_cuda_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    _, port_t, _ = _tables(500, seed=16, load_factor=0.6)
    with pytest.raises(RuntimeError, match="cuda"):
        SparseLookup(port_t, device="cuda")
