"""The port's routed lookup (kmergutsjava_tpu_torch/parallel/
routed_lookup.py) and its routing bins B13 (parallel/route_bins.py: on the
CPU the kernels' plain twins) against the JAX package's ``_routed_step``
under ``shard_map`` on its eight virtual CPU devices.

- B13's bins equal the JAX step's cell for cell (its fingerprints and homes
  just before the first ``all_to_all``, taken by a spy on that call), and
  its overflow flags equal the step's, at the same ``cap``: uniform homes
  over 2, 4 and 8 shards, a forced overflow (slack 0.1) and homes skewed
  onto one shard. Exact.
- The routed answers (after the exchange, the owner's probe and the
  un-binning, whose one buffer a shard holds the offsets, states and
  overflow flags in rows of a 16-byte stride) against the step's: the
  overflow flags and the offsets exactly, state bit 0 exactly, and bit 1
  only where bit 0 is 0. The
  owner's probe is B1's first event, where the JAX step's state is 3 for a
  candidate with an empty slot after it; the host reads bit 0 first.
- The verified hits equal the parity scan's, and the ``routed`` backend's
  reports (aa and DNA) the JAX engine's byte for byte.
- The un-binning's twin against a numpy definition at tails of every
  length mod 16, no query, every query overflowing and 256 shards; and a
  spy shows one answer exchange and one read-back a shard per probe.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from kmergutsjava_tpu.parallel import routed_lookup as jax_routed
from kmergutsjava_tpu_torch.lookup.parity import lookup_stream
from kmergutsjava_tpu_torch.lookup.tilejoin import KernelError
from kmergutsjava_tpu_torch.parallel import route_bins
from kmergutsjava_tpu_torch.parallel.mesh import make_mesh
from kmergutsjava_tpu_torch.parallel.routed_lookup import RoutedLookup

from test_lookup import canon, make_queries
from test_torch_mesh import corpus, both  # noqa: F401  (a fixture)
from test_torch_sharded import tables


def jax_step_with_bins(monkeypatch, table, values, n_shards, pw, slack):
    """The JAX routed step on ``values`` as its lookup pads them, with the
    bins it exchanges: (off, state, over, bin_qfp [T, T, cap], bin_home
    [T, T, cap], n_loc, cap), bins indexed by source shard."""
    rl = jax_routed.RoutedLookup(table, jax_routed.make_routed_mesh(n_shards),
                                 probe_window=pw, slack=slack)
    t = n_shards
    n = len(values)
    n_loc = -(-n // t)
    n_pad = n_loc * t
    homes = np.zeros(n_pad, np.int32)
    homes[:n] = (values % np.int64(table.num_sigs)).astype(np.int32)
    qfp = np.full(n_pad, 65535, np.uint16)
    qfp[:n] = (values % 65535).astype(np.uint16)
    valid = np.zeros(n_pad, bool)
    valid[:n] = True
    cap = max(64, int(n_loc / t * slack))
    sent = []
    real = jax.lax.all_to_all

    def spy(x, *a, **kw):
        sent.append(x)
        return real(x, *a, **kw)

    def body(*args):
        sent.clear()
        outs = jax_routed._routed_step(
            *args, s_loc=rl.s_loc, probe_window=pw, cap=cap, n_shards=t,
            stride=rl.stride)
        # the step's first two exchanges send the fingerprint and home bins
        return outs + (sent[0][None], sent[1][None])

    monkeypatch.setattr(jax.lax, "all_to_all", spy)
    ax = jax_routed.AXIS
    f = jax.jit(jax.shard_map(
        body, mesh=rl.mesh,
        in_specs=(P(ax, None, None), P(ax), P(ax), P(ax)),
        out_specs=(P(ax), P(ax), P(ax), P(ax, None, None),
                   P(ax, None, None))))
    qs = NamedSharding(rl.mesh, P(ax))
    off, state, over, bq, bh = (np.asarray(x) for x in jax.device_get(f(
        rl.fp_shards, jax.device_put(qfp, qs), jax.device_put(homes, qs),
        jax.device_put(valid, qs))))
    return off, state, over, bq, bh, n_loc, cap


CASES = {"uniform-2": (2, 2.0, False), "uniform-4": (4, 2.0, False),
         "uniform-8": (8, 2.0, False), "overflow-4": (4, 0.1, False),
         "skewed-4": (4, 2.0, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_b13_bins_and_answers_equal_jax_step(monkeypatch, case):
    n_shards, slack, skewed = CASES[case]
    rng, sig, jt, pt = tables(n_shards, 3000, 0.7)
    pw = max(16, pt.max_probe)
    if skewed:  # every query homes into the first shard's range
        s_loc = -(-pt.num_sigs // n_shards)
        first = sig["kmers"][sig["kmers"] % pt.num_sigs < s_loc]
        values = np.tile(first[:50], 40).astype(np.int64)
    else:
        values, _, _ = make_queries(rng, sig["kmers"], 6001)
    off, state, over, bq, bh, n_loc, cap = jax_step_with_bins(
        monkeypatch, jt, values, n_shards, pw, slack)
    n = len(values)
    homes = np.zeros(n_loc * n_shards, np.int32)
    homes[:n] = values % pt.num_sigs
    qfp = np.full(n_loc * n_shards, 65535, np.uint16)
    qfp[:n] = values % 65535
    s_loc = -(-pt.num_sigs // n_shards)
    for s in range(n_shards):
        lo = s * n_loc
        b_qfp, b_home, cell = route_bins.bins(
            torch.from_numpy(qfp[lo:lo + n_loc]),
            torch.from_numpy(homes[lo:lo + n_loc]), n - lo, s_loc, n_shards,
            cap)
        np.testing.assert_array_equal(b_qfp.numpy(),
                                      bq.reshape(n_shards, n_shards, cap)[s])
        np.testing.assert_array_equal(b_home.numpy(),
                                      bh.reshape(n_shards, n_shards, cap)[s])
        np.testing.assert_array_equal(cell.numpy() < 0, over[lo:lo + n_loc])
    assert over[:n].any() == (case in ("overflow-4", "skewed-4"))

    m = make_mesh(1, n_shards, [torch.device("cpu")] * 8)
    unbinned = []
    real_unbin = route_bins.unbin

    def spy(cell, back):
        unbinned.append(real_unbin(cell, back))
        return unbinned[-1]

    monkeypatch.setattr(route_bins, "unbin", spy)
    got_off, got_state, got_over = RoutedLookup(
        pt, m, probe_window=pw, slack=slack).probe(values)
    # each shard's one buffer: [3, n_loc rounded up to 16], the JAX step's
    # offsets and overflow flags in rows 0 and 2, zeros past n_loc
    assert len(unbinned) == n_shards
    for s, buf in enumerate(unbinned):
        assert buf.dtype == torch.uint8
        assert tuple(buf.shape) == (3, -(-n_loc // 16) * 16)
        assert not buf[:, n_loc:].any()
        lo = s * n_loc
        b_off, _, b_over = buf.numpy()[:, :n_loc]
        np.testing.assert_array_equal(b_over.view(bool), over[lo:lo + n_loc])
        np.testing.assert_array_equal(b_off, off[lo:lo + n_loc])
    np.testing.assert_array_equal(got_over, over[:n])
    np.testing.assert_array_equal(got_off, off[:n])
    np.testing.assert_array_equal(got_state & 1, state[:n] & 1)
    no_cand = (state[:n] & 1) == 0
    np.testing.assert_array_equal(got_state[no_cand], state[:n][no_cand])
    assert ((state[:n] == 3) & (got_state == 1)).any() or case == "skewed-4"

    cnt = np.zeros(n, np.int64)
    pos = np.arange(n, dtype=np.int64)
    hits = RoutedLookup(pt, m, probe_window=pw, slack=slack).lookup(
        values, cnt, pos)
    ref = lookup_stream(pt, values, cnt, pos)
    assert canon(hits) == canon(ref)
    assert hits.kmers_found == ref.kmers_found


def test_b13_twin_is_a_stable_sort():
    """The twin by its definition on a hand-made case: ranks in input order
    within each owner, padded queries and ranks past cap overflow, unused
    cells FP_EMPTY and home 0; un-binning gathers each query's cell."""
    homes = torch.tensor([25, 3, 27, 12, 1, 29, 0, 5], dtype=torch.int32)
    q = torch.tensor([1, 2, 3, 4, 5, 6, 7, 8],
                     dtype=torch.int32).to(torch.int16).view(torch.uint16)
    b_qfp, b_home, cell = route_bins.bins(q, homes, 7, 10, 3, 2)
    # owners 2, 0, 2, 1, 0, 2, 0, (padded); cap 2: ranks 0, 0, 1, 0, 1, 2, 2
    assert cell.tolist() == [4, 0, 5, 2, 1, -1, -1, -1]
    assert b_qfp.view(torch.int16).tolist() == [[2, 5], [4, -1], [1, 3]]
    assert b_home.tolist() == [[3, 1], [12, 0], [25, 27]]
    # back[owner, 0] its offsets, back[owner, 1] its states
    back_off = torch.arange(6, dtype=torch.uint8) + 10
    back_state = torch.arange(6, dtype=torch.uint8) % 3
    back = torch.stack((back_off.view(3, 2), back_state.view(3, 2)), 1)
    out = route_bins.unbin(cell, back.contiguous())
    assert tuple(out.shape) == (3, 16) and not out[:, 8:].any()
    off, state, over = out[:, :8]
    assert off.tolist() == [14, 10, 15, 12, 11, 0, 0, 0]
    assert state.tolist() == [1, 0, 2, 2, 1, 0, 0, 0]
    assert over.tolist() == [0, 0, 0, 0, 0, 1, 1, 1]


def test_cpu_wrappers_count_no_launch():
    before = (route_bins.launches, route_bins.unbin_launches)
    h = torch.arange(10, dtype=torch.int32)
    _, _, cell = route_bins.bins(torch.zeros(10, dtype=torch.uint16), h, 10,
                                 5, 2, 8)
    route_bins.unbin(cell, torch.zeros((2, 2, 8), dtype=torch.uint8))
    assert (route_bins.launches, route_bins.unbin_launches) == before


@pytest.mark.parametrize("bad", ["homes_i64", "qfp_i16", "length",
                                 "shards", "cell_i64", "back_i32",
                                 "back_flat"])
def test_wrappers_reject_bad_inputs(bad):
    h = torch.zeros(4, dtype=torch.int32)
    q = torch.zeros(4, dtype=torch.uint16)
    with pytest.raises(KernelError):
        if bad in ("cell_i64", "back_i32", "back_flat"):
            cell = torch.zeros(4, dtype=torch.int64 if bad == "cell_i64"
                               else torch.int32)
            back = torch.zeros((2, 2, 2), dtype=torch.int32
                               if bad == "back_i32" else torch.uint8)
            route_bins.unbin(cell, back.view(-1) if bad == "back_flat"
                             else back)
        else:
            args = dict(q_fp=q, homes=h, n_valid=4, s_loc=5, n_shards=2,
                        cap=4)
            args.update({"homes_i64": dict(homes=h.long()),
                         "qfp_i16": dict(q_fp=q.view(torch.int16)),
                         "length": dict(q_fp=q[:3]),
                         "shards": dict(n_shards=257)}[bad])
            route_bins.bins(**args)


@pytest.mark.parametrize("n,shards", [(0, 4), (1024, 1), (1024 * 1024, 4),
                                      (1024 * 1024 + 1, 4),
                                      (1024 * 1500, 256), (70_000, 256)])
def test_b13_count_scratch_holds_every_tile_and_the_totals(n, shards):
    """The binning's count scratch: a row of T + 1 owner counts for each
    tile of 1,024 queries (the scan takes 1,024 tiles at a time, so past
    1,024 tiles it carries a total), and one row of totals after them."""
    tiles = -(-n // route_bins.TILE)
    assert route_bins.counts_size(n, shards) == (tiles + 1) * (shards + 1)


@pytest.mark.parametrize("n,shards,cap", [(1024 * 1025 + 3, 4, 300_000),
                                          (70_000, 256, 200),
                                          (50_000, 1, 60_000)])
def test_b13_twin_past_one_scan_chunk_and_at_256_shards(n, shards, cap):
    """The twin at the sizes whose scratch the kernel sizes above (more
    than 1,024 tiles; 257 owners) against a numpy stable sort by owner."""
    rng = np.random.default_rng(n)
    homes = rng.integers(0, 1_000_003, n).astype(np.int32)
    qfp = rng.integers(0, 65535, n).astype(np.uint16)
    s_loc = -(-1_000_003 // shards)
    n_valid = n - 17
    b_qfp, b_home, cell = route_bins.bins(
        torch.from_numpy(qfp), torch.from_numpy(homes), n_valid, s_loc,
        shards, cap)
    owner = np.minimum(homes // s_loc, shards - 1)
    owner[n_valid:] = shards
    order = np.argsort(owner, kind="stable")
    rank = np.empty(n, np.int64)
    starts = np.searchsorted(owner[order], np.arange(shards + 1))
    rank[order] = np.arange(n) - starts[owner[order]]
    want = np.where((rank < cap) & (owner < shards), owner * cap + rank, -1)
    np.testing.assert_array_equal(cell.numpy(), want)
    ok = want >= 0
    flat_home = np.zeros(shards * cap, np.int32)
    flat_home[want[ok]] = homes[ok]
    np.testing.assert_array_equal(b_home.numpy().ravel(), flat_home)
    flat_qfp = np.full(shards * cap, 65535, np.uint16)
    flat_qfp[want[ok]] = qfp[ok]
    np.testing.assert_array_equal(
        b_qfp.view(torch.int16).numpy().view(np.uint16).ravel(), flat_qfp)


@pytest.mark.parametrize("mode", ["aa", "dna"])
def test_routed_backend_reports_equal_jax(corpus, mode):  # noqa: F811
    """``--backend routed`` over all eight devices and at ``--mesh 1x4``:
    the JAX engine's report."""
    d, texts, _ = corpus
    for shape in (None, (1, 4)):
        got, want = both(d, texts[mode], mode == "aa", backend="routed",
                         mesh_shape=shape, min_hits=2)
        assert got == want and "CALL\t" in got


def unbin_numpy(cell, back):
    """The un-binning by its definition: [3, n rounded up to 16] of each
    query's offset and state from its owner's rows of ``back`` [T, 2, cap]
    (0 for an overflow) and its overflow flag, zeros past n."""
    n, cap = len(cell), back.shape[2]
    out = np.zeros((3, -(-n // 16) * 16), np.uint8)
    for i, c in enumerate(cell):
        if c < 0:
            out[2, i] = 1
        else:
            out[0, i], out[1, i] = back[c // cap, :, c % cap]
    return out


@pytest.mark.parametrize("case", ["tails", "empty", "all_overflow",
                                  "shards_256"])
def test_b13_unbin_twin_at_the_edges(case):
    """The un-binning's twin against ``unbin_numpy``: every length from 1
    to 33 (each tail mod 16 and mod 8, cells and overflows mixed), no
    query, every query overflowing, and 256 owners."""
    rng = np.random.default_rng(len(case))
    sizes = {"tails": range(1, 34), "empty": [0], "all_overflow": [1000],
             "shards_256": [5001]}[case]
    shards, cap = (256, 30) if case == "shards_256" else (4, 9)
    for n in sizes:
        cell = rng.integers(-1, shards * cap, n).astype(np.int32)
        if case == "all_overflow":
            cell[:] = -1
        back = rng.integers(0, 256, (shards, 2, cap)).astype(np.uint8)
        got = route_bins.unbin(torch.from_numpy(cell), torch.from_numpy(back))
        np.testing.assert_array_equal(got.numpy(), unbin_numpy(cell, back))
        if case == "all_overflow":
            assert got[2, :n].all() and not got[:2].any()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_routed_probe_makes_one_answer_exchange_and_one_read_back_a_shard(
        monkeypatch, n_shards):
    """A spy on the routed lookup's exchanges and on every copy to the
    host while it probes: the fingerprints and homes go out in two
    exchanges, the answers come back in one (of u8 [T, 2, cap] back
    buffers), and each shard's answer is read back in one copy of its
    [3, ld] buffer; the probe's result is the one without the spies."""
    from kmergutsjava_tpu_torch.parallel import routed_lookup

    rng, sig, _, pt = tables(n_shards, 3000, 0.7)
    values, _, _ = make_queries(rng, sig["kmers"], 4001)
    lk = RoutedLookup(pt, make_mesh(1, n_shards, [torch.device("cpu")] * 8),
                      probe_window=max(16, pt.max_probe))
    want = lk.probe(values)
    exchanges, copies = [], []
    real_a2a, real_cpu = routed_lookup.all_to_all, torch.Tensor.cpu

    def a2a(mesh, sends, outs):
        exchanges.append([o.dtype for o in outs if o is not None])
        return real_a2a(mesh, sends, outs)

    def cpu(self, *a, **kw):
        copies.append((self.dtype, tuple(self.shape)))
        return real_cpu(self, *a, **kw)

    monkeypatch.setattr(routed_lookup, "all_to_all", a2a)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    got = lk.probe(values)
    monkeypatch.undo()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    answers = [e for e in exchanges if e[0] == torch.uint8]
    assert len(exchanges) == 3 and len(answers) == 1
    assert exchanges[0][0] == torch.uint16 and exchanges[1][0] == torch.int32
    n_loc = -(-len(values) // n_shards)
    assert copies == [(torch.uint8, (3, -(-n_loc // 16) * 16))] * n_shards
