"""The fused step's kernel (kmergutsjava_tpu_torch/parallel/fused_probe.py:
k-mer windows from ASCII rows and their probe in one launch; on the CPU its
plain twin) against the JAX package, at small sizes with inputs drawn from
seeded numpy.

- First-event form (one device): B1's answer to every window equals the
  JAX flat first-event probe (``lookup/xla.py`` ``probe_fingerprint_pass``)
  on the JAX step's windows (``_window_homes_qfp`` after the encode of
  ``_encode_and_probe``, the translation of ``_dna_encode_and_probe``, the
  frame selection and ownership of ``seq_windows._window_probe``), and is
  state 0 for a window that is not valid or runs off the plane: aa and DNA
  rows, rows shorter than 8, Lpad not a multiple of 3, a long contig's
  windows, windows 1 to 128, a padded plane and one shorter than the table.
- Shard form (a mesh position): B12's answer equals a numpy scan of the
  plane slice on the JAX step's windows, with homes at both edges of the
  shard's range and in its halo (not owned); and the mesh step equals the
  JAX sharded steps (``_local_probe``) bit for bit on the five meshes of
  the sharded tests, for aa rows, DNA rows and a long contig's windows.
- ``--backend spmd`` goes through the fused entries only: with B1's and
  B12's wrappers made to raise, reports still equal the JAX engine's, on
  one device and on a (2, 2) mesh.
- The wrappers count no launch for CPU tensors and refuse what the kernel
  does not take (KernelError); that they run the twins there is
  test_torch_kernels.py's."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kmergutsjava_tpu.lookup.xla import probe_fingerprint_pass
from kmergutsjava_tpu.ops import encode as jax_encode
from kmergutsjava_tpu.ops.translate import translate_6frames as jax_translate
from kmergutsjava_tpu.parallel import annotate_step as jax_step
from kmergutsjava_tpu.parallel import seq_windows as jax_windows
from kmergutsjava_tpu.parallel.annotate_step import _window_homes_qfp
from kmergutsjava_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kmergutsjava_tpu.formats.kmer_table import read_table as jax_read_table
from kmergutsjava_tpu_torch.formats.kmer_table import TABLE_FILE, read_table
from kmergutsjava_tpu_torch.lookup import tilejoin
from kmergutsjava_tpu_torch.lookup.tilejoin import KernelError
from kmergutsjava_tpu_torch.parallel import (annotate_step, fused_probe,
                                             seq_windows, shard_probe)
from kmergutsjava_tpu_torch.parallel import mesh as port_mesh

from test_torch_spmd import CPU8, _jax, _mesh_batch, _port, _records
from test_torch_spmd import corpus, short_long  # noqa: F401  (fixtures)

FP_EMPTY = 65535
NUM_SIGS = 1009
AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
NT = np.frombuffer(b"ACGTacgt", np.uint8)

# (kind, rows, Lpad) or ("windows", contig length, win_nt)
CASES = [("aa", 40, 8), ("aa", 30, 9), ("aa", 20, 64), ("aa", 6, 700),
         ("dna", 30, 24), ("dna", 30, 26), ("dna", 12, 64), ("dna", 5, 301),
         ("windows", 700, 150), ("windows", 3001, 300)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(kind, b, lpad, seed):
    """Seeded rows of mostly clean letters (1% junk: invalid windows too),
    a row of each length class (full, 0, < 8, 8), zero past each length.
    Returns (ascii, counts: num_starts = length - 8 for aa, lengths for
    DNA, extra: ())."""
    rng = np.random.default_rng(seed)
    aa = kind == "aa"
    mat = rng.choice(AA if aa else NT, (b, lpad)).astype(np.uint8)
    mat[rng.random((b, lpad)) < 0.01] = ord("X" if aa else "N")
    lens = rng.integers(0, lpad + 1, b)
    lens[:4] = [lpad, 0, min(5, lpad), min(8, lpad)]
    mat[np.arange(lpad)[None, :] >= lens[:, None]] = 0
    return mat, (lens - 8 if aa else lens).astype(np.int32), ()


def _windowed(length, win_nt, seed):
    """One contig cut by plan_windows: (ascii, len_w, (row_map, own_start,
    own_end))."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(NT[:4], length).astype(np.uint8)
    plan = seq_windows.plan_windows(length, win_nt)
    a = np.full((len(plan["s"]), win_nt), ord("N"), np.uint8)
    for i, (s, e) in enumerate(zip(plan["s"], plan["e"])):
        a[i, :e - s] = seq[s:e]
    return (a, plan["len_w"].astype(np.int32),
            tuple(plan[k].astype(np.int32)
                  for k in ("row_map", "own_start", "own_end")))


def _inputs(case):
    kind, x, y = case
    if kind == "windows":
        return False, _windowed(x, y, seed=x)
    return kind == "aa", _rows(kind, x, y, seed=x * 1000 + y)


def _jax_windows(aa, mat, counts, extra, num_sigs):
    """The JAX step's windows, flat in the windows' order: (homes,
    fingerprints, ok) as int64, int64, bool."""
    if aa:
        offs = jax_encode.aa_offsets(jnp.asarray(mat))
        h, q, ok = _window_homes_qfp(offs, jnp.asarray(counts), num_sigs)
    else:
        frames = np.asarray(jax.vmap(jax_translate)(jnp.asarray(mat),
                                                    jnp.asarray(counts)))
        b, _, m = frames.shape
        if extra:  # _window_probe: frames by row_map, owned intervals
            row_map, own_start, own_end = extra
            sel = np.take_along_axis(frames, row_map[:, :, None], axis=1)
            w = m - 7
            h, q, ok = _window_homes_qfp(jnp.asarray(sel.reshape(b * 6, m)),
                                         jnp.full((b * 6,), w), num_sigs)
            jj = np.arange(w)[None, None, :]
            ok = (np.asarray(ok).reshape(b, 6, w)
                  & (jj >= own_start[:, :, None])
                  & (jj < own_end[:, :, None]))
        else:
            starts = jnp.repeat(jnp.maximum(jnp.asarray(counts) // 3 - 7, 0),
                                6)
            h, q, ok = _window_homes_qfp(jnp.asarray(frames.reshape(b * 6,
                                                                    m)),
                                         starts, num_sigs)
    return (np.asarray(h).reshape(-1).astype(np.int64),
            np.asarray(q).reshape(-1).astype(np.int64),
            np.asarray(ok).reshape(-1))


def _plane(length, homes, q, ok, w, seed, lo=0):
    """A seeded u16 plane of ``length`` slots (global slots from ``lo``)
    with 35% empties, half the valid windows' fingerprints planted a
    random offset into their window (half of those within its first three
    slots, so that they often come before an empty slot)."""
    rng = np.random.default_rng(seed)
    plane = rng.integers(0, FP_EMPTY, length).astype(np.uint16)
    plane[rng.random(length) < 0.35] = FP_EMPTY
    pick = np.nonzero(ok & (rng.random(len(homes)) < 0.5))[0]
    near = rng.random(len(pick)) < 0.5
    at = homes[pick] - lo + np.where(near, rng.integers(0, min(w, 3),
                                                        len(pick)),
                                     rng.integers(0, w, len(pick)))
    keep = (at >= 0) & (at < length)
    plane[at[keep]] = q[pick][keep]
    return plane


def _b1_on(plane, homes, q, ok, w):
    """B1's answer from the JAX flat probe for the valid in-plane windows;
    state 0 (off 0) for the rest."""
    off = np.zeros(len(homes), np.uint8)
    state = np.zeros(len(homes), np.uint8)
    sel = np.nonzero(ok & (homes + w <= len(plane)))[0]
    if len(sel):
        o, s = probe_fingerprint_pass(
            jnp.asarray(plane), jnp.asarray(q[sel].astype(np.uint16)),
            jnp.asarray(homes[sel].astype(np.int32)), w)
        off[sel], state[sel] = np.asarray(o), np.asarray(s)
    return off, state


@pytest.mark.parametrize("plane_kind", ["padded", "short"])
@pytest.mark.parametrize("w", [1, 16, 128])
@pytest.mark.parametrize("case", CASES)
def test_first_event_twin_equals_b1_on_jax_windows(case, w, plane_kind):
    """The first-event entry (the fused step on one device) against B1's
    answer on the JAX step's windows: every window's off and state; on a
    plane shorter than the table, windows off its end are state 0."""
    aa, (mat, counts, extra) = _inputs(case)
    homes, q, ok = _jax_windows(aa, mat, counts, extra, NUM_SIGS)
    length = NUM_SIGS + w if plane_kind == "padded" else NUM_SIGS // 2
    plane = _plane(length, homes, q, ok, w, seed=w + len(homes))
    if plane_kind == "padded":
        plane[NUM_SIGS:] = FP_EMPTY  # the real plane's padding
    before = fused_probe.launches
    answer = fused_probe.first_event(_t(plane), _t(mat), _t(counts), aa,
                                     NUM_SIGS, w, *map(_t, extra))
    assert fused_probe.launches == before
    off, state = tilejoin.answer_views(answer.numpy(), len(homes))
    want_off, want_state = _b1_on(plane, homes, q, ok, w)
    np.testing.assert_array_equal(state, want_state)
    np.testing.assert_array_equal(off, want_off)
    assert (state[~ok] == 0).all()
    if ok.sum() > 50:
        assert (state == 1).any() and (state == 2).any()
    if plane_kind == "short" and ok.sum() > 50:
        assert (ok & (homes + w > length)).any()


def _b12_on(plane, homes, q, ok, lo, s_loc, w):
    """A numpy scan of the shard's plane slice: global slot + 1 of the
    first fingerprint match in the window of each valid owned window."""
    out = np.zeros(len(homes), np.int32)
    sel = np.nonzero(ok & (homes >= lo) & (homes < lo + s_loc))[0]
    if len(sel):
        wins = np.lib.stride_tricks.sliding_window_view(plane, w)[
            homes[sel] - lo]
        hit = wins == q[sel, None]
        first = hit.argmax(axis=1)
        out[sel] = np.where(hit.any(axis=1), homes[sel] + first + 1, 0)
    return out


@pytest.mark.parametrize("w", [1, 16, 128])
@pytest.mark.parametrize("case", CASES)
def test_shard_twin_equals_b12_on_jax_windows(case, w):
    """The shard entry (the fused step at a mesh position) for a shard
    owning [29, 60) of 97 slots: every window's int32 answer equals a
    numpy scan on the JAX step's windows; homes at both edges of the range
    are probed, homes in the halo past it are not owned (0)."""
    num_sigs, lo, s_loc = 97, 29, 31
    aa, (mat, counts, extra) = _inputs(case)
    homes, q, ok = _jax_windows(aa, mat, counts, extra, num_sigs)
    plane = _plane(s_loc + w, homes, q, ok, w, seed=w, lo=lo)
    got = fused_probe.shard_first_match(_t(plane), _t(mat), _t(counts), aa,
                                        num_sigs, lo, s_loc, w,
                                        *map(_t, extra)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _b12_on(plane, homes, q, ok, lo,
                                               s_loc, w))
    if ok.sum() > 200:
        for edge in (lo, lo + s_loc - 1):
            assert (ok & (homes == edge)).any()
        halo = ok & (homes >= lo + s_loc) & (homes < lo + s_loc + w)
        assert halo.any() and (got[halo] == 0).all()
        assert (got > 0).any()


MESHES = [(4, 2), (2, 4), (1, 8), (8, 1), (2, 2)]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("mode", ["aa", "dna", "windows"])
def test_mesh_step_equals_jax_sharded_step(corpus, mode, shape):
    """The port's mesh step (the shard entry's twin on every position, the
    sum over the table axis) against the JAX sharded step on a mesh of the
    same shape: the int32 slot + 1 of every window, bit for bit."""
    d, texts = corpus
    path = os.path.join(d, TABLE_FILE)
    jt, pt = jax_read_table(path), read_table(path)
    pt.compute_max_probe()
    pw = max(8, pt.max_probe)
    jm = jax_make_mesh(*shape)
    m = port_mesh.make_mesh(*shape, devices=port_mesh.mesh_devices(
        "cpu", CPU8))
    if mode == "windows":
        contig = np.frombuffer(_records(texts["dna"])[-2].seq.encode(),
                               np.uint8)
        mat, cols = _windowed_rows(contig, 150)
        n = len(mat)
        n_pad = -(-n // shape[0]) * shape[0]
        pad = [np.concatenate([x, np.zeros((n_pad - n, *x.shape[1:]),
                                           x.dtype)]) for x in [mat, *cols]]
        jstep, jplanes = jax_windows.make_windowed_dna_step(jm, jt, pw, 150)
        specs = [P("data", None), P("data"), P("data", None),
                 P("data", None), P("data", None)]
        want = np.asarray(jax.device_get(jstep(jplanes["fp"], *(
            jax.device_put(x, NamedSharding(jm, sp))
            for x, sp in zip(pad, specs)))))[:n]
        _, planes = annotate_step.make_sharded_dna_step(m, pt, pw)
        step, planes = seq_windows.make_sharded_windowed_dna_step(
            m, pt, pw, 150, planes)
        got = step(planes["fp"], mat, *cols).read()
    else:
        aa = mode == "aa"
        mat, lens = _mesh_batch(texts, mode, 256 if aa else 301)
        make_j = (jax_step.make_sharded_annotate_step if aa
                  else jax_step.make_sharded_dna_step)
        jstep, jplanes = make_j(jm, jt, pw)
        n_pad = -(-len(mat) // shape[0]) * shape[0]
        pm = np.zeros((n_pad, mat.shape[1]), np.uint8)
        pm[:len(mat)] = mat
        pl = np.zeros(n_pad, np.int64)
        pl[:len(lens)] = lens
        want = np.asarray(jax.device_get(jstep(
            jplanes["fp"],
            jax.device_put(pm, NamedSharding(jm, P("data", None))),
            jax.device_put(pl, NamedSharding(jm, P("data"))))))[:len(mat)]
        make_p = (annotate_step.make_sharded_annotate_step if aa
                  else annotate_step.make_sharded_dna_step)
        step, planes = make_p(m, pt, pw)
        got = step(planes["fp"], mat, lens).read()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 20


def _windowed_rows(contig, win_nt):
    plan = seq_windows.plan_windows(len(contig), win_nt)
    n = len(plan["s"])
    mat = np.full((n, win_nt), ord("N"), np.uint8)
    for i in range(n):
        mat[i, :plan["len_w"][i]] = contig[plan["s"][i]:plan["e"][i]]
    return mat, [plan[k].astype(np.int32) for k in
                 ("len_w", "row_map", "own_start", "own_end")]


@pytest.mark.parametrize("mesh_shape", [None, (2, 2)])
@pytest.mark.parametrize("mode", ["aa", "dna"])
def test_spmd_runs_through_the_fused_entries_only(corpus, short_long,
                                                  monkeypatch, mode,
                                                  mesh_shape):
    """``--backend spmd`` with B1's and B12's wrappers made to raise: the
    report (long records through windows) still equals the JAX engine's,
    and the fused entry of the step's form was called, once a batch (a
    position a batch on a mesh)."""
    def refused(*a, **kw):
        raise AssertionError("the spmd path called a standalone kernel")

    for mod, name in ((tilejoin, "probe_answer"),
                      (shard_probe, "shard_probe")):
        monkeypatch.setattr(mod, name, refused)
    entry = "first_event" if mesh_shape is None else "shard_first_match"
    calls = []
    real = getattr(fused_probe, entry)

    def counted(*a, **kw):
        calls.append(a[1].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(fused_probe, entry, counted)
    d, texts = corpus
    aa = mode == "aa"
    kw = dict(backend="spmd", min_hits=2)
    if mesh_shape:
        kw["mesh_shape"] = mesh_shape
    got = _port(d, texts[mode], aa,
                **(dict(mesh_devices=CPU8) if mesh_shape else {}), **kw)
    assert got == _jax(d, texts[mode], aa, **kw) and "CALL\t" in got
    assert calls and (mesh_shape is None or len(calls) % 4 == 0)


@pytest.mark.parametrize("bad", ["plane_i16", "plane_2d", "w0", "w257",
                                 "shard_w129", "shard_short_plane",
                                 "shard_lo_neg", "shard_int32", "aa_row_map",
                                 "own_without_row_map", "row_map_alone",
                                 "counts_i64", "ascii_1d", "ns0"])
def test_entries_reject_bad_inputs(bad):
    a = torch.zeros((4, 30), dtype=torch.uint8)
    c = torch.zeros(4, dtype=torch.int32)
    six = torch.zeros((4, 6), dtype=torch.int32)
    plane = torch.zeros(200, dtype=torch.uint16)
    args = dict(plane=plane, ascii_u8=a, counts=c, aa=False, num_sigs=101)
    shard = dict(lo=0, s_loc=100, w=16)
    first = dict(w=16)
    if bad == "plane_i16":
        args["plane"] = plane.view(torch.int16)
    elif bad == "plane_2d":
        args["plane"] = plane.view(10, 20)
    elif bad == "w0":
        first["w"] = 0
    elif bad == "w257":
        first["w"] = 257
    elif bad == "shard_w129":
        shard["w"] = 129
    elif bad == "shard_short_plane":
        shard["s_loc"] = 190
    elif bad == "shard_lo_neg":
        shard["lo"] = -1
    elif bad == "shard_int32":
        shard["lo"] = (1 << 31) - 110
    elif bad == "aa_row_map":
        args.update(aa=True, row_map=six, own_start=six, own_end=six)
    elif bad == "own_without_row_map":
        args.update(own_start=six, own_end=six)
    elif bad == "row_map_alone":
        args.update(row_map=six)
    elif bad == "counts_i64":
        args["counts"] = c.long()
    elif bad == "ascii_1d":
        args["ascii_u8"] = a.view(-1)
    elif bad == "ns0":
        args["num_sigs"] = 0
    with pytest.raises(KernelError):
        if bad.startswith("shard_"):
            fused_probe.shard_first_match(**args, **shard)
        else:
            fused_probe.first_event(**args, **first)
