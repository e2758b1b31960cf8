"""The port's device ops (kmergutsjava_tpu_torch/ops/: encode, translate,
kmerize, hostvalues, and the k-mer window kernel's plain twin) and the long
records' window plans (parallel/seq_windows.py), on the CPU, against the
JAX package's functions: bit-equal on every byte 0-255, on lengths 0, < 8
and of each residue mod 3, on padded rows, on num_starts at 0 and at the
bucket's edge, and on homes and fingerprints against the JAX step's
``_window_homes_qfp`` on both of its branches (int32 residues and int64
values). Inputs are drawn from seeded numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmergutsjava_tpu.ops import encode as jax_encode
from kmergutsjava_tpu.ops import hostvalues as jax_hostvalues
from kmergutsjava_tpu.ops.kmerize import MOD32_LIMIT
from kmergutsjava_tpu.ops.kmerize import kmer_windows as jax_kmer_windows
from kmergutsjava_tpu.ops.translate import translate_6frames as jax_translate
from kmergutsjava_tpu.parallel import seq_windows as jax_seq_windows
from kmergutsjava_tpu.parallel.annotate_step import _window_homes_qfp
from kmergutsjava_tpu_torch.ops import encode, hostvalues, kmer_windows
from kmergutsjava_tpu_torch.ops.kmerize import kmer_windows as port_windows
from kmergutsjava_tpu_torch.ops.kmerize import window_homes_fps
from kmergutsjava_tpu_torch.ops.translate import translate_6frames
from kmergutsjava_tpu_torch.parallel import seq_windows

ALL_BYTES = np.arange(256, dtype=np.uint8)
NT = np.frombuffer(b"ACGT" * 6 + b"acgtuUNnRYKMSWBDHV*", np.uint8)
AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY" * 3 + b"acdyXBZJUO*", np.uint8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", ["aa_offsets", "dna_codes", "revcomp_codes"])
def test_encode_every_byte(name):
    rng = np.random.default_rng(1)
    rows = np.stack([ALL_BYTES, rng.permutation(ALL_BYTES)])
    got = getattr(encode, name)(_t(rows)).numpy()
    want = np.asarray(getattr(jax_encode, name)(jnp.asarray(rows)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8


def _nt_rows(rng, lpad, lengths, high_bytes=True):
    """Rows of bases (lowercase, IUPAC, junk; every seventh byte of row 0
    in 128-255), zero past each length."""
    mat = rng.choice(NT, (len(lengths), lpad)).astype(np.uint8)
    if high_bytes:
        mat[0, ::7] = rng.integers(128, 256, mat[0, ::7].shape)
    mat[np.arange(lpad)[None, :] >= np.asarray(lengths)[:, None]] = 0
    return mat


@pytest.mark.parametrize("lpad", [1, 24, 256, 301, 3 * 64])
def test_translate_6frames_equals_jax(lpad):
    """Every length class: 0, below K, each residue mod 3, the full row;
    frames in the order +0 +1 +2 -0 -1 -2."""
    rng = np.random.default_rng(lpad)
    lengths = sorted({0, 1, 2, 5, 7, lpad, lpad - 1, lpad - 2,
                      *rng.integers(0, lpad + 1, 6).tolist()})
    lengths = [x for x in lengths if 0 <= x <= lpad]
    mat = _nt_rows(rng, lpad, lengths)
    got = translate_6frames(_t(mat), _t(np.asarray(lengths))).numpy()
    assert got.shape == (len(lengths), 6, lpad // 3)
    for i, n in enumerate(lengths):
        want = np.asarray(jax_translate(jnp.asarray(mat[i]), jnp.int64(n)))
        np.testing.assert_array_equal(got[i], want, err_msg=f"length {n}")


@pytest.mark.parametrize("n", [7, 8, 9, 64, 300])
def test_kmer_windows_equals_jax(n):
    """Values and validity bit-equal, with num_starts below 0, at 0, at
    the bucket's edge (n - 7) and past it."""
    rng = np.random.default_rng(n)
    offs = rng.integers(0, 22, (6, n)).astype(np.uint8)
    offs[:3] = np.where(rng.random((3, n)) < 0.97, offs[:3] % 20, offs[:3])
    starts = np.array([-3, 0, n - 7, n + 5, 3, n // 2])
    got_v, got_ok = port_windows(_t(offs), _t(starts))
    want_v, want_ok = jax_kmer_windows(jnp.asarray(offs), jnp.asarray(starts))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))


@pytest.mark.parametrize("num_sigs", [11, 65535, 40_009_777,
                                      MOD32_LIMIT, MOD32_LIMIT + 2,
                                      2_000_000_011])
def test_window_homes_fps_equal_jax_both_branches(num_sigs):
    """Homes and fingerprints of every window (valid or not) bit-equal to
    the JAX step's: its int32 residue form up to MOD32_LIMIT slots, its
    int64 form past it."""
    rng = np.random.default_rng(num_sigs % 1000)
    offs = rng.integers(0, 22, (4, 200)).astype(np.uint8)
    offs[:2] %= 20
    starts = np.array([193, 0, 50, 200])
    h, f, ok = window_homes_fps(_t(offs), _t(starts), num_sigs)
    jh, jf, jok = _window_homes_qfp(jnp.asarray(offs), jnp.asarray(starts),
                                    num_sigs)
    np.testing.assert_array_equal(h.numpy().astype(np.int64),
                                  np.asarray(jh).astype(np.int64))
    np.testing.assert_array_equal(f.numpy().astype(np.int64),
                                  np.asarray(jf).astype(np.int64))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def _marked(homes, fps, ok):
    """The kernel's encoding of a window that is not valid."""
    return (np.where(ok, homes, -1), np.where(ok, fps, 0))


@pytest.mark.parametrize("lpad", [8, 9, 256, 700])
def test_twin_aa_rows_equal_jax_step(lpad):
    """The window twin on aa rows (the fused kernel's windows): the JAX
    step's encode and residues (num_starts = lengths - 8), windows that are
    not valid marked home -1."""
    rng = np.random.default_rng(lpad)
    lens = np.array([0, 3, 8, 9, lpad, *rng.integers(0, lpad + 1, 5)])
    mat = rng.choice(AA, (len(lens), lpad)).astype(np.uint8)
    mat[0] = rng.integers(0, 256, lpad)
    mat[np.arange(lpad)[None, :] >= lens[:, None]] = 0
    ns = 1_000_003
    h, f = kmer_windows.windows_reference(
        _t(mat), _t((lens - 8).astype(np.int32)), True, ns)
    offs = jax_encode.aa_offsets(jnp.asarray(mat))
    jh, jf, jok = _window_homes_qfp(offs, jnp.asarray(lens - 8), ns)
    wh, wf = _marked(np.asarray(jh), np.asarray(jf), np.asarray(jok))
    np.testing.assert_array_equal(h.numpy(), wh)
    np.testing.assert_array_equal(f.numpy().astype(np.int64), wf)


@pytest.mark.parametrize("lpad", [24, 256, 301])
def test_twin_dna_rows_equal_jax_step(lpad):
    """The window twin on DNA rows: the JAX step's translation (vmapped)
    and residues with num_starts = max(len//3 - 7, 0)."""
    rng = np.random.default_rng(lpad + 1)
    lens = np.array([0, 5, 23, 24, 25, lpad, *rng.integers(0, lpad + 1, 4)])
    mat = _nt_rows(rng, lpad, lens)
    ns = 40_009_777
    h, f = kmer_windows.windows_reference(_t(mat), _t(lens.astype(np.int32)),
                                          False, ns)
    frames = jax.vmap(jax_translate)(jnp.asarray(mat), jnp.asarray(lens))
    b, _, m = frames.shape
    starts = jnp.repeat(jnp.maximum(jnp.asarray(lens) // 3 - 7, 0), 6)
    jh, jf, jok = _window_homes_qfp(frames.reshape(b * 6, m), starts, ns)
    wh, wf = _marked(*(np.asarray(x).reshape(b, 6, m - 7)
                       for x in (jh, jf, jok)))
    np.testing.assert_array_equal(h.numpy(), wh)
    np.testing.assert_array_equal(f.numpy().astype(np.int64), wf)


@pytest.mark.parametrize("length,win_nt", [(40, 48), (700, 150),
                                           (2000, 99), (5003, 300)])
def test_twin_windowed_rows_equal_jax_window_probe(length, win_nt):
    """The window twin on a long contig's windows: the JAX
    ``_window_probe``'s frame selection by row_map and ownership mask."""
    rng = np.random.default_rng(length)
    seq = rng.choice(NT, length).astype(np.uint8)
    plan = seq_windows.plan_windows(length, win_nt)
    n = len(plan["s"])
    a = np.full((n, win_nt), ord("N"), np.uint8)
    for i in range(n):
        a[i, :plan["len_w"][i]] = seq[plan["s"][i]:plan["e"][i]]
    ns = 1_000_003
    i32 = [plan[k].astype(np.int32) for k in ("len_w", "row_map",
                                               "own_start", "own_end")]
    h, f = kmer_windows.windows_reference(_t(a), _t(i32[0]), False, ns,
                                          *map(_t, i32[1:]))
    frames = jax.vmap(jax_translate)(jnp.asarray(a), jnp.asarray(i32[0]))
    sel = np.take_along_axis(np.asarray(frames), i32[1][:, :, None], axis=1)
    m = sel.shape[2]
    w = m - 7
    jh, jf, jok = _window_homes_qfp(jnp.asarray(sel.reshape(n * 6, m)),
                                    jnp.full((n * 6,), w), ns)
    jj = np.arange(w)[None, None, :]
    ok = (np.asarray(jok).reshape(n, 6, w) & (jj >= i32[2][:, :, None])
          & (jj < i32[3][:, :, None]))
    wh, wf = _marked(np.asarray(jh).reshape(n, 6, w),
                     np.asarray(jf).reshape(n, 6, w), ok)
    np.testing.assert_array_equal(h.numpy(), wh)
    np.testing.assert_array_equal(f.numpy().astype(np.int64), wf)


@pytest.mark.parametrize("aa", [True, False])
def test_twin_values_entry_equals_jax_prepare_math(aa):
    """The window twin's values (the ragged entry's, before compaction):
    the JAX prepare's ``kmer_windows`` values where valid, -1 elsewhere."""
    rng = np.random.default_rng(7)
    lpad = 192
    lens = np.array([0, 7, 30, 100, lpad, 191])
    if aa:
        mat = rng.choice(AA, (len(lens), lpad)).astype(np.uint8)
        mat[np.arange(lpad)[None, :] >= lens[:, None]] = 0
        got = kmer_windows.windows_reference(
            _t(mat), _t((lens - 8).astype(np.int32)), True)
        v, ok = jax_kmer_windows(jax_encode.aa_offsets(jnp.asarray(mat)),
                                 jnp.asarray(lens - 8))
    else:
        mat = _nt_rows(rng, lpad, lens)
        got = kmer_windows.windows_reference(
            _t(mat), _t(lens.astype(np.int32)), False)
        frames = jax.vmap(jax_translate)(jnp.asarray(mat), jnp.asarray(lens))
        starts = jnp.maximum(jnp.asarray(lens) // 3 - 7, 0)
        v, ok = jax_kmer_windows(frames, starts[:, None] * jnp.ones(
            (1, 6), jnp.int64))
    np.testing.assert_array_equal(got.numpy(),
                                  np.where(np.asarray(ok), np.asarray(v), -1))


def test_hostvalues_equal_jax():
    rng = np.random.default_rng(3)
    mat = rng.choice(NT[:24], (5, 400)).astype(np.uint8)
    lens = np.array([400, 399, 398, 250, 30])
    rr = rng.integers(0, 5, 300)
    gg = rng.integers(0, 6, 300)
    cc = rng.integers(0, 2, 300)
    np.testing.assert_array_equal(
        hostvalues.dna_values_at(mat, lens, rr, gg, cc),
        jax_hostvalues.dna_values_at(mat, lens, rr, gg, cc))
    amat = rng.choice(AA[:60], (5, 300)).astype(np.uint8)
    acc = rng.integers(0, 292, 300)
    np.testing.assert_array_equal(
        hostvalues.aa_values_at(amat, rr, acc),
        jax_hostvalues.aa_values_at(amat, rr, acc))


def test_window_plans_equal_jax():
    """plan_windows and plan_aa_windows, array for array, over lengths at
    and around every window edge."""
    for win_nt in (27, 48, 150, 12288):
        for length in {0, 1, 23, 24, 25, win_nt - 1, win_nt, win_nt + 1,
                       3 * win_nt + 7, 50_000}:
            got = seq_windows.plan_windows(length, win_nt)
            want = jax_seq_windows.plan_windows(length, win_nt)
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for win_aa in (8, 9, 64, 4096):
        for length in {0, 7, 8, 9, 16, win_aa, win_aa + 1, 3 * win_aa + 5,
                       20_000}:
            got = seq_windows.plan_aa_windows(length, win_aa)
            want = jax_seq_windows.plan_aa_windows(length, win_aa)
            for k in got:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for bad in ((100, 25), (100, 24)):
        with pytest.raises(ValueError):
            seq_windows.plan_windows(*bad)
    with pytest.raises(ValueError):
        seq_windows.plan_aa_windows(100, 7)
