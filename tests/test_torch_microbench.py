"""The ports of the two timing harnesses' kernels, on the CPU through their
plain twins, against the JAX scripts they come from:

- B5: ``lookup/stream.stream_probe_reps`` (the stream probe with a
  repetition axis, behind ``kmergutsjava_tpu_torch/scripts/microbench_probe``)
  against ``scripts/microbench_probe.stream_reps`` in interpret mode, its
  layout converted;
- B4: ``lookup/tjgather.tjgather_probe`` against the Pallas ``kernel`` of
  ``scripts/sweep.py`` ``section_tjgather.make_probe``, run under
  ``pltpu.force_tpu_interpret_mode()``. The probe is a closure inside the
  section; the test reaches it by loading the script with a 1 MB plane and
  one cap, making its ``rep_loop`` the identity and its ``measure`` a
  function that takes the probe from the loop's defaults and runs it on
  seeded operands with planted matches and empties.

Exact: every int32 must be equal. The scripts' command-line entry points
are checked where they need no card."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from kmergutsjava_tpu.lookup.pallas_stream import BLOCK, HALO, ROWS
from kmergutsjava_tpu_torch.lookup import stream, tjgather
from kmergutsjava_tpu_torch.scripts import microbench_probe, sweep

from test_torch_kernels import _stream_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("w", [16, 24])
def test_stream_reps_matches_jax_microbench_interpret(w):
    jax_mb = _load_script("microbench_probe")
    nsuper, channels = 2, 4
    n_slots = nsuper * ROWS * BLOCK
    fp, tiles = _stream_inputs(n_slots, w, channels, seed=100 + w)
    before = stream.reps_launches
    got = stream.stream_probe_reps(fp, tiles, w, channels, reps=2)
    assert stream.reps_launches == before  # the CPU runs the twin
    flat = np.concatenate([fp.numpy(), np.full(HALO - w, 65535, np.uint16)])
    fp_blocks = np.ascontiguousarray(np.lib.stride_tricks.as_strided(
        flat, shape=(nsuper * ROWS, BLOCK + HALO), strides=(2 * BLOCK, 2)))
    qt = tiles.numpy().reshape(channels, nsuper, ROWS, BLOCK)
    out = jax_mb.stream_reps(
        fp_blocks.reshape(nsuper, ROWS, BLOCK + HALO),
        np.ascontiguousarray(qt.transpose(1, 0, 2, 3)), nsuper, w, reps=2,
        channels=channels, interpret=True)
    want = np.asarray(out).transpose(1, 0, 2, 3).reshape(channels // 4, -1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != want[0, 0]).any()


def test_microbench_operands_plant_matches():
    """Half the tile cells of a row hold a plane value from their window, so
    the twin that each row is held against answers more than ``w``."""
    fp, tiles = microbench_probe.stream_operands(3001, device="cpu")
    assert tiles.shape == (stream.CHANNELS, 3004) and fp.numel() == 3004 + 16
    first = stream.stream_probe_reference(fp, tiles, 16).view(
        torch.uint8).reshape(-1).long()
    share = float((first < 16).float().mean())
    assert 0.45 < share < 0.55


def _planted(plane3, ids, packed, seed):
    """Copies of the section's operands with 30% of the plane empty, a
    third of the cells moved to offsets up to 127 (their windows run past
    the tile's last row) and half the cells carrying the value found a
    random offset (< 16) into their column, so candidates, empties and
    misses all occur."""
    rng = np.random.default_rng(seed)
    p3 = np.asarray(plane3).copy()
    p3[rng.random(p3.shape) < 0.3] = 65535
    pk = np.asarray(packed).copy()
    pk = np.where(rng.random(pk.shape) < 1 / 3,
                  (pk & ~127) | rng.integers(0, 128, pk.shape), pk)
    rr, off = (pk >> 7) & 127, pk & 127
    tile = (np.asarray(ids)[:, None, None, None] * tjgather.TPG
            + np.arange(tjgather.TPG)[None, :, None, None])
    at = np.minimum(off + rng.integers(0, 16, pk.shape), 127)
    v = p3[np.broadcast_to(tile, pk.shape), at, rr].astype(np.int64)
    plant = rng.random(pk.shape) < 0.5
    pk = np.where(plant, (v << 14) | (rr << 7) | off, pk).astype(np.int32)
    return p3, pk


def test_tjgather_twin_matches_sweep_kernel_interpret(monkeypatch):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("SWEEP_PLANE_MB", "1")
    monkeypatch.setenv("SWEEP_TJG_CAPS", "128")
    sw = _load_script("sweep")
    got = {}

    def measure(name, work, loop, args, **kw):
        # the section deletes its packed variants when measure returns, so
        # the probe runs here
        probe = loop.__defaults__[0]
        plane3, ids, pk_nb = args
        p3, pk = _planted(plane3, ids, pk_nb[0], seed=3)
        with pltpu.force_tpu_interpret_mode():
            out = probe(jnp.asarray(p3), ids, jnp.asarray(pk))
        got.update(p3=p3, ids=np.array(ids), pk=pk, out=np.asarray(out))

    monkeypatch.setattr(sw, "rep_loop", lambda body: body)
    monkeypatch.setattr(sw, "measure", measure)
    sw.section_tjgather()
    assert got["p3"].shape == (32, 128, 128) and got["pk"].shape == (
        4, 8, 1, 128)
    t = torch.from_numpy
    before = tjgather.launches
    key = tjgather.tjgather_probe(t(got["p3"]), t(got["ids"]), t(got["pk"]))
    assert tjgather.launches == before  # the CPU runs the twin
    assert key.dtype == torch.int32
    np.testing.assert_array_equal(key.numpy(), got["out"])
    k = key.numpy()
    assert ((k < 32) & (k % 2 == 0)).any() and (k % 2 == 1).any()
    assert (k == 32).any()


def test_tjgather_off_plane_super_tile_and_chunking():
    """A super-tile whose id names no tile gives 2 * w in every cell;
    chunk boundaries change nothing."""
    rng = np.random.default_rng(9)
    plane3 = rng.integers(0, 60000, (16, 128, 128)).astype(np.uint16)
    ids = np.array([1, 0, 2, -1], np.int32)  # 2 and -1 name no tiles
    pk = rng.integers(0, 2**31 - 1, (4, 8, 2, 128)).astype(np.int32)
    p3, pk = _planted(plane3, np.clip(ids, 0, 1), pk, seed=10)
    t = torch.from_numpy
    a = tjgather.tjgather_reference(t(p3), t(ids), t(pk))
    b = tjgather.tjgather_reference(t(p3), t(ids), t(pk), chunk=1000)
    assert torch.equal(a, b)
    assert (a[2:] == 32).all() and (a[:2] < 32).any()


def test_sweep_operands_have_the_packed_fields():
    plane3, ids = sweep.make_plane(16, "cpu")
    assert plane3.shape == (16, 128, 128) and plane3.dtype == torch.uint16
    assert ids.tolist() == [0, 1]
    pk = sweep.make_packed(ids.numel(), 256, 3, "cpu")
    assert pk.shape == (3, 2, 8, 2, 128) and pk.dtype == torch.int32
    assert int((pk & 127).max()) < 128 - sweep.W
    assert int(pk.min()) >= 0 and int((pk >> 14).max()) < 65536
    assert sweep.plane_tiles(512) == 16384


def test_scripts_refuse_without_a_card_or_a_ported_section(capsys):
    assert sweep.main(["sparse"]) == 2
    assert sweep.main(["nope"]) == 2
    assert "not ported" in capsys.readouterr().err
    if torch.cuda.is_available():
        return
    assert sweep.main([]) == 1
    assert microbench_probe.main() == 1


@pytest.mark.parametrize("bad", ["reps0", "reps_big", "w65"])
def test_stream_reps_rejects_bad_inputs(bad):
    fp, tiles = _stream_inputs(512, 16, 4, seed=1)
    reps = {"reps0": 0, "reps_big": stream.MAX_REPS + 1}.get(bad, 2)
    w = 65 if bad == "w65" else 16
    with pytest.raises(stream.KernelError):
        stream.stream_probe_reps(fp, tiles, w, 4, reps)
