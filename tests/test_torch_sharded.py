"""The port's sharded lookup (kmergutsjava_tpu_torch/parallel/
sharded_lookup.py) and its shard probe B12 (parallel/shard_probe.py: on the
CPU the kernel's plain twin) against the JAX package's sharded lookup on
its eight virtual CPU devices: B12's answer, summed over the table axis,
equals the JAX step's int32 candidate slot + 1 bit for bit on meshes
(4, 2), (2, 4), (1, 8), (8, 1) and (2, 2); the verified hits equal the
parity scan's; the planes' slot ranges and guards are the JAX module's;
the wrapper runs the twin only for CPU tensors, counts no launch there and
refuses inputs the kernel does not take (KernelError); and the ``sharded``
backend's reports, aa and DNA, are byte-identical to the JAX engine's."""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from kmergutsjava_tpu.formats.kmer_table import build_table as jax_build
from kmergutsjava_tpu.parallel import mesh as jax_mesh
from kmergutsjava_tpu.parallel import sharded_lookup as jax_sharded
from kmergutsjava_tpu_torch.formats.kmer_table import build_table
from kmergutsjava_tpu_torch.lookup.parity import lookup_stream
from kmergutsjava_tpu_torch.lookup.tilejoin import KernelError
from kmergutsjava_tpu_torch.parallel import mesh, shard_probe, sharded_lookup

from test_lookup import make_queries
from test_table import random_signatures
from test_torch_mesh import corpus, both  # noqa: F401  (a fixture)


def tables(seed, n, load):
    """The same signatures as a JAX and a port table (identical slots)."""
    rng = np.random.default_rng(seed)
    sig = random_signatures(rng, n)
    jt = jax_build(**sig, load_factor=load)
    pt = build_table(**sig, load_factor=load)
    np.testing.assert_array_equal(jt.slots, pt.slots)
    return rng, sig, jt, pt


def port_mesh(shape):
    return mesh.make_mesh(*shape, devices=[torch.device("cpu")] * 8)


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 8), (8, 1), (2, 2)])
def test_b12_answers_equal_jax_step(shape):
    """The port's step (B12's twin on every position, psum, read-back)
    gives the JAX sharded step's int32 answer, bit for bit, on the padded
    batch (value 0, home 0 in the padding rows) included; and its verified
    hits equal the parity scan's."""
    rng, sig, jt, pt = tables(sum(shape), 2000, 0.8)
    pw = max(8, pt.max_probe)
    values, cnt, pos = make_queries(rng, sig["kmers"], 4096)
    n_pad = -(-len(values) // (shape[0] * 8)) * shape[0] * 8
    v = np.zeros(n_pad, np.int64)
    v[:len(values)] = values
    homes = (v % pt.num_sigs).astype(np.int32)
    qfp = (v % 65535).astype(np.uint16)

    jm = jax_mesh.make_mesh(*shape)
    jstep, jplanes = jax_sharded.make_sharded_lookup(jm, jt, pw)
    qs = NamedSharding(jm, P("data"))
    want = np.asarray(jax.device_get(jstep(
        jplanes["fp"], jax.device_put(qfp, qs), jax.device_put(homes, qs))))

    m = port_mesh(shape)
    step, planes = sharded_lookup.make_sharded_lookup(m, pt, pw)
    got = mesh.fetch_global(m, step(planes["fp"], qfp, homes))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > len(values) // 4

    found, otu, avg, fi, wt = sharded_lookup.sharded_lookup_queries(
        m, step, planes, values, pt, pad_multiple=8)
    ref = lookup_stream(pt, values, cnt, pos)
    assert int(found.sum()) == len(ref)
    np.testing.assert_array_equal(np.sort(pos[found]), np.sort(ref.pos))


def test_shard_table_planes_ranges_and_guards():
    """Shard t's slice is global slots [t*s_loc, t*s_loc + s_loc + pw),
    FP_EMPTY past the table; a window past 128 and slots past int32 are the
    JAX module's ValueErrors."""
    _, _, jt, pt = tables(5, 1500, 0.7)
    pw = max(8, pt.max_probe)
    planes = sharded_lookup.shard_table_planes(pt, 3, pw)
    s_loc = planes["s_loc"]
    assert s_loc == -(-pt.num_sigs // 3)
    flat = np.full(3 * s_loc + pw, 65535, np.uint16)
    occ = pt.occupied
    flat[:pt.num_sigs][occ] = pt.slots["kmer"][occ] % 65535
    for t in range(3):
        np.testing.assert_array_equal(planes["fp"][t],
                                      flat[t * s_loc:t * s_loc + s_loc + pw])
    with pytest.raises(ValueError, match="probe_window <= 128"):
        sharded_lookup.shard_table_planes(pt, 2, 129)
    with pytest.raises(ValueError, match="probe_window <= 128"):
        jax_sharded.shard_table_planes(jt, 2, 129)

    class Huge:
        num_sigs = 2**31 - 8

    with pytest.raises(ValueError, match="int32"):
        sharded_lookup.shard_table_planes(Huge, 2, 8)


def test_b12_twin_contract():
    """The twin by its definition: the first fingerprint match of the
    window from each owned home (empty slots do not stop it), as global
    slot + 1; 0 for a home outside [lo, lo + s_loc), a negative one
    included, or no match; a fingerprint equal to FP_EMPTY matches empty
    slots."""
    plane = torch.tensor([7, 65535, 9, 7, 65535, 9, 3, 3, 65535, 65535],
                         dtype=torch.int32).to(torch.int16).view(torch.uint16)
    lo, s_loc, w = 100, 6, 4
    homes = torch.tensor([100, 101, 101, 105, 99, 106, -1, 102, 100],
                         dtype=torch.int32)
    q = torch.tensor([9, 9, 3, 3, 7, 3, 7, 11, 65535],
                     dtype=torch.int32).to(torch.int16).view(torch.uint16)
    got = shard_probe.shard_probe(plane, q, homes, lo, s_loc, w)
    assert got.tolist() == [103, 103, 0, 107, 0, 0, 0, 0, 102]


def test_cpu_wrapper_counts_no_launch():
    before = shard_probe.launches
    plane = torch.zeros(20, dtype=torch.uint16)
    out = shard_probe.shard_probe(plane, torch.zeros(5, dtype=torch.uint16),
                                  torch.arange(5, dtype=torch.int32), 0, 12,
                                  8)
    assert out.tolist() == [1, 2, 3, 4, 5]
    assert shard_probe.launches == before


@pytest.mark.parametrize("bad", ["w0", "w129", "homes_i64", "plane_i16",
                                 "short_plane", "length", "int32"])
def test_wrapper_rejects_bad_inputs(bad):
    plane = torch.zeros(40, dtype=torch.uint16)
    q = torch.zeros(4, dtype=torch.uint16)
    h = torch.zeros(4, dtype=torch.int32)
    args = dict(plane=plane, q_fp=q, homes=h, lo=0, s_loc=20, w=16)
    args.update({
        "w0": dict(w=0), "w129": dict(w=129),
        "homes_i64": dict(homes=h.long()),
        "plane_i16": dict(plane=plane.view(torch.int16)),
        "short_plane": dict(s_loc=30), "length": dict(q_fp=q[:3]),
        "int32": dict(lo=2**31 - 30)}[bad])
    with pytest.raises(KernelError):
        shard_probe.shard_probe(**args)


@pytest.mark.parametrize("mode", ["aa", "dna"])
def test_sharded_backend_reports_equal_jax(corpus, mode):  # noqa: F811
    """``--backend sharded`` on the default mesh of eight devices ((4, 2),
    by default_mesh_shape) and at (2, 4): the JAX engine's report."""
    d, texts, _ = corpus
    for shape in (None, (2, 4)):
        got, want = both(d, texts[mode], mode == "aa", backend="sharded",
                         mesh_shape=shape, min_hits=2)
        assert got == want and "CALL\t" in got
