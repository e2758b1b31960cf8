"""Randomized differential of the port against the JAX package, in the
manner of scripts/soak.py's rounds: each seed builds a random signature
table (load 0.3-0.95, random weights and thinning, sometimes gzipped) and a
random query set (aa or DNA: mutations, reverse strands, N runs, duplicate
ids), with random grouping parameters, sometimes debug mode and sometimes a
small ``-l`` (store spills, stream passes). The port's parity, xla, stream,
pallas, auto and spmd backends on the CPU (from stdin or from a file, 1-4
native threads), its mesh backends (sharded on a 2x2 mesh, routed over 4
shards, replicated over 2 devices: ``mesh_devices`` of CPU positions) and
``auto`` with ``--mesh 2x2``, ``auto`` with ``--grouping scan``, ``xla`` with
``--sort-chunks 1`` (with ``--device-sort`` half the time), ``xla`` with
``--prepare jax`` (the window kernel's ragged entry's twin), and a port
checkpoint run at a random batch size must each be byte-equal to the JAX
``parity`` Engine (debug timing lines masked). A few seeds run in the tier-1 suite; ``-m slow`` runs many
more."""
import io
import os
import random
import re

import numpy as np
import pytest

from kmergutsjava_tpu.config import EngineConfig as JaxConfig
from kmergutsjava_tpu.models.pipeline import Engine as JaxEngine
from kmergutsjava_tpu_torch.config import EngineConfig
from kmergutsjava_tpu_torch.formats.table_tools import (signatures_from_proteins,
                                                        write_data_dir)
from kmergutsjava_tpu_torch.models.checkpoint import run_with_checkpoint
from kmergutsjava_tpu_torch.models.pipeline import Engine

AA = "ACDEFGHIKLMNPQRSTVWY"
CODON = {"A": "GCT", "C": "TGT", "D": "GAT", "E": "GAA", "F": "TTT",
         "G": "GGT", "H": "CAT", "I": "ATT", "K": "AAA", "L": "CTT",
         "M": "ATG", "N": "AAT", "P": "CCT", "Q": "CAA", "R": "CGT",
         "S": "TCT", "T": "ACT", "V": "GTT", "W": "TGG", "Y": "TAT"}
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
PORT_BACKENDS = ("parity", "xla", "stream", "pallas", "auto", "spmd")
# the mesh runs: (backend, mesh_shape, mesh_devices)
MESH_RUNS = (("sharded", (2, 2), ["cpu"] * 4),
             ("routed", (1, 4), ["cpu"] * 4),
             ("replicated", (2, 1), ["cpu"] * 2),
             ("auto", (2, 2), ["cpu"] * 4))
# the runs of the grouping kernel (host grouping in debug rounds and at
# min_hits < 2, as in the JAX engine), of the sparse probe with its
# chunks home-sorted and of the device prepare
EXTRA_RUNS = (("auto", dict(grouping_impl="scan")),
              ("xla", dict(sort_chunks=True)),
              ("xla", dict(prepare_impl="jax")))
# debug reports embed timing and progress info lines
_DROP = re.compile(r"^(Temp\. directory:|Preparation time:|Lookup time:"
                   r"|Grouping time:|Processed: )")


def _strip(text):
    return "\n".join(line for line in text.splitlines()
                     if not _DROP.match(line))


def make_round(seed, tmp):
    """One round's data dir, FASTA text and engine keywords."""
    rng = random.Random(seed)
    n_funcs = rng.randint(2, 12)
    prots = ["".join(rng.choice(AA) for _ in range(rng.randint(10, 200)))
             for _ in range(rng.randint(5, 80))]
    triples = [(p, rng.randrange(n_funcs), rng.randrange(12)) for p in prots]
    weights = ({i: rng.random() * 3 for i in range(n_funcs)}
               if rng.random() < 0.5 else None)
    sig = signatures_from_proteins(triples, weights=weights)
    if rng.random() < 0.5 and len(sig["kmers"]) > 10:  # thin: some misses
        frac = rng.uniform(0.4, 0.95)
        keep = np.asarray([rng.random() < frac for _ in sig["kmers"]])
        sig = {k: v[keep] for k, v in sig.items()}
    d = os.path.join(tmp, f"d{seed}")
    write_data_dir(d, sig, [f"func {i}" for i in range(n_funcs)],
                   load_factor=rng.choice([0.3, 0.6, 0.8, 0.9, 0.95]),
                   gz=rng.random() < 0.2)
    aa = rng.random() < 0.5
    records = []
    for i in range(rng.randint(3, 60)):
        p = rng.choice(prots)
        if aa:
            seq = p if rng.random() < 0.7 else "".join(
                rng.choice(AA) for _ in range(rng.randint(9, 150)))
            if rng.random() < 0.3 and len(seq) > 12:
                at = rng.randrange(len(seq))
                seq = seq[:at] + rng.choice(AA) + seq[at + 1:]
        else:
            seq = "".join(CODON[c] for c in p)
            if rng.random() < 0.4:
                seq = "".join(COMP[c] for c in reversed(seq))
            if rng.random() < 0.4:
                seq = "".join(rng.choice("ACGTnN")
                              for _ in range(rng.randrange(0, 7))) + seq
            if rng.random() < 0.2:
                seq = "".join(rng.choice("ACGTN")
                              for _ in range(rng.randint(20, 400)))
        records.append((f"s{i}", seq))
    if rng.random() < 0.3 and len(records) > 2:  # duplicate ids
        k = rng.randrange(len(records) - 1)
        records[k] = (records[-1][0], records[k][1])
    fasta = "".join(f">{rid} desc\n{seq}\n" for rid, seq in records)
    kw = dict(aa=aa, min_hits=rng.choice([2, 2, 3, 5]),
              max_gap=rng.choice([10, 50, 200, 600]),
              order_constraint=rng.random() < 0.2,
              min_weighted_hits=rng.choice([0, 0, 2]),
              debug=rng.random() < 0.1)
    if rng.random() < 0.25:
        kw["input_size_limit"] = rng.randint(40, 400)
        kw["temp_dir"] = os.path.join(tmp, f"t{seed}")
        os.makedirs(kw["temp_dir"], exist_ok=True)
    return rng, d, fasta, kw


def run_round(seed, tmp, monkeypatch):
    rng, d, fasta, kw = make_round(seed, tmp)
    out = io.StringIO()
    JaxEngine(JaxConfig(backend="parity", **kw)).run(
        d, None, out, stdout=True, query_stream=io.StringIO(fasta))
    base = _strip(out.getvalue())
    q = os.path.join(tmp, f"q{seed}.fa")
    with open(q, "w") as fh:
        fh.write(fasta)
    runs = ([(b, None, None, {}) for b in PORT_BACKENDS]
            + [(b, shape, devs, {}) for b, shape, devs in MESH_RUNS]
            + [(b, None, None, extra) for b, extra in EXTRA_RUNS])
    for backend, shape, devices, extra in runs:
        monkeypatch.setenv("KMER_NATIVE_THREADS", str(rng.randint(1, 4)))
        from_file = rng.random() < 0.5
        if extra.get("sort_chunks"):  # on the host or the device
            extra = dict(extra, device_sort=rng.random() < 0.5)
        out = io.StringIO()
        Engine(EngineConfig(backend=backend, device="cpu", mesh_shape=shape,
                            mesh_devices=devices, **extra, **kw)).run(
            d, q if from_file else None, out, stdout=True,
            query_stream=None if from_file else io.StringIO(fasta))
        assert _strip(out.getvalue()) == base, (
            f"seed {seed}: port {backend} (mesh {shape}, {extra}, "
            f"from_file={from_file}) diverged from the JAX parity engine")
    if not kw["debug"]:
        batch = rng.randint(1, 7)
        op, cp = os.path.join(tmp, f"o{seed}.txt"), os.path.join(
            tmp, f"c{seed}.ckpt")
        run_with_checkpoint(EngineConfig(device="cpu", **kw), d, q, op, cp,
                            batch_groups=batch, progress=False)
        with open(op) as fh:
            assert _strip(fh.read()) == base, (
                f"seed {seed}: port checkpoint run (batch {batch}) diverged "
                "from the JAX parity engine")


# between them: aa and DNA, spills, duplicate ids, debug, a gzipped table
@pytest.mark.parametrize("seed", [11, 12, 15, 18, 20, 24, 26, 28, 30])
def test_soak_round(seed, tmp_path, monkeypatch):
    run_round(seed, str(tmp_path), monkeypatch)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(1000, 1400))
def test_soak_round_many(seed, tmp_path, monkeypatch):
    run_round(seed, str(tmp_path), monkeypatch)
