"""The port's randomized rounds, in the manner of scripts/soak.py's: each
seed builds a random signature table (load 0.3-0.95, random weights and
thinning, sometimes gzipped; written by the port's formats/table_tools.py)
and a random query set (aa or DNA: mutations, reverse strands, N runs,
duplicate ids), with random grouping parameters, sometimes debug mode and
sometimes a small ``-l`` (store spills, stream passes). Each round runs the
port's parity, xla, stream, pallas, auto and spmd backends (from stdin or
from a file, 1-4 native threads), its mesh backends (sharded on a 2x2
mesh, routed over 4 shards, replicated over 2 positions, ``auto`` and
``spmd`` on a 2x2 mesh: positions repeated on one device), ``auto`` with
``--grouping scan``, ``xla`` with ``--sort-chunks 1`` (with
``--device-sort`` half the time), ``xla`` with ``--prepare jax`` and, in
rounds without debug, a checkpoint run at a random batch size; every
report, debug timing lines masked (``_strip``), must equal the round's
reference report.

Imports only numpy, torch and the port (no JAX), so a GPU machine without
JAX runs it: tests/test_torch_soak.py holds the rounds on the CPU to the
JAX ``parity`` engine, tests/test_torch_kernels.py's ``cuda`` soak and
chip_smoke.py's phase 16 hold them on the card to the port's ``parity``
engine on the CPU."""
import io
import os
import random
import re

import numpy as np

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
# the mesh runs: (backend, mesh_shape), one position a cell of the shape
MESH_RUNS = (("sharded", (2, 2)),
             ("routed", (1, 4)),
             ("replicated", (2, 1)),
             ("auto", (2, 2)),
             ("spmd", (2, 2)))
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


def mesh_positions(device, shape):
    """A mesh's positions, all on ``device`` (``cuda`` as card 0)."""
    return [("cuda:0" if device == "cuda" else device)] * (shape[0]
                                                          * shape[1])


def engine_report(d, q, fasta, cfg):
    """The stripped report of one Engine run, from the file ``q`` or, with
    ``q`` None, from the FASTA text on a stream."""
    out = io.StringIO()
    Engine(cfg).run(d, q, out, stdout=True,
                    query_stream=None if q else io.StringIO(fasta))
    return _strip(out.getvalue())


def port_reports(seed, tmp, rng, d, fasta, kw, device, setenv):
    """Yield (label, stripped report) for each of the round's port runs on
    ``device``, in order; ``rng`` is the round's (from make_round), and
    ``setenv(name, value)`` sets each run's native thread count."""
    q = os.path.join(tmp, f"q{seed}.fa")
    with open(q, "w") as fh:
        fh.write(fasta)
    runs = ([(b, {}) for b in PORT_BACKENDS]
            + [(b, dict(mesh_shape=shape,
                        mesh_devices=mesh_positions(device, shape)))
               for b, shape in MESH_RUNS]
            + [(b, dict(extra)) for b, extra in EXTRA_RUNS])
    for backend, extra in runs:
        setenv("KMER_NATIVE_THREADS", str(rng.randint(1, 4)))
        from_file = rng.random() < 0.5
        if extra.get("sort_chunks"):  # on the host or the device
            extra = dict(extra, device_sort=rng.random() < 0.5)
        cfg = EngineConfig(backend=backend, device=device, **extra, **kw)
        yield (f"port {backend} on {device} ({extra}, "
               f"from_file={from_file})",
               engine_report(d, q if from_file else None, fasta, cfg))
    if not kw["debug"]:
        batch = rng.randint(1, 7)
        op, cp = (os.path.join(tmp, f"o{seed}.txt"),
                  os.path.join(tmp, f"c{seed}.ckpt"))
        run_with_checkpoint(EngineConfig(device=device, **kw), d, q, op, cp,
                            batch_groups=batch, progress=False)
        with open(op) as fh:
            yield (f"port checkpoint run on {device} (batch {batch})",
                   _strip(fh.read()))


def parity_report(d, fasta, kw):
    """The round's reference on the port: its ``parity`` engine on the
    CPU, from a stream."""
    return engine_report(d, None, fasta, EngineConfig(
        backend="parity", device="cpu", **kw))
