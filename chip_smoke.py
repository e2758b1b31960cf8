#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package (kmergutsjava_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases (one line each; the run stops with a non-zero exit at the first
failure and then prints no result):

1. the card's name and power limit (nvidia-smi); build of the CUDA kernel
   from csrc/tilejoin.cu with nvcc for sm_90a;
2. the tile-join kernel against its plain PyTorch twin on the card: a
   seeded 40M-slot fingerprint plane at load 0.6 with planted empties,
   queried (half planted hits) at the main path's launch shape (2^19
   queries, the engine's DEFAULT_CHUNK, at w=16) and with 4M queries at
   windows 16, 32 and 64; every query's (off, state) must be equal; both
   times are printed;
3. golden: the CLI (``-a -D -q -o --device cuda``) on the E. coli K-12
   proteome (13,645 proteins) against the corpus table must reproduce
   tests/data/golden_aa_full.txt.gz byte for byte, through the kernel;
4. realistic size: the corpus signatures plus seeded random filler, 24M
   signatures at load 0.6 (a 0.96 GB table, an 80 MB plane on the card),
   queried with the whole proteome on cuda and then on cpu; the two reports
   must be byte-identical. Phase times and query rates are printed. Then
   the kernel is held against the twin on that table's plane and pass-1
   window with the proteome's first dispatch of queries.

The line before the last is a JSON object with the kernel's name, source,
the TPU kernel it replaces, its launches in phase 3, its largest
disagreement with the twin, and both times at phase 4's first dispatch;
the last line is ``{"ok": true, "device": {...}}``. Imports nothing of
JAX.
"""
import contextlib
import gzip
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TOTAL_SIGS = 24_000_000
N_SLOTS = 40_000_000  # the 24M-signature table's slots at load 0.6
SEED = 0
BIG_QUERIES = 4_000_000  # about the whole proteome in one launch


def fail(msg: str) -> int:
    print("FAIL: " + msg, flush=True)
    return 1


def to_u16(x):
    """int32 values in [0, 65536) -> uint16 storage."""
    import torch

    return torch.where(x >= 32768, x - 65536, x).to(torch.int16).view(
        torch.uint16)


def timed(fn, dev, reps=5):
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    by CUDA events on the current stream."""
    import torch

    fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def synthetic_probe(dev, w, n_queries, n_slots=N_SLOTS, seed=SEED):
    """A seeded u16 plane of ``n_slots`` (+ w slots of padding) at load 0.6
    with planted empties, its last fifth full (so full windows occur), and
    ``n_queries`` (q_fp, homes), half of them planted hits."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    raw = torch.randint(0, 65535, (n_slots + w,), generator=g, device=dev,
                        dtype=torch.int32)
    head = n_slots * 4 // 5  # the tail holds no empties: full windows
    empty = torch.rand(n_slots + w, generator=g, device=dev) < 0.4
    empty[head:] = False
    raw[empty] = 65535
    raw[n_slots:] = 65535  # the w-slot padding of the real plane
    homes = torch.randint(0, n_slots, (n_queries,), generator=g, device=dev,
                          dtype=torch.int32)
    at = homes.long() + torch.randint(0, w, (n_queries,), generator=g,
                                      device=dev)
    qv = torch.randint(0, 65535, (n_queries,), generator=g, device=dev,
                       dtype=torch.int32)
    planted = torch.rand(n_queries, generator=g, device=dev) < 0.5
    qv = torch.where(planted & (raw[at] != 65535), raw[at], qv)
    return to_u16(raw), to_u16(qv), homes


def check_kernel(dev, label, fp, q_fp, homes, w):
    """The wrapper's (off, state) against the twin's for every query, and
    both times; returns (max_abs_err, kernel_ms, twin_ms)."""
    import torch

    from kmergutsjava_tpu_torch.lookup import tilejoin

    off_k, st_k = tilejoin.tilejoin_probe(fp, q_fp, homes, w)
    off_t, st_t = tilejoin.first_event_reference(fp, q_fp, homes, w)
    torch.cuda.synchronize(dev)
    err = max(int((off_k.int() - off_t.int()).abs().max()),
              int((st_k.int() - st_t.int()).abs().max()))
    states = torch.bincount(st_k.long(), minlength=3).tolist()
    k_ms = timed(lambda: tilejoin.tilejoin_probe(fp, q_fp, homes, w), dev)
    t_ms = timed(lambda: tilejoin.first_event_reference(fp, q_fp, homes, w),
                 dev)
    print(f"{label}: w={w} slots={fp.numel() - w} queries={homes.numel()} "
          f"states(0/1/2)={states} max_abs_err={err} "
          f"kernel_ms={k_ms:.4f} twin_ms={t_ms:.4f}", flush=True)
    return err, k_ms, t_ms


def kernel_vs_twin(dev, cases):
    """Phase 2: {(w, n_queries): (max_abs_err, kernel_ms, twin_ms)}."""
    return {(w, n): check_kernel(dev, "phase 2", *synthetic_probe(dev, w, n),
                                 w)
            for w, n in cases}


def load_proteome():
    from kmergutsjava_tpu_torch.formats.fasta import read_fasta

    return list(read_fasta(os.path.join(HERE, "tests", "data",
                                         "Ecoli_K12_W3110.faa.gz")))


def corpus_signatures(prots):
    """The corpus table recipe of tests/corpus_util.py: every protein
    except each third contributes its 8-mers, function = index mod 97,
    otu = index mod 20."""
    from kmergutsjava_tpu_torch.formats.table_tools import \
        signatures_from_proteins

    return signatures_from_proteins(
        [(p.seq, i % 97, i % 20) for i, p in enumerate(prots) if i % 3 != 2])


FUNCS = [f"ecoli function {i}" for i in range(97)]


def run_cli(data_dir, faa, out_path, device, extra=()):
    """The user's entry point, in-process; returns (info lines, seconds)."""
    from kmergutsjava_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):  # -o routes info lines to stdout
        rc = cli.main(["-a", "-D", data_dir, "-q", faa, "-o", out_path,
                       "--device", device, *extra])
    secs = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}: {buf.getvalue()}")
    return buf.getvalue(), secs


def phase_ms(info: str):
    got = {}
    for line in info.splitlines():
        for name in ("Preparation", "Lookup", "Grouping"):
            if line.startswith(name + " time: "):
                got[name] = int(line.split(": ")[1].split()[0])
    return got


def query_values(faa):
    """The query 8-mer values the prepare phase feeds the lookup, in order."""
    import numpy as np

    from kmergutsjava_tpu_torch.models.prepare import (prepare_aa_numpy,
                                                       try_prepare_bulk)
    from kmergutsjava_tpu_torch.formats.fasta import read_fasta

    class Collect:
        def __init__(self):
            self.parts = []

        def add_batch(self, values, cnt_id, pos):
            self.parts.append(np.array(values, np.int64))

    c = Collect()
    if try_prepare_bulk(faa, None, c) is None:
        prepare_aa_numpy(read_fasta(faa), c)
    return np.concatenate(c.parts)


def real_chunk_check(dev, table, values):
    """The kernel against the twin at one main-path launch: the first
    dispatch's queries (as StreamingLookup forms them) on the table's own
    plane and pass-1 window."""
    import torch

    from kmergutsjava_tpu_torch.lookup.sparse import FP_MOD, SparseLookup

    lk = SparseLookup(table, device=str(dev))
    v = values[:lk.chunk]
    homes = torch.from_numpy((v % lk.num_sigs).astype("int32")).to(dev)
    q_fp = torch.from_numpy((v % FP_MOD).astype("uint16")).to(dev)
    res = check_kernel(dev, "phase 4: first dispatch", lk.fp, q_fp, homes,
                       lk.w1)
    return lk.w1, res


def write_proteome(prots, path):
    with open(path, "w") as fh:
        fh.write("".join(f">{p.id} {p.descr}\n{p.seq}\n" for p in prots))


def golden_run(dev, work, prots, sig):
    """Phase 3. Returns the kernel launches of the CLI run."""
    from kmergutsjava_tpu_torch.formats.table_tools import write_data_dir
    from kmergutsjava_tpu_torch.lookup import tilejoin

    d = os.path.join(work, "corpus")
    write_data_dir(d, sig, FUNCS, load_factor=0.7)
    faa = os.path.join(work, "proteome.faa")
    write_proteome(prots, faa)
    out = os.path.join(work, "golden_report.txt")
    tilejoin.launches = 0
    info, secs = run_cli(d, faa, out, dev.type)
    launches = tilejoin.launches
    with gzip.open(os.path.join(HERE, "tests", "data",
                                "golden_aa_full.txt.gz"), "rb") as fh:
        want = fh.read()
    with open(out, "rb") as fh:
        got = fh.read()
    print(f"phase 3: golden_aa_full proteins={len(prots)} "
          f"report_bytes={len(got)} identical={got == want} "
          f"launches={launches} wall_s={secs:.3f} {phase_ms(info)}",
          flush=True)
    if got != want:
        raise RuntimeError("report differs from golden_aa_full")
    if launches <= 0:
        raise RuntimeError("the main path launched no tile-join kernel")
    return launches, faa


def big_table(work, sig, total_sigs=TOTAL_SIGS):
    """The realistic data dir: the corpus signatures plus seeded random
    filler up to ``total_sigs`` at load 0.6. Returns (dir, table, filler)."""
    import numpy as np

    from kmergutsjava_tpu_torch.constants import MAX_ENCODED
    from kmergutsjava_tpu_torch.formats.table_tools import write_data_dir

    rng = np.random.default_rng(SEED)
    need = total_sigs - len(sig["kmers"])
    filler = np.unique(rng.integers(0, MAX_ENCODED, int(need * 1.05) + 1000,
                                    dtype=np.int64))
    filler = filler[~np.isin(filler, sig["kmers"])]
    filler = rng.permutation(filler)[:need]
    m = len(filler)
    big = dict(
        kmers=np.concatenate([sig["kmers"], filler]),
        otu=np.concatenate([sig["otu"],
                            rng.integers(0, 20, m).astype(np.int32)]),
        avg_from_end=np.concatenate([sig["avg_from_end"], rng.integers(
            0, 500, m).astype(np.int32)]),
        fi=np.concatenate([sig["fi"], rng.integers(0, 97, m).astype(
            np.int32)]),
        wt=np.concatenate([sig["wt"], rng.random(m).astype(np.float32)]))
    d = os.path.join(work, "big")
    return d, write_data_dir(d, big, FUNCS, load_factor=0.6), m


def realistic_run(dev, work, sig, faa):
    """Phase 4: the proteome against a large table, cuda then cpu."""
    from kmergutsjava_tpu_torch.lookup import tilejoin

    t0 = time.time()
    d, table, m = big_table(work, sig)
    values = query_values(faa)
    n_q = len(values)
    print(f"phase 4: table sigs={len(sig['kmers']) + m} (corpus "
          f"{len(sig['kmers'])} + filler {m}) slots={table.num_sigs} "
          f"max_probe={table.max_probe} file_bytes="
          f"{os.path.getsize(os.path.join(d, 'kmer.table.mem_map'))} "
          f"query_kmers={n_q} setup_s={time.time() - t0:.3f}", flush=True)
    reports = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(work, f"big_{device}.txt")
        tilejoin.launches = 0
        info, secs = run_cli(d, faa, out, device)
        ms = phase_ms(info)
        with open(out, "rb") as fh:
            reports[device] = fh.read()
        pl = (ms["Preparation"] + ms["Lookup"]) / 1000.0
        print(f"phase 4: device={device} wall_s={secs:.3f} "
              f"preparation_ms={ms['Preparation']} lookup_ms={ms['Lookup']} "
              f"grouping_ms={ms['Grouping']} "
              f"queries_per_s_prepare_plus_lookup={n_q / max(pl, 1e-9):.1f} "
              f"queries_per_s_wall={n_q / secs:.1f} "
              f"launches={tilejoin.launches}", flush=True)
        if (tilejoin.launches > 0) != (device == "cuda"):
            raise RuntimeError(f"{device} run made {tilejoin.launches} "
                               "kernel launches")
    same = reports["cuda"] == reports["cpu"]
    print(f"phase 4: cuda_report_bytes={len(reports['cuda'])} "
          f"cpu_report_bytes={len(reports['cpu'])} identical={same}",
          flush=True)
    if not same:
        raise RuntimeError("cuda and cpu reports differ")
    return real_chunk_check(dev, table, values)


def main() -> int:
    try:
        import torch
    except ImportError as ex:
        return fail(f"torch: {ex}")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    try:
        from kmergutsjava_tpu_torch.lookup import tilejoin
        from kmergutsjava_tpu_torch.lookup.sparse import SparseLookup
    except ImportError as ex:
        return fail(f"the port's package is not beside this script: {ex}")
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}",
          flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.time()
    tilejoin.load_kernel()
    print(f"phase 1: built {os.path.relpath(tilejoin.SOURCE, HERE)} "
          f"(nvcc {' '.join(tilejoin.NVCC_FLAGS)}) in "
          f"{time.time() - t0:.3f} s", flush=True)

    # the main path's launch (one dispatch of 2^19 queries, w1 = 16 on the
    # realistic table) first, then whole-proteome launches at wider windows
    chunk = SparseLookup.DEFAULT_CHUNK
    cmp = kernel_vs_twin(dev, ((16, chunk), (16, BIG_QUERIES),
                               (32, BIG_QUERIES), (64, BIG_QUERIES)))
    for (w, n), (err, _, _) in cmp.items():
        if err != 0:
            return fail(f"kernel and twin disagree at w={w}, n={n}")

    with tempfile.TemporaryDirectory(prefix="kmer_smoke_") as work:
        prots = load_proteome()
        sig = corpus_signatures(prots)
        launches, faa = golden_run(dev, work, prots, sig)
        w1, (err, k_ms, t_ms) = realistic_run(dev, work, sig, faa)
    if err != 0:
        return fail(f"kernel and twin disagree on the first dispatch (w={w1})")

    print(json.dumps({"kernels": [{
        "name": "tilejoin_first_event",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/tilejoin.cu",
        "replaces": "kmergutsjava_tpu/lookup/pallas_tilejoin.py:145",
        "launches": launches,
        "max_abs_err": max([err] + [e for e, _, _ in cmp.values()]),
        "ms": k_ms,
        "plain_ms": t_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
