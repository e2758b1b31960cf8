#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package (kmergutsjava_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases (one line each; the run stops with a non-zero exit at the first
failure and then prints no result):

1. the card's name and power limit (nvidia-smi); build of the CUDA kernels
   (csrc/tilejoin.cu and csrc/stream_probe.cu, one nvcc each, started
   together) for sm_90a;
2. the tile-join kernel against its plain PyTorch twin on the card: a
   seeded 40M-slot fingerprint plane at load 0.6 with planted empties,
   queried (half planted hits) at the main path's launch shape (2^19
   queries, the engine's DEFAULT_CHUNK, at w=16) and with 4M queries at
   windows 16, 32 and 64; every query's (off, state) must be equal; both
   times are printed;
3. golden: the CLI (``-a -D -q -o --device cuda``) on the E. coli K-12
   proteome (13,645 proteins) against the corpus table must reproduce
   tests/data/golden_aa_full.txt.gz byte for byte, with ``auto`` (dense
   against this table, so through the stream kernel) and with
   ``--backend xla`` (through the tile-join kernel);
4. realistic size: the corpus signatures plus seeded random filler, 24M
   signatures at load 0.6 (a 0.96 GB table, an 80 MB plane on the card),
   queried with the whole proteome on cuda and then on cpu; the two reports
   must be byte-identical. Phase times and query rates are printed. Then
   the kernel is held against the twin on that table's plane and pass-1
   window with the proteome's first dispatch of queries;
5. the stream kernel against its plain PyTorch twin on the card: a seeded
   40M-slot plane at load 0.6 with tiles filled as a dense read set fills
   them (Poisson(0.6) distinct queries a slot, so some slots use all 4
   channels), at w=24 (the realistic table's window) and w=64 (the cap);
   every int32 must be equal; both times are printed;
6. golden DNA: the CLI (no ``-a``, ``-q`` the 4.64 Mbp genome, ``--device
   cuda``) with ``auto`` deciding from the file size must reproduce
   tests/data/golden_dna_full.txt.gz byte for byte through the stream
   kernel (and no tile-join launch); the same run on ``--device cpu``
   (the twin) too;
7. realistic dense size: phase 4's table queried with a seeded read set
   (120,000 reads of 150 bp from the genome: uniform starts, either strand,
   1% substitutions; 22.5M query 8-mers once stop codons end their
   windows, past numSigs/2.5 and past the 20M input_size_limit), so
   ``auto`` takes the stream path in two plane passes; its report must equal the ``--backend xla`` report byte for
   byte. Phase times, query rates and passes are printed; then the kernel
   is held against the twin on one pass's real tiles, with the tiles'
   upload and the answer's read-back timed.

The line before the last is a JSON object with each kernel's name, source,
the TPU kernel it replaces, its launches on the main path (phase 4's cuda
run for the tile join, phase 6's cuda run for the stream kernel), its
largest disagreement with the twin, and both times at the real shapes
(phase 4's first dispatch, phase 7's pass); the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
import contextlib
import gzip
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TOTAL_SIGS = 24_000_000
N_SLOTS = 40_000_000  # the 24M-signature table's slots at load 0.6
SEED = 0
BIG_QUERIES = 4_000_000  # about the whole proteome in one launch
N_READS, READ_LEN = 120_000, 150  # phase 7's read set
INPUT_SIZE_LIMIT = 20_000_000  # the engine's default -l: queries a pass


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


def run_cli(data_dir, query, out_path, device, extra=(), aa=True):
    """The user's entry point, in-process; returns (info lines, seconds)."""
    from kmergutsjava_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):  # -o routes info lines to stdout
        rc = cli.main([*(["-a"] if aa else []), "-D", data_dir, "-q", query,
                       "-o", out_path, "--device", device, *extra])
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


def query_values(path, aa=True):
    """The query 8-mer values the prepare phase feeds the lookup, in order."""
    import numpy as np

    from kmergutsjava_tpu_torch.models.prepare import (prepare_aa_numpy,
                                                       prepare_dna_numpy,
                                                       try_prepare_bulk)
    from kmergutsjava_tpu_torch.formats.fasta import read_fasta

    class Collect:
        def __init__(self):
            self.parts = []

        def add_batch(self, values, cnt_id, pos):
            self.parts.append(np.array(values, np.int64))

    c = Collect()
    if try_prepare_bulk(path, None, c, aa) is None:
        (prepare_aa_numpy if aa else prepare_dna_numpy)(read_fasta(path), c)
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
    """Phase 3: the proteome through ``auto`` (the stream kernel: the
    proteome is dense against the corpus table) and ``--backend xla`` (the
    tile-join kernel). Returns (data dir, proteome path)."""
    from kmergutsjava_tpu_torch.formats.table_tools import write_data_dir
    from kmergutsjava_tpu_torch.lookup import stream, tilejoin

    d = os.path.join(work, "corpus")
    write_data_dir(d, sig, FUNCS, load_factor=0.7)
    faa = os.path.join(work, "proteome.faa")
    write_proteome(prots, faa)
    with gzip.open(os.path.join(HERE, "tests", "data",
                                "golden_aa_full.txt.gz"), "rb") as fh:
        want = fh.read()
    for backend, kernel in (("auto", stream), ("xla", tilejoin)):
        out = os.path.join(work, f"golden_aa_{backend}.txt")
        tilejoin.launches = stream.launches = 0
        info, secs = run_cli(d, faa, out, dev.type, ("--backend", backend))
        counts = dict(tilejoin=tilejoin.launches, stream=stream.launches)
        with open(out, "rb") as fh:
            got = fh.read()
        print(f"phase 3: golden_aa_full backend={backend} proteins="
              f"{len(prots)} report_bytes={len(got)} identical={got == want} "
              f"launches={counts} wall_s={secs:.3f} {phase_ms(info)}",
              flush=True)
        if got != want:
            raise RuntimeError(f"{backend} report differs from golden_aa_full")
        if kernel.launches <= 0 or sum(counts.values()) != kernel.launches:
            raise RuntimeError(f"{backend} run launched {counts}")
    return d, faa


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
    """Phase 4: the proteome against a large table, cuda then cpu. Returns
    (dir, table, B1 launches of the cuda run, real_chunk_check's result)."""
    from kmergutsjava_tpu_torch.lookup import stream, tilejoin

    t0 = time.time()
    d, table, m = big_table(work, sig)
    values = query_values(faa)
    n_q = len(values)
    print(f"phase 4: table sigs={len(sig['kmers']) + m} (corpus "
          f"{len(sig['kmers'])} + filler {m}) slots={table.num_sigs} "
          f"max_probe={table.max_probe} file_bytes="
          f"{os.path.getsize(os.path.join(d, 'kmer.table.mem_map'))} "
          f"query_kmers={n_q} setup_s={time.time() - t0:.3f}", flush=True)
    reports, launches = {}, 0
    for device in ("cuda", "cpu"):
        out = os.path.join(work, f"big_{device}.txt")
        tilejoin.launches = stream.launches = 0
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
        if (tilejoin.launches > 0) != (device == "cuda") or stream.launches:
            raise RuntimeError(f"{device} run made {tilejoin.launches} "
                               f"tile-join and {stream.launches} stream "
                               "kernel launches")
        if device == "cuda":
            launches = tilejoin.launches
    same = reports["cuda"] == reports["cpu"]
    print(f"phase 4: cuda_report_bytes={len(reports['cuda'])} "
          f"cpu_report_bytes={len(reports['cpu'])} identical={same}",
          flush=True)
    if not same:
        raise RuntimeError("cuda and cpu reports differ")
    return d, table, launches, real_chunk_check(dev, table, values)


def dense_tiles(dev, w, n_slots=N_SLOTS, channels=4, seed=SEED):
    """A seeded u16 plane of ``n_slots`` (+ w FP_EMPTY slots) at load 0.6
    and tiles [channels, n_slots] as a dense read set fills them: slot s
    holds Poisson(0.6) distinct queries (channel c used iff more than c),
    half of them planted a random offset into the window, the rest random;
    unused cells hold 0."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed + w)
    raw = torch.randint(0, 65535, (n_slots + w,), generator=g, device=dev,
                        dtype=torch.int32)
    raw[torch.rand(n_slots + w, generator=g, device=dev) < 0.4] = 65535
    raw[n_slots:] = 65535
    count = torch.poisson(torch.full((n_slots,), 0.6, device=dev),
                          generator=g)
    chan = torch.arange(channels, device=dev)[:, None]
    used = chan < count[None, :]
    at = (torch.arange(n_slots, device=dev)[None, :]
          + torch.randint(0, w, (channels, n_slots), generator=g,
                          device=dev))
    qv = torch.randint(0, 65535, (channels, n_slots), generator=g,
                       device=dev, dtype=torch.int32)
    planted = torch.rand((channels, n_slots), generator=g, device=dev) < 0.5
    qv = torch.where(planted, raw[at], qv)
    qv = torch.where(used, qv, 0)
    return to_u16(raw), to_u16(qv).contiguous(), used


def check_stream_kernel(dev, label, fp, tiles, w):
    """The wrapper's packed output against the twin's, every int32, and both
    times; returns (max_abs_err, kernel_ms, twin_ms)."""
    import torch

    from kmergutsjava_tpu_torch.lookup import stream

    got = stream.stream_probe(fp, tiles, w, tiles.shape[0])
    want = stream.stream_probe_reference(fp, tiles, w, tiles.shape[0])
    torch.cuda.synchronize(dev)
    err = int((got.long() - want.long()).abs().max())
    k_ms = timed(lambda: stream.stream_probe(fp, tiles, w, tiles.shape[0]),
                 dev)
    t_ms = timed(lambda: stream.stream_probe_reference(fp, tiles, w,
                                                       tiles.shape[0]), dev)
    print(f"{label}: w={w} slots={tiles.shape[1]} channels={tiles.shape[0]} "
          f"max_abs_err={err} kernel_ms={k_ms:.4f} twin_ms={t_ms:.4f}",
          flush=True)
    return err, k_ms, t_ms


def stream_vs_twin(dev):
    """Phase 5: {w: (max_abs_err, kernel_ms, twin_ms)}."""
    import torch

    res = {}
    for w in (24, 64):
        fp, tiles, used = dense_tiles(dev, w)
        per_slot = used.sum(0)
        print(f"phase 5: w={w} queries_per_slot={float(per_slot.float().mean()):.4f} "
              f"slots_by_channels_used={torch.bincount(per_slot, minlength=5).tolist()}",
              flush=True)
        res[w] = check_stream_kernel(dev, "phase 5", fp, tiles, w)
        del fp, tiles, used
    return res


def write_genome(path):
    """The E. coli K-12 W3110 genome as a plain FASTA file; returns its
    sequence."""
    from kmergutsjava_tpu_torch.formats.fasta import read_fasta

    g = next(iter(read_fasta(os.path.join(HERE, "tests", "data",
                                          "Ecoli_K12_W3110.fna.gz"))))
    with open(path, "w") as fh:
        fh.write(f">{g.id} {g.descr}\n{g.seq}\n")
    return g.seq


def golden_dna_run(work, d, fna):
    """Phase 6: the genome through ``auto`` (the stream kernel), cuda then
    cpu. Returns the stream kernel's launches of the cuda run."""
    from kmergutsjava_tpu_torch.lookup import stream, tilejoin

    with gzip.open(os.path.join(HERE, "tests", "data",
                                "golden_dna_full.txt.gz"), "rb") as fh:
        want = fh.read()
    launches = 0
    for device in ("cuda", "cpu"):
        out = os.path.join(work, f"golden_dna_{device}.txt")
        tilejoin.launches = stream.launches = 0
        info, secs = run_cli(d, fna, out, device, aa=False)
        counts = dict(tilejoin=tilejoin.launches, stream=stream.launches)
        with open(out, "rb") as fh:
            got = fh.read()
        print(f"phase 6: golden_dna_full device={device} report_bytes="
              f"{len(got)} identical={got == want} launches={counts} "
              f"wall_s={secs:.3f} {phase_ms(info)}", flush=True)
        if got != want:
            raise RuntimeError(f"{device} report differs from golden_dna_full")
        if counts["tilejoin"] or (counts["stream"] > 0) != (device == "cuda"):
            raise RuntimeError(f"{device} run launched {counts}")
        if device == "cuda":
            launches = counts["stream"]
    return launches


def write_reads(path, genome, n_reads=N_READS, read_len=READ_LEN,
                seed=SEED):
    """Phase 7's read set: ``n_reads`` reads of ``read_len`` bases drawn
    with numpy ``seed`` from the genome: uniform starts, either strand, 1%
    substitutions (each to one of the three other bases)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome.encode("latin-1"), np.uint8)
    starts = rng.integers(0, len(g) - read_len + 1, n_reads)
    reads = g[starts[:, None] + np.arange(read_len)]
    code = np.full(256, 0, np.uint8)
    code[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    idx = code[reads]
    rc = rng.random(n_reads) < 0.5
    idx[rc] = (3 - idx[rc])[:, ::-1]
    subs = rng.random(idx.shape) < 0.01
    idx[subs] = (idx[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
    text = np.frombuffer(b"ACGT", np.uint8)[idx]
    with open(path, "w") as fh:
        fh.write("".join(f">r{i}\n{row.tobytes().decode()}\n"
                         for i, row in enumerate(text)))


def dense_run(dev, work, d, table, genome):
    """Phase 7: the read set against phase 4's table, ``auto`` (the stream
    kernel, two plane passes) against ``--backend xla`` on the card, then
    the kernel against the twin on the tiles of one pass's worth of the
    real queries (the first input_size_limit). Returns
    (max_abs_err, kernel_ms, twin_ms)."""
    import torch

    from kmergutsjava_tpu_torch.lookup import stream, tilejoin
    from kmergutsjava_tpu_torch.lookup.stream import StreamLookup

    t0 = time.time()
    fna = os.path.join(work, "reads.fna")
    write_reads(fna, genome)
    values = query_values(fna, aa=False)
    n_q = len(values)
    print(f"phase 7: reads={N_READS}x{READ_LEN}bp query_kmers={n_q} "
          f"slots={table.num_sigs} crossover={table.num_sigs / 2.5:.0f} "
          f"fasta_bytes={os.path.getsize(fna)} setup_s={time.time() - t0:.3f}",
          flush=True)
    reports = {}
    for backend, kernel in (("auto", stream), ("xla", tilejoin)):
        out = os.path.join(work, f"reads_{backend}.txt")
        tilejoin.launches = stream.launches = 0
        info, secs = run_cli(d, fna, out, "cuda", ("--backend", backend),
                             aa=False)
        counts = dict(tilejoin=tilejoin.launches, stream=stream.launches)
        ms = phase_ms(info)
        with open(out, "rb") as fh:
            reports[backend] = fh.read()
        pl = (ms["Preparation"] + ms["Lookup"]) / 1000.0
        print(f"phase 7: backend={backend} wall_s={secs:.3f} "
              f"preparation_ms={ms['Preparation']} lookup_ms={ms['Lookup']} "
              f"grouping_ms={ms['Grouping']} "
              f"queries_per_s_prepare_plus_lookup={n_q / max(pl, 1e-9):.1f} "
              f"queries_per_s_wall={n_q / secs:.1f} launches={counts}",
              flush=True)
        if kernel.launches <= 0 or sum(counts.values()) != kernel.launches:
            raise RuntimeError(f"{backend} run launched {counts}")
        if backend == "auto" and counts["stream"] < 2:
            # one launch a plane pass; past input_size_limit queries, two
            raise RuntimeError(f"auto made {counts['stream']} plane passes "
                               f"for {n_q} queries")
    same = reports["auto"] == reports["xla"]
    print(f"phase 7: report_bytes={len(reports['auto'])} "
          f"auto_equals_xla={same}", flush=True)
    if not same:
        raise RuntimeError("the stream and xla reports differ")

    lk = StreamLookup(table, device=str(dev))
    tiles, *_ = lk._scatter(values[:INPUT_SIZE_LIMIT])  # one pass's worth
    host = torch.from_numpy(tiles)
    torch.cuda.synchronize(dev)
    t0 = time.time()
    dev_tiles = host.to(dev)
    torch.cuda.synchronize(dev)
    up_ms = (time.time() - t0) * 1000
    res = check_stream_kernel(dev, "phase 7: one pass's tiles", lk.fp,
                              dev_tiles, lk.w)
    out = stream.stream_probe(lk.fp, dev_tiles, lk.w, lk.channels)
    torch.cuda.synchronize(dev)
    t0 = time.time()
    out.cpu()
    down_ms = (time.time() - t0) * 1000
    print(f"phase 7: w={lk.w} tiles_mb={tiles.nbytes / 2**20:.1f} "
          f"upload_ms={up_ms:.3f} out_mb={out.numel() * 4 / 2**20:.1f} "
          f"readback_ms={down_ms:.3f} cells_used="
          f"{int((tiles != 0).sum())}", flush=True)
    return res


def build_kernels():
    """Phase 1: one nvcc per kernel source, started together."""
    from kmergutsjava_tpu_torch.lookup import stream, tilejoin

    errors = []

    def build(mod):
        try:
            mod.load_kernel()
        except Exception as ex:  # noqa: BLE001 — re-raised below
            errors.append(ex)

    t0 = time.time()
    threads = [threading.Thread(target=build, args=(m,))
               for m in (tilejoin, stream)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    print(f"phase 1: built {os.path.relpath(tilejoin.SOURCE, HERE)} and "
          f"{os.path.relpath(stream.SOURCE, HERE)} (nvcc "
          f"{' '.join(tilejoin.NVCC_FLAGS)}) in {time.time() - t0:.3f} s",
          flush=True)


def main() -> int:
    try:
        import torch
    except ImportError as ex:
        return fail(f"torch: {ex}")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    try:
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
    build_kernels()

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
        corpus, faa = golden_run(dev, work, prots, sig)
        big, table, tj_launches, (w1, (err, k_ms, t_ms)) = realistic_run(
            dev, work, sig, faa)
        if err != 0:
            return fail("kernel and twin disagree on the first dispatch "
                        f"(w={w1})")
        s_cmp = stream_vs_twin(dev)
        for w, (e, _, _) in s_cmp.items():
            if e != 0:
                return fail(f"stream kernel and twin disagree at w={w}")
        genome = write_genome(os.path.join(work, "genome.fna"))
        st_launches = golden_dna_run(work, corpus,
                                     os.path.join(work, "genome.fna"))
        s_err, s_ms, s_plain_ms = dense_run(dev, work, big, table, genome)
    if s_err != 0:
        return fail("stream kernel and twin disagree on a pass's real tiles")

    print(json.dumps({"kernels": [{
        "name": "tilejoin_first_event",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/tilejoin.cu",
        "replaces": "kmergutsjava_tpu/lookup/pallas_tilejoin.py:145",
        "launches": tj_launches,
        "max_abs_err": max([err] + [e for e, _, _ in cmp.values()]),
        "ms": k_ms,
        "plain_ms": t_ms,
    }, {
        "name": "stream_probe",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/stream_probe.cu",
        "replaces": "kmergutsjava_tpu/lookup/pallas_stream.py:81",
        "launches": st_launches,
        "max_abs_err": max([s_err] + [e for e, _, _ in s_cmp.values()]),
        "ms": s_ms,
        "plain_ms": s_plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
