#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package (kmergutsjava_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases (one line each; the run stops with a non-zero exit at the first
failure and then prints no result):

1. the card's name and power limit (nvidia-smi); build of the CUDA kernels
   (csrc/tilejoin.cu, csrc/stream_probe.cu, csrc/block_probe.cu and
   csrc/tjgather.cu, one nvcc each, started together) for sm_90a;
2. the tile-join kernel against its plain PyTorch twin on the card: a
   seeded 40M-slot fingerprint plane at load 0.6 with planted empties,
   queried (half planted hits) at the main path's launch shape (eight
   dispatches of 2^19 queries, the engine's DEFAULT_CHUNK, at w=16,
   launched in turn; the kernel's device time a chunk from a torch.profiler
   trace, and the wrapper's time a call) and with 4M queries in one launch
   at windows 16, 32 and 64 (CUDA events); every query's (off, state) must
   be equal; the twin's time is printed too;
3. golden: the CLI (``-a -D -q -o --device cuda``) on the E. coli K-12
   proteome (13,645 proteins) against the corpus table must reproduce
   tests/data/golden_aa_full.txt.gz byte for byte, with ``auto`` (dense
   against this table, so through the stream kernel), with
   ``--backend xla`` (through the tile-join kernel) and with ``--backend
   pallas`` (through the block probe, its exact rest through the tile
   join);
4. realistic size: the corpus signatures plus seeded random filler, 24M
   signatures at load 0.6 (a 0.96 GB table, an 80 MB plane on the card),
   queried with the whole proteome on cuda and then on cpu; the two reports
   must be byte-identical. Phase times and query rates are printed. Then
   the kernel is held against the twin on that table's plane and pass-1
   window at the engine's own launches: the proteome's eight dispatches,
   uploaded and launched in order by SparseLookup, each launch's device
   time from a torch.profiler trace (the L2 flushed before each run of
   the eight), and the wrapper's time a call back to back (``call_ms``);
5. the stream kernel against its plain PyTorch twin on the card: a seeded
   40M-slot plane at load 0.6 with tiles filled as a dense read set fills
   them (Poisson(0.6) distinct queries a slot, so some slots use all 4
   channels, half of them planted), at w=24 (the realistic table's window)
   and w=64 (the cap), and a worst case at w=64 with every used cell
   planted; every int32 must be equal; both times and the share of cells
   that the kernel had to list (the rest it answers from a presence
   bitmap) are printed;
6. golden DNA: the CLI (no ``-a``, ``-q`` the 4.64 Mbp genome, ``--device
   cuda``) with ``auto`` deciding from the file size must reproduce
   tests/data/golden_dna_full.txt.gz byte for byte through the stream
   kernel (and no tile-join launch); the same run on ``--device cpu``
   (the twin) too, and ``--backend pallas`` on cuda (the block probe);
7. realistic dense size: phase 4's table queried with a seeded read set
   (120,000 reads of 150 bp from the genome: uniform starts, either strand,
   1% substitutions; 22.5M query 8-mers once stop codons end their
   windows, past numSigs/2.5 and past the 20M input_size_limit), so
   ``auto`` takes the stream path in two plane passes, and ``--backend
   pallas`` spills once and runs one block-probe launch; both reports must
   equal the ``--backend xla`` report byte for byte. Phase times, query
   rates and launches are printed; then the stream kernel is held against
   the twin on one pass's real tiles, with the tiles' upload and the
   answer's read-back timed;
8. the block probe against its plain PyTorch twin on that table's plane,
   with the read set's queries in prepare's order and in the store's
   (home, value) order (the engine's); every (off, state) must be equal;
   both times are printed;
9. the stream kernel's repetition launch (4 reps) against the twin on phase
   5's w=24 operands, every int32 equal; then the ported microbenchmark
   (kmergutsjava_tpu_torch/scripts/microbench_probe.py): its real-table
   check and its stream rows (4M, 64M, 128M slots at 64, 16, 8 reps, w=16),
   each row's timed launch equal to the twin on the row's operands;
10. the ported sweep's lane-gather section
   (kmergutsjava_tpu_torch/scripts/sweep.py, a 512 MB plane, caps 256 and
   512), then the lane-gather kernel against its twin at that shape with
   planted matches and empties, every key equal; both times are printed;
11. the port's JSON-RPC server and restartable runs on phase 4's table,
   on the card (kmergutsjava_tpu_torch/service/server.py in this process,
   driven by service/client.py): ``warm`` (its probe window must be phase
   4's), the proteome by path (phase 4's cuda report byte for byte, B1
   launched as often as in phase 4 and nothing else, served by the lookup
   ``warm`` built), four inline requests of 1,000 proteins at once (each
   equal to the CLI's report of the same text), ``_annotate_submit`` and
   ``_check_job`` (equal to the sync report), phase 7's read set with
   ``backend: "stream"`` (phase 7's report, two B2 launches and nothing
   else), the proteome again (the one-slot lookup cache then builds xla's
   lookup cold), and the ok counts of /metrics; a second server started
   without ``--warm`` in a process of its own, beside a bare process that
   only imports torch and creates the CUDA context; then the CLI with
   ``--checkpoint --checkpoint-every 2000`` (7 batches) against a single
   run, both cold, and a crash in the 4th batch with a torn tail, resumed
   by a fresh process: both outputs must equal phase 4's cuda report.
   Every request and run prints its wall time.

Each kernel's line also prints its bound (``bound_ms``: the larger of
the bytes it must move over the card's memory rate and one integer
operation an input element over its INT32 rate; ``bound_by``) and its
share of the bound (bound_ms / kernel_ms).

Every run that drives a path (the CLI runs, the microbenchmark's rows, the
sweep, the server's requests) starts with every launch count at 0 and must
launch its kernels and no others. The line before the last is a JSON object with each kernel's
name, source, the TPU kernel it replaces, its launches on its path (phase
4's cuda run for the tile join, phase 6's cuda ``auto`` run for the stream
kernel, phase 7's ``pallas`` run for the block probe, phase 9's rows for
the repetition launch, phase 10's sweep for the lane gather), its largest
disagreement with the twin, both times at the real shapes (phase 4's
device time of a full dispatch, with the wrapper's ``call_ms`` beside it;
phase 7's pass; phases 8, 9 and 10), the bound and share at those shapes,
and ``library_ms`` null (no single PyTorch call computes a first-event
window probe); the last line is
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
# the card's published rates (H100 SXM, 700 W): device memory, and INT32
# lanes (132 SMs x 64 lanes x 1.98 GHz boost clock)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of ``nbytes`` over the card's memory
    rate and ``ops`` integer operations over its INT32 rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / INT32_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def bound_window_probe(plane_slots, n):
    """B1 and B3: each query's fingerprint and home in and its two code
    bytes out (8 B), and the plane's 32-byte sectors its window touches,
    at most the whole plane; one operation a query and plane slot."""
    return bound(8 * n + min(2 * plane_slots, 32 * n),
                 n + min(plane_slots, 16 * n))


def bound_stream(slots, channels, w, reps=1):
    """B2 and B5: the plane (slots + w) and the tiles read, the packed
    answer written, once a rep; one operation a plane slot and cell."""
    return bound(reps * (2 * (slots + w) + 3 * channels * slots),
                 reps * (slots + w + channels * slots))


def bound_tjgather(plane_slots, cells):
    """B4: the plane tiles read, each packed cell read and its key
    written; one operation a plane slot and cell."""
    return bound(2 * plane_slots + 8 * cells, plane_slots + cells)


def bound_fields(k_ms, bnd):
    """A phase line's bound and share of it."""
    return (f"bound_ms={bnd[0]:.4f} bound_by={bnd[1]} "
            f"share={bnd[0] / k_ms:.3f}")


def fail(msg: str) -> int:
    print("FAIL: " + msg, flush=True)
    return 1


def kernel_modules():
    """The kernel wrappers' modules, by the name their counts print under."""
    from kmergutsjava_tpu_torch.lookup import (blockprobe, stream, tilejoin,
                                               tjgather)

    return dict(tilejoin=tilejoin, stream=stream, blockprobe=blockprobe,
                tjgather=tjgather)


def reset_counts():
    """Every kernel's launch count to 0 (the repetition launch's too)."""
    mods = kernel_modules()
    for m in mods.values():
        m.launches = 0
    mods["stream"].reps_launches = 0


def read_counts():
    mods = kernel_modules()
    got = {name: m.launches for name, m in mods.items()}
    got["stream_reps"] = mods["stream"].reps_launches
    return got


def check_launches(label, counts, must, may=()):
    """Each kernel in ``must`` launched, and none outside ``must`` and
    ``may``."""
    missing = [k for k in must if counts[k] <= 0]
    extra = [k for k, n in counts.items()
             if n and k not in must and k not in may]
    if missing or extra:
        raise RuntimeError(f"{label} launched {counts}: missing {missing}, "
                           f"unexpected {extra}")


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


L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2


def kernel_device_ms(run, dev, marker, reps=5):
    """Device milliseconds of each kernel whose name holds ``marker``, in
    the order one ``run()`` launches them, averaged over ``reps`` runs:
    the kernel events (CUPTI's device timestamps) of a torch.profiler
    trace, read from its Chrome trace as chip_profile.py reads it. Before
    each run a 256 MB write evicts the L2 and the card is synchronised, so
    each run starts as cold as the engine's first chunk and its launches
    overlap nothing. ``run()`` launches no other kernel, so the flush
    kernels (an add over the buffer) split the trace into runs on the
    device's own clock. The tracer can drop a kernel's record: a run that
    does not show the most common count is left out, and a trace that
    keeps fewer than half of the runs is taken again (three traces at
    most). Returns (the milliseconds, the number of runs kept)."""
    import torch

    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    run()  # warm-up
    torch.cuda.synchronize(dev)
    for attempt in range(3):
        try:
            return _traced_runs(run, dev, marker, reps, flush)
        except RuntimeError as ex:
            print(f"kernel_device_ms: trace {attempt + 1} of 3: {ex}",
                  flush=True)
    raise RuntimeError(f"no whole trace of *{marker}* kernels in 3 tries")


def _traced_runs(run, dev, marker, reps, flush):
    """One torch.profiler trace of ``reps`` flushed runs; see
    kernel_device_ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.add_(1)  # a kernel (a fill can become a memset)
            torch.cuda.synchronize(dev)
            run()
            torch.cuda.synchronize(dev)
    with tempfile.TemporaryDirectory(prefix="kmer_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            kernels = sorted((e["ts"], e["dur"], marker in e.get("name", ""))
                             for e in json.load(fh)["traceEvents"]
                             if e.get("ph") == "X"
                             and e.get("cat") in ("kernel", "gpu_memset"))
    per_run = []
    for _, dur, mine in kernels:
        if not mine:  # a flush: the next run starts
            per_run.append([])
        elif per_run:
            per_run[-1].append(dur)
    counts = [len(r) for r in per_run]
    k = max(set(counts), key=counts.count, default=0)
    whole = [r for r in per_run if len(r) == k]
    if k == 0 or 2 * len(whole) < reps:
        raise RuntimeError(f"the trace holds runs of {counts} kernels "
                           f"named *{marker}* for {reps} runs")
    return [sum(r[i] for r in whole) / len(whole) / 1000.0
            for i in range(k)], len(whole)


def chunk_spans(n, chunk):
    """The engine's dispatches of ``n`` queries: ``chunk`` each, in order,
    the rest last (as StreamingLookup forms them)."""
    return [(s, min(s + chunk, n)) for s in range(0, n, chunk)]


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
    both times; returns (max_abs_err, kernel_ms, twin_ms, bound)."""
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
    bnd = bound_window_probe(fp.numel(), homes.numel())
    print(f"{label}: w={w} slots={fp.numel() - w} queries={homes.numel()} "
          f"states(0/1/2)={states} max_abs_err={err} "
          f"kernel_ms={k_ms:.4f} twin_ms={t_ms:.4f} "
          f"{bound_fields(k_ms, bnd)}", flush=True)
    return err, k_ms, t_ms, bnd


def check_chunks(dev, label, fp, w, chunks, run, chunk):
    """The kernel against the twin at the engine's dispatches: ``run()``
    launches one kernel for each of ``chunks`` ((q_fp, homes) on the card,
    ``chunk`` queries each but the last) in order and returns their (off,
    state) answers. Every answer is held against the twin; then the device
    time of each launch (kernel_device_ms) and the wrapper's time a call,
    back to back on the same chunks (CUDA events: the host's work around
    the launch included). Prints and returns (max_abs_err, device ms of a
    full chunk, twin_ms, bound of a full chunk, call_ms)."""
    import numpy as np
    import torch

    from kmergutsjava_tpu_torch.lookup import tilejoin

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    err, states = 0, np.zeros(3, np.int64)
    for (q, h), (off, st) in zip(chunks, run()):
        off_t, st_t = tilejoin.first_event_reference(fp, q, h, w)
        err = max(err, int(np.abs(host(off).astype(np.int64)
                                  - host(off_t)).max()),
                  int(np.abs(host(st).astype(np.int64)
                             - host(st_t)).max()))
        states += np.bincount(host(st), minlength=3)
    reps = 5
    ms, kept = kernel_device_ms(run, dev, "first_event", reps)
    full = [m for m, (_, h) in zip(ms, chunks) if h.numel() == chunk]
    k_ms = sum(full) / len(full)
    call_ms = timed(lambda: [tilejoin.tilejoin_probe(fp, q, h, w)
                             for q, h in chunks], dev) / len(chunks)
    t_ms = timed(lambda: tilejoin.first_event_reference(fp, *chunks[0], w),
                 dev)
    bnd = bound_window_probe(fp.numel(), chunk)
    print(f"{label}: w={w} slots={fp.numel() - w} queries="
          f"{sum(h.numel() for _, h in chunks)} chunks={len(chunks)} of "
          f"{chunk} states(0/1/2)={states.tolist()} max_abs_err={err} "
          f"device_ms_full_chunk={k_ms:.5f} runs_kept={kept}/{reps} "
          f"device_ms_by_chunk="
          f"{[round(m, 5) for m in ms]} call_ms={call_ms:.5f} "
          f"twin_ms={t_ms:.4f} {bound_fields(k_ms, bnd)}", flush=True)
    return err, k_ms, t_ms, bnd, call_ms


def synthetic_chunks(dev, w, chunk, count=8):
    """Phase 2's engine-shaped case: ``count`` dispatches of ``chunk``
    queries on the synthetic plane, each launched once by the wrapper in
    order. Returns check_chunks' result."""
    from kmergutsjava_tpu_torch.lookup import tilejoin

    fp, q_fp, homes = synthetic_probe(dev, w, count * chunk)
    chunks = [(q_fp[s:e], homes[s:e])
              for s, e in chunk_spans(homes.numel(), chunk)]
    return check_chunks(
        dev, "phase 2", fp, w, chunks,
        lambda: [tilejoin.tilejoin_probe(fp, q, h, w) for q, h in chunks],
        chunk)


def kernel_vs_twin(dev, cases):
    """Phase 2: {(w, n_queries): (max_abs_err, kernel_ms, twin_ms,
    bound)}; the case of the engine's chunk size runs eight dispatches of
    it (synthetic_chunks, device time a chunk), the others one launch each
    (check_kernel, CUDA events)."""
    from kmergutsjava_tpu_torch.lookup.sparse import SparseLookup

    out = {}
    for w, n in cases:
        if n == SparseLookup.DEFAULT_CHUNK:
            out[w, n] = synthetic_chunks(dev, w, n)[:4]
        else:
            out[w, n] = check_kernel(dev, "phase 2",
                                     *synthetic_probe(dev, w, n), w)
    return out


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


def engine_launches(lk, chunks):
    """One run of the engine's pass-1 probes, as SparseLookup.lookup makes
    them: each chunk's (q_fp, homes) uploaded and launched by
    dispatch_probe in order, then each answer read back by resolve_probe.
    Returns the (off, state) answers."""
    pending = [lk.dispatch_probe(q, h) for q, h in chunks]
    return [lk.resolve_probe(p) for p in pending]


def engine_chunks(lk, values):
    """The (q_fp, homes) host arrays of the engine's dispatches of
    ``values`` on lookup ``lk``."""
    import numpy as np

    from kmergutsjava_tpu_torch.lookup.sparse import FP_MOD

    return [((values[s:e] % FP_MOD).astype(np.uint16),
             (values[s:e] % lk.num_sigs).astype(np.int32))
            for s, e in chunk_spans(len(values), lk.chunk)]


def real_chunk_check(dev, table, values):
    """The kernel against the twin at the main path's own launches: the
    whole proteome's dispatches (as StreamingLookup forms them: eight, of
    2^19 queries but the last) on the table's own plane and pass-1 window,
    launched in order through SparseLookup, so that each chunk's windows
    are as cold as the engine finds them. Returns (w1, check_chunks'
    result)."""
    import torch

    from kmergutsjava_tpu_torch.lookup.sparse import SparseLookup

    lk = SparseLookup(table, device=str(dev))
    chunks = engine_chunks(lk, values)
    on_card = [(torch.from_numpy(q).to(dev), torch.from_numpy(h).to(dev))
               for q, h in chunks]
    res = check_chunks(dev, "phase 4: engine dispatches", lk.fp, lk.w1,
                       on_card, lambda: engine_launches(lk, chunks),
                       lk.chunk)
    return lk.w1, res


def write_proteome(prots, path):
    with open(path, "w") as fh:
        fh.write("".join(f">{p.id} {p.descr}\n{p.seq}\n" for p in prots))


# the kernels each backend's cuda run must launch, and those it may launch
# (the block probe's exact rest runs the tile join)
BACKEND_KERNELS = {"auto": (("stream",), ()), "xla": (("tilejoin",), ()),
                   "pallas": (("blockprobe",), ("tilejoin",))}


def golden_run(dev, work, prots, sig):
    """Phase 3: the proteome through ``auto`` (the stream kernel: the
    proteome is dense against the corpus table), ``--backend xla`` (the
    tile-join kernel) and ``--backend pallas`` (the block probe). Returns
    (data dir, proteome path)."""
    from kmergutsjava_tpu_torch.formats.table_tools import write_data_dir

    d = os.path.join(work, "corpus")
    write_data_dir(d, sig, FUNCS, load_factor=0.7)
    faa = os.path.join(work, "proteome.faa")
    write_proteome(prots, faa)
    with gzip.open(os.path.join(HERE, "tests", "data",
                                "golden_aa_full.txt.gz"), "rb") as fh:
        want = fh.read()
    for backend in ("auto", "xla", "pallas"):
        out = os.path.join(work, f"golden_aa_{backend}.txt")
        reset_counts()
        info, secs = run_cli(d, faa, out, dev.type, ("--backend", backend))
        counts = read_counts()
        with open(out, "rb") as fh:
            got = fh.read()
        print(f"phase 3: golden_aa_full backend={backend} proteins="
              f"{len(prots)} report_bytes={len(got)} identical={got == want} "
              f"launches={counts} wall_s={secs:.3f} {phase_ms(info)}",
              flush=True)
        if got != want:
            raise RuntimeError(f"{backend} report differs from golden_aa_full")
        check_launches(f"phase 3 {backend}", counts, *BACKEND_KERNELS[backend])
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
        reset_counts()
        info, secs = run_cli(d, faa, out, device)
        counts = read_counts()
        ms = phase_ms(info)
        with open(out, "rb") as fh:
            reports[device] = fh.read()
        pl = (ms["Preparation"] + ms["Lookup"]) / 1000.0
        print(f"phase 4: device={device} wall_s={secs:.3f} "
              f"preparation_ms={ms['Preparation']} lookup_ms={ms['Lookup']} "
              f"grouping_ms={ms['Grouping']} "
              f"queries_per_s_prepare_plus_lookup={n_q / max(pl, 1e-9):.1f} "
              f"queries_per_s_wall={n_q / secs:.1f} "
              f"launches={counts['tilejoin']}", flush=True)
        check_launches(f"phase 4 {device}", counts,
                       ("tilejoin",) if device == "cuda" else ())
        if device == "cuda":
            launches = counts["tilejoin"]
    same = reports["cuda"] == reports["cpu"]
    print(f"phase 4: cuda_report_bytes={len(reports['cuda'])} "
          f"cpu_report_bytes={len(reports['cpu'])} identical={same}",
          flush=True)
    if not same:
        raise RuntimeError("cuda and cpu reports differ")
    return d, table, launches, real_chunk_check(dev, table, values)


def dense_tiles(dev, w, n_slots=N_SLOTS, channels=4, seed=SEED,
                planted_frac=0.5):
    """A seeded u16 plane of ``n_slots`` (+ w FP_EMPTY slots) at load 0.6
    and tiles [channels, n_slots] as a dense read set fills them: slot s
    holds Poisson(0.6) distinct queries (channel c used iff more than c),
    ``planted_frac`` of them planted a random offset into the window, the
    rest random; unused cells hold 0."""
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
    planted = (torch.rand((channels, n_slots), generator=g, device=dev)
               < planted_frac)
    qv = torch.where(planted, raw[at], qv)
    qv = torch.where(used, qv, 0)
    return to_u16(raw), to_u16(qv).contiguous(), used


def listed_share(fp, tiles, w):
    """The share of tile cells that the stream kernel lists to answer by a
    scan or a table lookup: those whose fingerprint occurs among the plane
    values staged for their span (stream.SPAN slots and the w - 1 values
    after them); every other cell's answer is w at once."""
    import torch

    from kmergutsjava_tpu_torch.lookup.stream import SPAN
    from kmergutsjava_tpu_torch.lookup.tilejoin import _widen

    c, s = tiles.shape
    dev = tiles.device
    span = torch.arange(-(-s // SPAN), device=dev)
    # the last span stages up to slot s + w - 2; repeating it adds nothing
    idx = (span[:, None] * SPAN + torch.arange(SPAN + w - 1, device=dev)
           ).clamp_(max=s + w - 2)
    keys = torch.unique(span[:, None] * 65536 + _widen(fp)[idx])
    cell_span = torch.arange(s, device=dev) // SPAN * 65536
    hits = sum(int(torch.isin(cell_span + _widen(tiles[ch]), keys).sum())
               for ch in range(c))
    return hits / (c * s)


def check_stream_kernel(dev, label, fp, tiles, w):
    """The wrapper's packed output against the twin's, every int32, both
    times and the share of cells listed; returns (max_abs_err, kernel_ms,
    twin_ms, bound)."""
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
    bnd = bound_stream(tiles.shape[1], tiles.shape[0], w)
    print(f"{label}: w={w} slots={tiles.shape[1]} channels={tiles.shape[0]} "
          f"max_abs_err={err} kernel_ms={k_ms:.4f} twin_ms={t_ms:.4f} "
          f"{bound_fields(k_ms, bnd)} "
          f"listed_cells={listed_share(fp, tiles, w):.5f}", flush=True)
    return err, k_ms, t_ms, bnd


def stream_vs_twin(dev):
    """Phase 5: {label: (max_abs_err, kernel_ms, twin_ms, bound)}, at w=24
    and w=64 with half the used cells planted, and at w=64 with all."""
    import torch

    res = {}
    for label, w, frac in (("w=24", 24, 0.5), ("w=64", 64, 0.5),
                           ("w=64 all planted", 64, 1.0)):
        fp, tiles, used = dense_tiles(dev, w, planted_frac=frac)
        per_slot = used.sum(0)
        print(f"phase 5: {label} queries_per_slot="
              f"{float(per_slot.float().mean()):.4f} slots_by_channels_used="
              f"{torch.bincount(per_slot, minlength=5).tolist()}",
              flush=True)
        res[label] = check_stream_kernel(dev, f"phase 5: {label}", fp,
                                         tiles, w)
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
    cpu, and through ``--backend pallas`` (the block probe) on cuda.
    Returns the stream kernel's launches of the cuda ``auto`` run."""
    with gzip.open(os.path.join(HERE, "tests", "data",
                                "golden_dna_full.txt.gz"), "rb") as fh:
        want = fh.read()
    launches = 0
    for device, backend in (("cuda", "auto"), ("cpu", "auto"),
                            ("cuda", "pallas")):
        out = os.path.join(work, f"golden_dna_{device}_{backend}.txt")
        reset_counts()
        info, secs = run_cli(d, fna, out, device, ("--backend", backend),
                             aa=False)
        counts = read_counts()
        with open(out, "rb") as fh:
            got = fh.read()
        print(f"phase 6: golden_dna_full device={device} backend={backend} "
              f"report_bytes={len(got)} identical={got == want} "
              f"launches={counts} wall_s={secs:.3f} {phase_ms(info)}",
              flush=True)
        if got != want:
            raise RuntimeError(f"{device} {backend} report differs from "
                               "golden_dna_full")
        check_launches(f"phase 6 {device} {backend}", counts,
                       *(BACKEND_KERNELS[backend] if device == "cuda"
                         else ((), ())))
        if device == "cuda" and backend == "auto":
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
    kernel, two plane passes) and ``--backend pallas`` (the block probe)
    against ``--backend xla`` on the card, then the stream kernel against
    the twin on the tiles of one pass's worth of the real queries (the
    first input_size_limit). Returns ((max_abs_err, kernel_ms, twin_ms,
    bound), the block probe's launches, the query values)."""
    import torch

    from kmergutsjava_tpu_torch.lookup import stream
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
    reports, block_launches = {}, 0
    for backend in ("auto", "xla", "pallas"):
        out = os.path.join(work, f"reads_{backend}.txt")
        reset_counts()
        info, secs = run_cli(d, fna, out, "cuda", ("--backend", backend),
                             aa=False)
        counts = read_counts()
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
        check_launches(f"phase 7 {backend}", counts,
                       *BACKEND_KERNELS[backend])
        if backend == "auto" and counts["stream"] < 2:
            # one launch a plane pass; past input_size_limit queries, two
            raise RuntimeError(f"auto made {counts['stream']} plane passes "
                               f"for {n_q} queries")
        if backend == "pallas":
            block_launches = counts["blockprobe"]
            print(f"phase 7: pallas block_probe_launches={block_launches} "
                  f"exact_rest_tilejoin_launches={counts['tilejoin']}",
                  flush=True)
    same = reports["auto"] == reports["xla"] == reports["pallas"]
    print(f"phase 7: report_bytes={len(reports['auto'])} "
          f"auto_equals_xla={reports['auto'] == reports['xla']} "
          f"pallas_equals_xla={reports['pallas'] == reports['xla']}",
          flush=True)
    if not same:
        raise RuntimeError("the stream, xla and pallas reports differ")

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
    return res, block_launches, values


def block_probe_vs_twin(dev, table, values):
    """Phase 8: the block probe against its twin on the table's plane with
    the read set's queries: first in prepare's order (neighbouring queries
    read windows far apart), then in the bounded-RAM store's (home, value)
    order, which is how the engine feeds them. Returns (max_abs_err,
    kernel_ms, twin_ms, bound), the times of the store's order."""
    import numpy as np
    import torch

    from kmergutsjava_tpu_torch.lookup import blockprobe
    from kmergutsjava_tpu_torch.lookup.blockprobe import BlockProbeLookup
    from kmergutsjava_tpu_torch.lookup.sparse import FP_MOD

    lk = BlockProbeLookup(table, device=str(dev))
    homes = values % lk.num_sigs
    err = 0
    for label, vals in (("prepare", values),
                        ("store", values[np.lexsort((values, homes))])):
        q = torch.from_numpy((vals % FP_MOD).astype(np.uint16)).to(dev)
        h = torch.from_numpy((vals % lk.num_sigs).astype(np.int32)).to(dev)
        args = (lk.fp, q, h, lk.w)
        off_k, st_k = blockprobe.block_probe(*args)
        off_t, st_t = blockprobe.block_probe_reference(*args)
        torch.cuda.synchronize(dev)
        err = max(err, int((off_k.int() - off_t.int()).abs().max()),
                  int((st_k.int() - st_t.int()).abs().max()))
        states = torch.bincount(st_k.long(), minlength=4).tolist()
        k_ms = timed(lambda: blockprobe.block_probe(*args), dev)
        t_ms = timed(lambda: blockprobe.block_probe_reference(*args), dev)
        bnd = bound_window_probe(lk.fp.numel(), len(vals))
        print(f"phase 8: {label} order w={lk.w} slots={lk.num_sigs} "
              f"plane_slots={lk.fp.numel()} queries={len(vals)} "
              f"states(0/1/2/3)={states} max_abs_err={err} "
              f"kernel_ms={k_ms:.4f} twin_ms={t_ms:.4f} "
              f"{bound_fields(k_ms, bnd)}", flush=True)
        del q, h, args, off_k, st_k, off_t, st_t
    return err, k_ms, t_ms, bnd


def stream_reps_phase(dev):
    """Phase 9: the repetition launch against the twin on phase 5's w=24
    operands, then the ported microbenchmark's real-table check and stream
    rows, each row's timed launch held against the twin on its operands.
    Returns (max_abs_err over all of them, kernel_ms and twin_ms at w=24,
    the rows' launches, the bound at w=24)."""
    import torch

    from kmergutsjava_tpu_torch.lookup import stream
    from kmergutsjava_tpu_torch.scripts import microbench_probe as mb

    w, reps = 24, 4
    fp, tiles, _ = dense_tiles(dev, w)
    got = stream.stream_probe_reps(fp, tiles, w, tiles.shape[0], reps)
    want = stream.stream_probe_reference(fp, tiles, w, tiles.shape[0])
    torch.cuda.synchronize(dev)
    err = int((got.long() - want.long()).abs().max())
    k_ms = timed(lambda: stream.stream_probe_reps(fp, tiles, w,
                                                  tiles.shape[0], reps), dev)
    t_ms = timed(lambda: stream.stream_probe_reference(fp, tiles, w,
                                                       tiles.shape[0]), dev)
    bnd = bound_stream(tiles.shape[1], tiles.shape[0], w, reps)
    print(f"phase 9: w={w} slots={tiles.shape[1]} reps={reps} "
          f"max_abs_err={err} kernel_ms={k_ms:.4f} "
          f"kernel_ms_per_rep={k_ms / reps:.4f} twin_ms={t_ms:.4f} "
          f"{bound_fields(k_ms, bnd)}", flush=True)
    del fp, tiles, got, want
    check = mb.correctness_on_card(str(dev))
    print(f"phase 9: microbench {json.dumps(check)}", flush=True)
    if not check["ok"]:
        raise RuntimeError("the microbenchmark's real-table check failed")
    reset_counts()
    rows = []
    for n_slots, r in mb.CONFIGS:
        rows.append(mb.bench_stream(n_slots, r))
        print(f"phase 9: microbench {json.dumps(rows[-1])}", flush=True)
        torch.cuda.empty_cache()
    counts = read_counts()
    check_launches("phase 9 microbench rows", counts, ("stream_reps",))
    bad = [(row["plane_mb"], row["reps"]) for row in rows
           if row["max_abs_err"] != 0]
    if bad:
        raise RuntimeError(f"microbench rows (plane MB, reps) {bad}: the "
                           "repetition launch disagrees with the twin")
    return (max([err] + [row["max_abs_err"] for row in rows]), k_ms, t_ms,
            counts["stream_reps"], bnd)


def planted_tjgather(dev, plane3, ids, cap, seed=SEED):
    """A copy of the sweep's plane with 30% empties and one variant of its
    packed cells at ``cap``, half of them carrying the value found a random
    offset (< 16) into their column."""
    import torch

    from kmergutsjava_tpu_torch.scripts import sweep

    g = torch.Generator(device=dev).manual_seed(seed + cap)
    p3 = plane3.clone().view(torch.int16)
    p3[torch.randint(0, 10, p3.shape, generator=g, device=dev,
                     dtype=torch.int8) < 3] = -1  # FP_EMPTY
    pk = sweep.make_packed(ids.numel(), cap, 1, dev, seed=seed + cap)[0]
    rr, off = (pk >> 7) & 127, pk & 127
    tile = (ids[:, None, None, None] * sweep.TPG
            + torch.arange(sweep.TPG, device=dev)[None, :, None, None])
    at = off + torch.randint(0, sweep.W, pk.shape, generator=g, device=dev,
                             dtype=torch.int32)
    v = p3[tile.long(), at.long(), rr.long()].to(torch.int32) & 0xFFFF
    plant = torch.rand(pk.shape, generator=g, device=dev) < 0.5
    pk = torch.where(plant, (v << 14) | (rr << 7) | off, pk).contiguous()
    return p3.view(torch.uint16), pk


def tjgather_phase(dev):
    """Phase 10: the ported sweep's lane-gather section at its defaults (a
    512 MB plane, caps 256 and 512), then the kernel against its twin at
    those shapes on planted operands. Returns (max_abs_err, kernel_ms,
    twin_ms and bound at the largest cap, the sweep's launches)."""
    import torch

    from kmergutsjava_tpu_torch.lookup import tjgather
    from kmergutsjava_tpu_torch.scripts import sweep

    cfg = sweep.settings()
    reset_counts()
    rates = sweep.section_tjgather(str(dev))
    counts = read_counts()
    print(f"phase 10: sweep {json.dumps(rates)} launches="
          f"{counts['tjgather']}", flush=True)
    check_launches("phase 10 sweep", counts, ("tjgather",))
    plane3, ids = sweep.make_plane(sweep.plane_tiles(cfg["plane_mb"]), dev)
    err, k_ms, t_ms, bnd = 0, 0.0, 0.0, None
    for cap in cfg["caps"]:
        p3, pk = planted_tjgather(dev, plane3, ids, cap)
        got = tjgather.tjgather_probe(p3, ids, pk)
        want = tjgather.tjgather_reference(p3, ids, pk)
        torch.cuda.synchronize(dev)
        e = int((got.long() - want.long()).abs().max())
        keys = torch.bincount(torch.where(got == 2 * sweep.W, 2, got % 2)
                              .flatten().long(), minlength=3).tolist()
        k = timed(lambda: tjgather.tjgather_probe(p3, ids, pk), dev)
        t = timed(lambda: tjgather.tjgather_reference(p3, ids, pk), dev)
        bnd = bound_tjgather(p3.numel(), pk.numel())
        print(f"phase 10: plane_mb={cfg['plane_mb']:g} tiles={p3.shape[0]} "
              f"cap={cap} cells={pk.numel()} keys(cand/empty/none)={keys} "
              f"max_abs_err={e} kernel_ms={k:.4f} twin_ms={t:.4f} "
              f"{bound_fields(k, bnd)}", flush=True)
        err, k_ms, t_ms = max(err, e), k, t
        del p3, pk, got, want
        torch.cuda.empty_cache()
    return err, k_ms, t_ms, counts["tjgather"], bnd


def clear_engine_caches():
    """Empty the engine's host-table and lookup caches, so that the next
    request or run reads the table and builds its lookup as a fresh
    process would (the kernel libraries stay loaded)."""
    from kmergutsjava_tpu_torch.models import pipeline

    pipeline._LOOKUP_CACHE.clear()
    pipeline._TABLE_CACHE.clear()


@contextlib.contextmanager
def serving(data_dir):
    """The port's server on ``data_dir`` (device cuda) in this process, on
    a thread; yields (server, URL)."""
    from kmergutsjava_tpu_torch.service.server import serve

    srv = serve(data_dir, port=0, device="cuda")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(60)


def timed_call(fn):
    """(fn(), seconds on the host clock)."""
    t0 = time.time()
    got = fn()
    return got, time.time() - t0


def port_env():
    return {**os.environ, "PYTHONPATH": HERE}


@contextlib.contextmanager
def server_process(data_dir):
    """The port's server started as a user starts it (``python -m
    kmergutsjava_tpu_torch.service.server -D DIR -p 0``, device cuda, no
    --warm) in a process of its own; yields (URL, seconds until it
    served). Stopped with SIGTERM (drain) when done, killed if it hangs."""
    import select
    import signal

    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kmergutsjava_tpu_torch.service.server", "-D",
         data_dir, "-p", "0"], cwd=HERE, env=port_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, bufsize=0)
    try:
        line = b""
        while not line.startswith(b"serving on :"):
            if not select.select([proc.stdout], [], [], 120)[0]:
                raise RuntimeError("the server process printed nothing "
                                   "for 120 s")
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(f"the server process exited "
                                   f"({proc.wait()}) before serving")
        port = int(line.split(b":")[1].split()[0])
        yield f"http://127.0.0.1:{port}", time.time() - t0
        proc.send_signal(signal.SIGTERM)
        tail = proc.communicate(timeout=60)[0].decode(errors="replace")
        if proc.returncode != 0 or "drained cleanly" not in tail:
            raise RuntimeError(f"the server process ended with "
                               f"{proc.returncode}: {tail[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)


def metric_value(text, name, labels):
    """One sample of the Prometheus exposition ``text`` (0 if absent)."""
    head = name + "{" + ",".join(f'{k}="{v}"' for k, v in
                                 sorted(labels.items())) + "} "
    for line in text.splitlines():
        if line.startswith(head):
            return float(line[len(head):])
    return 0.0


def service_phase(work, big, faa, prots, w1, tj_launches):
    """Phase 11: the port's JSON-RPC server and restartable runs on the
    card against phase 4's table. warm; the proteome by path (phase 4's
    cuda report, B1 launches as phase 4's, served by warm's lookup); four
    inline requests at once; the async protocol; phase 7's read set through
    ``stream`` (phase 7's report, two B2 launches); the proteome again
    (after ``stream`` the one-slot lookup cache builds it cold); /metrics;
    a second server, started without --warm in a process of its own, and
    a bare CUDA process beside it; then
    the CLI with --checkpoint against a single run, both cold; and a crash
    after 3 committed batches with a torn tail, resumed by a fresh
    process. Every report must equal its reference byte for byte."""
    import concurrent.futures
    import urllib.request

    from kmergutsjava_tpu_torch.models import pipeline
    from kmergutsjava_tpu_torch.models.pipeline import Engine
    from kmergutsjava_tpu_torch.service.client import KmerGutsClient

    def read(name):
        with open(os.path.join(work, name), "rb") as fh:
            return fh.read()

    def same(label, got, want):
        if got != want:
            raise RuntimeError(f"phase 11: {label} differs from its "
                               f"reference ({len(got)} against {len(want)} "
                               "bytes)")

    want_aa, want_reads = read("big_cuda.txt"), read("reads_auto.txt")
    reads = os.path.join(work, "reads.fna")
    head = "".join(f">{p.id} {p.descr}\n{p.seq}\n" for p in prots[:1000])
    head_path = os.path.join(work, "proteome_1000.faa")
    with open(head_path, "w") as fh:
        fh.write(head)
    run_cli(big, head_path, os.path.join(work, "head_cli.txt"), "cuda")
    want_head = read("head_cli.txt")
    clear_engine_caches()
    n_sync = 0

    with serving(big) as (_, url):
        client = KmerGutsClient(url)
        st, warm_s = timed_call(client.warm)
        (key, lk), = pipeline._LOOKUP_CACHE.items()
        print(f"phase 11: server device=cuda warm_s={warm_s:.3f} {st} "
              f"lookup={type(lk).__name__} key_device={key[-1]}", flush=True)
        if st["probe_window"] != w1:
            raise RuntimeError(f"phase 11: warm's probe window "
                               f"{st['probe_window']} is not phase 4's {w1}")

        def proteome(label, must_be=None):
            reset_counts()
            rep, secs = timed_call(lambda: client.annotate(
                fasta_path=faa, aa=True))
            counts = read_counts()
            print(f"phase 11: annotate proteome ({label}) wall_s={secs:.3f} "
                  f"report_bytes={len(rep.encode())} launches={counts} "
                  f"same_lookup_as_warm="
                  f"{list(pipeline._LOOKUP_CACHE.values()) == [lk]}",
                  flush=True)
            same(f"the proteome's report ({label})", rep.encode(), want_aa)
            check_launches(f"phase 11 {label}", counts, ("tilejoin",))
            if counts["tilejoin"] != tj_launches:
                raise RuntimeError(f"phase 11: {counts['tilejoin']} B1 "
                                   f"launches, phase 4 made {tj_launches}")
            if must_be is not None and \
                    list(pipeline._LOOKUP_CACHE.values()) != [must_be]:
                raise RuntimeError("phase 11: the annotate did not run on "
                                   "the lookup that warm built")
            return secs

        proteome("first after warm", must_be=lk)
        proteome("again, warm", must_be=lk)
        n_sync += 2

        def inline(i):
            rep, secs = timed_call(lambda: client.annotate(fasta=head,
                                                           aa=True))
            return rep.encode(), secs

        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
            got = list(ex.map(inline, range(4)))
        n_sync += 4
        for rep, _ in got:
            same("an inline request's report", rep, want_head)
        print(f"phase 11: 4 inline requests at once (1,000 proteins each) "
              f"wall_s={[round(s, 3) for _, s in got]} equal_to_cli=True",
              flush=True)

        t0 = time.time()
        job_id = client.annotate_submit(fasta_path=faa, aa=True)
        polls, delay = 0, 0.05
        while True:
            job = client.check_job(job_id)
            polls += 1
            if job.get("finished"):
                break
            time.sleep(delay)
        async_s = time.time() - t0
        if job.get("error"):
            raise RuntimeError(f"phase 11: async job failed: {job['error']}")
        same("the async job's report", job["result"][0]["report"].encode(),
             want_aa)
        print(f"phase 11: async submit+poll proteome wall_s={async_s:.3f} "
              f"polls={polls} equal_to_sync=True", flush=True)

        reset_counts()
        rep, stream_s = timed_call(lambda: client.annotate(
            fasta_path=reads, aa=False, backend="stream"))
        counts = read_counts()
        n_sync += 1
        print(f"phase 11: annotate reads backend=stream (its lookup built "
              f"cold: the cache held xla's) wall_s={stream_s:.3f} "
              f"report_bytes={len(rep.encode())} launches={counts}",
              flush=True)
        same("the read set's report", rep.encode(), want_reads)
        check_launches("phase 11 stream", counts, ("stream",))
        if counts["stream"] != 2:
            raise RuntimeError(f"phase 11: {counts['stream']} B2 launches "
                               "for the read set, not 2")
        proteome("after the stream request: xla's lookup rebuilt cold")
        n_sync += 1

        with urllib.request.urlopen(url + "/metrics") as r:
            text = r.read().decode()
        ok = {m: metric_value(text, "rpc_requests_total",
                              {"method": m, "outcome": "ok"})
              for m in ("warm", "annotate", "_annotate_submit",
                        "_check_job")}
        print(f"phase 11: /metrics ok counts {ok}", flush=True)
        if ok != {"warm": 1, "annotate": n_sync, "_annotate_submit": 1,
                  "_check_job": polls}:
            raise RuntimeError(f"phase 11: /metrics ok counts {ok}")

    # what any fresh process pays before its first kernel: start, import
    # torch, create the CUDA context
    res, floor_s = timed_call(lambda: subprocess.run(
        [sys.executable, "-c", "import torch; torch.zeros(1, device='cuda'); "
         "torch.cuda.synchronize()"], env=port_env(), capture_output=True,
        text=True, timeout=300))
    if res.returncode != 0:
        raise RuntimeError(f"phase 11: a bare CUDA process failed: "
                           f"{res.stderr[-2000:]}")
    with server_process(big) as (url, start_s):
        rep, cold_s = timed_call(lambda: KmerGutsClient(url).annotate(
            fasta_path=faa, aa=True))
        same("a cold server's proteome report", rep.encode(), want_aa)
        print(f"phase 11: second server (own process, no --warm) "
              f"start_to_serving_s={start_s:.3f} first_annotate_s="
              f"{cold_s:.3f}; a bare process's start, torch import and "
              f"CUDA context: {floor_s:.3f} s", flush=True)

    every = "2000"
    clear_engine_caches()
    _, single_s = run_cli(big, faa, os.path.join(work, "single.txt"), "cuda")
    same("the single run", read("single.txt"), want_aa)
    clear_engine_caches()
    out, ck = os.path.join(work, "ckpt.txt"), os.path.join(work, "ckpt.json")
    reset_counts()
    _, ckpt_s = run_cli(big, faa, out, "cuda",
                        ("--checkpoint", ck, "--checkpoint-every", every))
    counts = read_counts()
    with open(ck) as fh:
        state = json.load(fh)
    batches = -(-state["groups_done"] // int(every))
    print(f"phase 11: checkpointed run wall_s={ckpt_s:.3f} batches={batches} "
          f"(every {every}) single_run_wall_s={single_s:.3f} (both cold) "
          f"launches={counts} sidecar_complete={state['complete']}",
          flush=True)
    same("the checkpointed run", read("ckpt.txt"), want_aa)
    check_launches("phase 11 checkpoint", counts, ("tilejoin",))
    if not state["complete"] or state["groups_done"] != len(prots):
        raise RuntimeError(f"phase 11: sidecar {state}")

    # a crash after 3 committed batches (the 4th batch's run raises), a
    # torn tail, and the resume in a fresh process (its lookup built cold)
    class Crash(RuntimeError):
        pass

    out, ck = os.path.join(work, "crash.txt"), os.path.join(work, "crash.json")
    orig, calls = Engine.run, []

    def crashing(self, *a, **kw):
        calls.append(1)
        if len(calls) > 3:
            raise Crash("a crash in the 4th batch")
        return orig(self, *a, **kw)

    Engine.run = crashing
    try:
        run_cli(big, faa, out, "cuda",
                ("--checkpoint", ck, "--checkpoint-every", every))
        raise RuntimeError("phase 11: the crashing run did not crash")
    except Crash:
        pass
    finally:
        Engine.run = orig
    with open(ck) as fh:
        crashed = json.load(fh)
    if crashed["groups_done"] != 3 * int(every) or crashed["complete"]:
        raise RuntimeError(f"phase 11: sidecar after the crash {crashed}")
    with open(out, "ab") as fh:
        fh.write(b"TORN TAIL OF THE CRASHED BATCH")
    res, resume_s = timed_call(lambda: subprocess.run(
        [sys.executable, "-m", "kmergutsjava_tpu_torch.cli", "-a", "-D", big,
         "-q", faa, "-o", out, "--checkpoint", ck, "--checkpoint-every",
         every], cwd=HERE, env=port_env(), capture_output=True, text=True,
        timeout=600))
    if res.returncode != 0:
        raise RuntimeError(f"phase 11: the resume exited {res.returncode}: "
                           f"{res.stderr[-2000:]}")
    with open(ck) as fh:
        state = json.load(fh)
    print(f"phase 11: crash after {crashed['groups_done']} groups "
          f"({crashed['out_offset']} B committed), torn tail, resume in a "
          f"fresh process wall_s={resume_s:.3f} sidecar_complete="
          f"{state['complete']} groups_done={state['groups_done']}",
          flush=True)
    same("the resumed run", read("crash.txt"), want_aa)
    if not state["complete"]:
        raise RuntimeError(f"phase 11: sidecar after the resume {state}")


def kernel_bound(ms, bnd):
    """A kernel entry's bound, share and library call (none: no single
    PyTorch call computes a first-event window probe)."""
    return {"bound_ms": bnd[0], "bound_by": bnd[1], "share": bnd[0] / ms,
            "library_ms": None}


def build_kernels():
    """Phase 1: one nvcc per kernel source, started together."""
    mods = list(kernel_modules().values())
    errors = []

    def build(mod):
        try:
            mod.load_kernel()
        except Exception as ex:  # noqa: BLE001 — re-raised below
            errors.append(ex)

    t0 = time.time()
    threads = [threading.Thread(target=build, args=(m,)) for m in mods]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    print(f"phase 1: built "
          f"{', '.join(os.path.relpath(m.SOURCE, HERE) for m in mods)} (nvcc "
          f"{' '.join(mods[0].NVCC_FLAGS)}) in {time.time() - t0:.3f} s",
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

    # the main path's launches (dispatches of 2^19 queries, w1 = 16 on the
    # realistic table) first, then whole-proteome launches at wider windows
    chunk = SparseLookup.DEFAULT_CHUNK
    cmp = kernel_vs_twin(dev, ((16, chunk), (16, BIG_QUERIES),
                               (32, BIG_QUERIES), (64, BIG_QUERIES)))
    for (w, n), (err, *_) in cmp.items():
        if err != 0:
            return fail(f"kernel and twin disagree at w={w}, n={n}")

    with tempfile.TemporaryDirectory(prefix="kmer_smoke_") as work:
        prots = load_proteome()
        sig = corpus_signatures(prots)
        corpus, faa = golden_run(dev, work, prots, sig)
        big, table, tj_launches, (w1, (err, k_ms, t_ms, tj_bnd, call_ms)) \
            = realistic_run(dev, work, sig, faa)
        if err != 0:
            return fail("kernel and twin disagree on the proteome's "
                        f"dispatches (w={w1})")
        s_cmp = stream_vs_twin(dev)
        for label, (e, *_) in s_cmp.items():
            if e != 0:
                return fail(f"stream kernel and twin disagree at {label}")
        genome = write_genome(os.path.join(work, "genome.fna"))
        st_launches = golden_dna_run(work, corpus,
                                     os.path.join(work, "genome.fna"))
        (s_err, s_ms, s_plain_ms, s_bnd), bp_launches, values = dense_run(
            dev, work, big, table, genome)
        if s_err != 0:
            return fail("stream kernel and twin disagree on a pass's real "
                        "tiles")
        bp_err, bp_ms, bp_plain_ms, bp_bnd = block_probe_vs_twin(
            dev, table, values)
        if bp_err != 0:
            return fail("block probe and twin disagree on the read set")
        del values, table
        r_err, r_ms, r_plain_ms, r_launches, r_bnd = stream_reps_phase(dev)
        if r_err != 0:
            return fail("the stream kernel's repetition launch and twin "
                        "disagree")
        g_err, g_ms, g_plain_ms, g_launches, g_bnd = tjgather_phase(dev)
        if g_err != 0:
            return fail("lane-gather kernel and twin disagree")
        service_phase(work, big, faa, prots, w1, tj_launches)

    print(json.dumps({"kernels": [{
        "name": "tilejoin_first_event",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/tilejoin.cu",
        "replaces": "kmergutsjava_tpu/lookup/pallas_tilejoin.py:145",
        "launches": tj_launches,
        "max_abs_err": max([err] + [r[0] for r in cmp.values()]),
        "ms": k_ms,
        "call_ms": call_ms,
        "plain_ms": t_ms,
        **kernel_bound(k_ms, tj_bnd),
    }, {
        "name": "stream_probe",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/stream_probe.cu",
        "replaces": "kmergutsjava_tpu/lookup/pallas_stream.py:81",
        "launches": st_launches,
        "max_abs_err": max([s_err] + [r[0] for r in s_cmp.values()]),
        "ms": s_ms,
        "plain_ms": s_plain_ms,
        **kernel_bound(s_ms, s_bnd),
    }, {
        "name": "block_probe",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/block_probe.cu",
        "replaces": "kmergutsjava_tpu/lookup/pallas_kernel.py:56",
        "launches": bp_launches,
        "max_abs_err": bp_err,
        "ms": bp_ms,
        "plain_ms": bp_plain_ms,
        **kernel_bound(bp_ms, bp_bnd),
    }, {
        "name": "stream_probe_reps",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/stream_probe.cu",
        "replaces": "scripts/microbench_probe.py:180",
        "launches": r_launches,
        "max_abs_err": r_err,
        "ms": r_ms,
        "plain_ms": r_plain_ms,
        **kernel_bound(r_ms, r_bnd),
    }, {
        "name": "tjgather_probe",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/tjgather.cu",
        "replaces": "scripts/sweep.py:179",
        "launches": g_launches,
        "max_abs_err": g_err,
        "ms": g_ms,
        "plain_ms": g_plain_ms,
        **kernel_bound(g_ms, g_bnd),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
