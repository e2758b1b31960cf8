#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package (kmergutsjava_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases (one line each; the run stops with a non-zero exit at the first
failure and then prints no result):

0. the host C++ libraries (feeder, scatter, grouping, fasta), built with g++
   from the port's own kmergutsjava_tpu_torch/native/ (``native.status()``,
   one line): the run stops unless all four loaded from there, so every
   wall printed later is the native host path's, never the numpy twins';
1. the card's name and power limit (nvidia-smi); build of the CUDA kernels
   (csrc/tilejoin.cu, csrc/stream_probe.cu, csrc/block_probe.cu,
   csrc/tjgather.cu, csrc/kmer_windows.cu, csrc/shard_probe.cu,
   csrc/route_bins.cu, csrc/scan_machine.cu and csrc/fused_probe.cu, one
   nvcc each, started together) for sm_90a;
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
   ``auto`` takes the stream path in two plane passes (each launching the
   device scatter a chunk, B2 once and the device resolve a chunk), and
   ``--backend pallas`` spills once and runs one block-probe launch; both
   reports must equal the ``--backend xla`` report byte for byte. Phase
   times, query rates and launches are printed; then the read set's own
   chunks (the prepare's, grouped into the engine's two passes) go through
   the stream lookup's device stages: each chunk scattered by the scatter
   kernel (its twin timed from the same tiles and occupancy), each pass's
   split checked valid, B2 held against its twin on the first pass's
   tiles, each chunk resolved by the resolve kernel and its twin on the
   same channels and answers (slots and counts equal bit for bit), every
   launch timed against its twin with its bound;
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
   Every request and run prints its wall time;
12. the fused device path (``--backend spmd``: one launch a batch of the
   fused kernel, csrc/fused_probe.cu: k-mer windows and the tile-join
   kernel's first event) and the device prepare (``--prepare jax``: the
   ragged entry of the window kernel, csrc/kmer_windows.cu) on the card:
   the CLI with ``--backend spmd`` reproduces golden_aa_full on the
   proteome and golden_dna_full on the genome (a contig past LONG_NT: the
   windowed entry); on phase 4's table the proteome through ``--backend
   spmd`` and through ``--prepare jax --backend xla`` gives phase 4's cuda
   report, and phase 7's read set through ``--prepare jax --backend xla``
   and through ``--backend spmd`` phase 7's report; each spmd run launches
   the fused kernel and nothing else (the ragged entry and B1 for
   ``--prepare jax``, whose calls a spy keeps). Then three rounds of cold
   runs in turns (the engine's caches emptied before each): the proteome
   through spmd and xla, the read set through spmd, auto and xla. Last,
   at the real launch shapes (a proteome bucket batch, a read batch and
   the genome's window batch): B1 on the window twin's homes and
   fingerprints against B1's twin; the fused kernel against its twin,
   every off and state equal, with its device time a launch
   (torch.profiler, the L2 flushed), its twin's time and its bound
   (``bound_fused_step``); and the ragged entry on every call of the two
   ``--prepare jax`` runs, each equal to its twin, with the device time
   of a whole prepare (its calls' two kernels each, summed), the twin's
   and the bound (``bound_ragged``);
13. the multi-device modes on phase 4's table (parallel/: the mesh, the
   shard probe B12 csrc/shard_probe.cu, the routing bins B13
   csrc/route_bins.cu). Through the CLI at ``--mesh 1x1``: the proteome
   through ``--backend sharded``, ``routed``, ``replicated``, ``xla`` and
   ``auto`` (which routes: the proteome is sparse), and phase 7's read set
   through ``--backend stream``. Through the Engine with ``mesh_devices``
   of four positions (on the one card, or on four cards where the machine
   has them; the line prints how many distinct cards): ``sharded`` at
   (2, 2) and (1, 4), ``routed`` over 4, ``replicated`` over 2, ``xla``
   over 4 table shards and ``spmd`` at (2, 2) on the proteome, ``stream``
   over 4 and ``spmd`` at (2, 2) on the read set; and the single-device
   ``xla`` (proteome) and ``auto`` (read set) in the same conditions. Every
   report must equal phase 4's or phase 7's; every mesh position must be a
   CUDA device; each run launches its kernels as predicted (B12 once a
   position a step, B13's two entries and B1 once a shard, B1 and B2 once
   a table shard a dispatch or plane pass, B1 once a data device a
   dispatch, the fused kernel once a position a batch) and no others.
   Then B12 (at the sharded (2, 2) run's shape: a
   data row's queries against each table shard) and B13 (at the routed
   run's shape: the first shard's queries, its bins and the un-binning)
   against their twins on the card, exact, with their device times, the
   twins' and their bounds, and beside B13's binning the device time of
   ``torch.argsort(owner, stable=True)`` on the same owners (its library
   call, timed only) and beside the un-binning (one back buffer [T, 2,
   cap] in, the host's [3, ld] layout of offsets, states and overflow
   flags out) the same answer by PyTorch calls: the back buffer's rows as
   [2, T * cap], an ``index_select`` of them by the cells, the flags and a
   ``cat`` (its library yardstick, timed and held against it); every
   routed run prints its return trip, counted by spies (``routed_trips``:
   one answer exchange a probe and one read-back a shard, or the phase
   fails); and, each call taken by a spy on its wrapper,
   the fused kernel's shard form in the (2, 2) spmd step on phase 12's
   proteome bucket batch and read batch (a data slice's rows against a
   table shard), equal to its twin, with its device time a launch and its
   bound;
   B1 at the routed owners (the received bins) and B1 on the xla lookup's
   four table shards (local homes), every call equal to its twin.

14. ``--grouping scan`` on the card (the grouping kernel B11,
   csrc/scan_machine.cu): the CLI on the goldens (corpus table) and on
   phase 4's proteome and phase 7's read set, each report equal to its
   golden or to phase 4's or 7's, one B11 launch a run (none for the
   genome: its six containers are past 4,096 hits and take the host
   machine, as in the JAX engine); then B11 against
   its twin on the engine's own container batches of those two runs
   (taken by a spy on the wrapper: flags at every step, records where a
   step emits), with its device time (in the wrapper's length order,
   whose own time is printed apart), the twin's, the bound, the longest
   container's steps and the device time a step of it;
15. two processes of the port under gloo (``--mp-worker``: this script,
   one rank each), each holding two mesh positions of the one card: the
   sharded (2, 2), routed 4 (its return trip counted as in phase 13),
   stream-shard 4 and sharded sparse probe (1, 4) lookups of the
   proteome's queries against phase 4's table, each rank's hits equal to
   a single-process lookup's; the fused step (``spmd``) on a (2, 2) mesh
   over both ranks, every rank consuming the whole input: the proteome
   (the report made from its hits equal to phase 4's) and phase 7's first
   20,000 reads with the genome's first 150,000 bases as one long contig
   (through the windowed step), each rank's hits equal to a
   single-process (2, 2) step's, the fused kernel launched only through
   its shard entry; then each rank's engine over its ``shard_records``
   share, merged by ``merge_report_shards`` into phase 4's report byte
   for byte; each step's build and lookup walls and launches are
   printed;
16. the randomized differential on the card: the soak rounds of
   tests/torch_soak_rounds.py (random tables and query sets) for the
   seeds in ``SOAK_SEEDS``, every port run of each round on cuda (each
   backend, the mesh backends on positions of card 0, the grouping
   kernel's, the home-sorted and the device prepare's runs, a checkpoint
   run) byte-equal to the port's ``parity`` run on the CPU; the phase's
   wall and each kernel counter's total over it (``SOAK_COUNTERS``) are
   printed, and a total of 0 (a kernel the rounds bypassed) fails it.

Phase 4 also runs the proteome with ``--sort-chunks 1`` and with
``--sort-chunks 1 --device-sort`` (each report equal to the unsorted one)
and times B1 a dispatch with each chunk in home order, between two runs in
the engine's order.

Each kernel's line also prints its bound (``bound_ms``: the larger of
the bytes it must move over the card's memory rate and one integer
operation an input element over its INT32 rate; ``bound_by``) and its
share of the bound (bound_ms / kernel_ms).

Every run that drives a path (the CLI runs, the microbenchmark's rows, the
sweep, the server's requests) starts with every launch count at 0 and must
launch its kernels and no others. The line before the last is a JSON object with each kernel's
name, source, the TPU kernel it replaces, its launches on its path (phase
4's cuda run for the tile join, phase 6's cuda ``auto`` run for the stream
kernel, phase 7's ``auto`` run for its device scatter and resolve, phase
7's ``pallas`` run for the block probe, phase 9's rows for
the repetition launch, phase 10's sweep for the lane gather, phase 12's
proteome ``--prepare jax`` run for the window kernel (its ragged entry's
calls; the read set's beside them), phase
12's sparse proteome spmd run for the fused kernel (its (2, 2) run in
phase 13 beside it), phase 13's sharded (2, 2) run for B12 and routed run
for B13, phase 14's proteome run for B11), its largest
disagreement with the twin, both times at the real shapes (phase 4's
device time of a full dispatch, with the wrapper's ``call_ms`` beside it;
phase 7's passes, each of its scatter and resolve launches summed;
phases 8, 9 and 10; phase 12's proteome prepare's calls
for the window kernel's ragged entry (the read set's beside it), its
proteome bucket batch for the fused kernel, with its (2, 2) position's
time;
phase 13's shapes; phase 14's proteome batch),
how they were timed (``timed_by``: ``trace``, the kernel records of a
torch.profiler trace; ``events``, CUDA events around launches back to
back; ``events_per_run``, CUDA events around each run where every trace
of one of the entry's figures lost its kernel records, launch gaps and
host syncs included; a kernel and its yardstick are timed the same way),
the bound and share at those shapes (no share for ``events_per_run``),
and ``library_ms``: B13's ``torch.argsort`` beside its binning (and its
``index_select`` yardstick beside the un-binning, with the un-binning's
own bound and share), null for the others (no
single PyTorch call computes a first-event window probe, a shard's first
match or the grouping machine); the last line is ``{"ok": true, "device":
{...}}``. Imports nothing of JAX.
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
    from kmergutsjava_tpu_torch.calls import scan_machine
    from kmergutsjava_tpu_torch.lookup import (blockprobe, stream,
                                               stream_tiles, tilejoin,
                                               tjgather)
    from kmergutsjava_tpu_torch.ops import kmer_windows
    from kmergutsjava_tpu_torch.parallel import (fused_probe, route_bins,
                                                 shard_probe)

    return dict(tilejoin=tilejoin, stream=stream, blockprobe=blockprobe,
                tjgather=tjgather, kmer_windows=kmer_windows,
                shard_probe=shard_probe, route_bins=route_bins,
                scan_machine=scan_machine, fused_probe=fused_probe,
                stream_tiles=stream_tiles)


# the kernel modules whose counts have their own names (read_counts)
NAMED_COUNTS = ("stream_tiles", "kmer_windows")


def reset_counts():
    """Every kernel's launch count to 0 (the repetition launch's, the
    window kernel's ragged entry's, the stream tiles' two kernels' and the
    routing bins' un-binning entry's too)."""
    mods = kernel_modules()
    for name, m in mods.items():
        if name not in NAMED_COUNTS:
            m.launches = 0
    mods["stream"].reps_launches = 0
    mods["stream_tiles"].scatter_launches = 0
    mods["stream_tiles"].resolve_launches = 0
    mods["kmer_windows"].ragged_launches = 0
    mods["route_bins"].unbin_launches = 0


def read_counts():
    mods = kernel_modules()
    got = {name: m.launches for name, m in mods.items()
           if name not in NAMED_COUNTS}
    got["stream_reps"] = mods["stream"].reps_launches
    got["kmer_ragged"] = mods["kmer_windows"].ragged_launches
    got["route_unbin"] = mods["route_bins"].unbin_launches
    got["stream_scatter"] = mods["stream_tiles"].scatter_launches
    got["stream_resolve"] = mods["stream_tiles"].resolve_launches
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
# A torch.profiler trace can come back without its kernel records: in this
# script's runs from phase 12 on, in some runs every trace. A trace widened
# by idle host time before and after its runs keeps them more often, so a
# trace that lost them is taken again with TRACE_PAD_S widened (0.1, 0.4,
# 1.6 s; the widest that kept its runs stays for later traces; at 1.6 s
# about one trace in three lost them), and after TRACE_MAX_PAD_TRIES
# losses at TRACE_PAD_MAX_S the runs are timed by CUDA events around each
# (event_runs_ms). The key of a figure timed so goes into EVENT_TIMED: its
# kernels-line entry says "timed_by": "events_per_run" and gives no share.
TRACE_PAD_S = [0.0]
TRACE_PAD_MAX_S = 1.6
TRACE_MAX_PAD_TRIES = 3
EVENT_TIMED = set()


def traced(take, what):
    """``take(pad)`` (one trace, ``pad`` seconds idle before and after its
    runs, raising RuntimeError when it lost its kernel records) until a
    trace keeps its runs, widening TRACE_PAD_S after each loss. Returns its
    result, or None after TRACE_MAX_PAD_TRIES losses at TRACE_PAD_MAX_S."""
    widest_lost = 0
    while True:
        pad = TRACE_PAD_S[0]
        try:
            got = take(pad)
        except RuntimeError as ex:
            print(f"{what}: trace lost at pad {pad} s: {ex}", flush=True)
            if pad >= TRACE_PAD_MAX_S:
                widest_lost += 1
                if widest_lost == TRACE_MAX_PAD_TRIES:
                    return None
            TRACE_PAD_S[0] = min(TRACE_PAD_MAX_S, max(0.1, 4 * pad))
            continue
        if pad:
            print(f"{what}: trace kept at pad {pad} s", flush=True)
        return got


def timed_by(*keys):
    """A kernels-line entry's timing: "events_per_run" when any of its
    figures (by their kernel_device_ms / library_device_ms keys) fell back
    to event_runs_ms in this run, else "trace"."""
    return "events_per_run" if EVENT_TIMED & set(keys) else "trace"


def same_timing(*timers):
    """Each ``timer(events)`` -> (ms, kept), in order (a kernel and its
    yardstick, or turns); when some fell back to events (kept 0 or None)
    and others did not, all of them again by events, so that the figures
    compared are timed the same way."""
    got = [t(False) for t in timers]
    lost = [not kept for _, kept in got]
    if any(lost) and not all(lost):
        got = [t(True) for t in timers]
    return got


def kernel_device_ms(run, dev, marker, reps=5, key=None, events=False):
    """Device milliseconds of each kernel whose name holds ``marker`` (or
    one of a tuple of markers), in the order one ``run()`` launches them,
    averaged over ``reps`` runs:
    the kernel events (CUPTI's device timestamps) of a torch.profiler
    trace, read from its Chrome trace. Before each run a 256 MB write
    evicts the L2 and the card is synchronised, so each run starts as
    cold as the engine's first chunk and its launches overlap nothing.
    ``run()`` launches no other kernel, so the flush
    kernels (an add over the buffer) split the trace into runs on the
    device's own clock. The tracer can drop a kernel's record: a run that
    does not show the most common count is left out, and a trace that
    keeps fewer than half of the runs is taken again (traced). With
    ``events``, or when no trace kept its runs, the runs are timed by CUDA
    events around each instead (event_runs_ms: one time a run, launch gaps
    and host syncs included) and ``key`` (by default the marker) goes into
    EVENT_TIMED. Returns (the milliseconds, the number of runs kept: 0
    when timed by events)."""
    import torch

    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    run()  # warm-up
    torch.cuda.synchronize(dev)
    got = None if events else traced(
        lambda pad: _traced_runs(run, dev, marker, reps, flush, pad),
        f"kernel_device_ms of {marker}")
    if got is not None:
        return got
    EVENT_TIMED.add(marker if key is None else key)
    return [event_runs_ms(run, dev, marker, reps, flush)], 0


def event_runs_ms(run, dev, what, reps, flush):
    """Mean milliseconds of ``reps`` flushed runs of ``run()`` by CUDA
    events around each (the fallback of kernel_device_ms and
    library_device_ms): the run's kernels and the gaps between their
    launches."""
    import torch

    total = 0.0
    for _ in range(reps):
        flush.add_(1)
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize(dev)
        total += start.elapsed_time(end)
    print(f"device_ms of {what}: timed by CUDA events around each run",
          flush=True)
    return total / reps


def _traced_runs(run, dev, marker, reps, flush, pad):
    """One torch.profiler trace of ``reps`` flushed runs, ``pad`` seconds
    idle before and after them; see kernel_device_ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    markers = (marker,) if isinstance(marker, str) else tuple(marker)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(reps):
            flush.add_(1)  # a kernel (a fill can become a memset)
            torch.cuda.synchronize(dev)
            run()
            torch.cuda.synchronize(dev)
        time.sleep(pad)
    with tempfile.TemporaryDirectory(prefix="kmer_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            kernels = sorted((e["ts"], e["dur"],
                              any(m in e.get("name", "") for m in markers))
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
                           f"named {markers} for {reps} runs")
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
    if len(ms) != len(chunks):  # timed by events: the dispatches' mean
        ms = [ms[0] / len(chunks)] * len(chunks)
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

    return np.concatenate(query_chunks(path, aa))


def query_chunks(path, aa=True):
    """The prepare phase's ``add_batch`` chunks of query 8-mer values, in
    the order it feeds them to the lookup."""
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
    return c.parts


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


# the stream lookup on one card: B2 and its device scatter and resolve (the
# sharded stream lookup scatters and decodes on the host: B2 alone)
STREAM_KERNELS = ("stream", "stream_scatter", "stream_resolve")
# the kernels each backend's cuda run must launch, and those it may launch
# (the block probe's exact rest runs the tile join)
BACKEND_KERNELS = {"auto": (STREAM_KERNELS, ()), "xla": (("tilejoin",), ()),
                   "pallas": (("blockprobe",), ("tilejoin",)),
                   "spmd": (("fused_probe",), ())}


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
    lookup: its device scatter, B2 and its device resolve, two plane
    passes) and ``--backend pallas`` (the block probe) against ``--backend
    xla`` on the card, then the stream lookup's three kernels against their
    twins on the read set's own passes (stream_tiles_vs_twins). Returns
    ((max_abs_err, kernel_ms, twin_ms, bound) of B2 on the first pass's
    tiles, the block probe's launches, the query values, the scatter's and
    the resolve's (max_abs_err, kernel_ms, twin_ms, bound, launches))."""
    import numpy as np

    from kmergutsjava_tpu_torch.lookup.stream import StreamLookup

    t0 = time.time()
    fna = os.path.join(work, "reads.fna")
    write_reads(fna, genome)
    chunks = query_chunks(fna, aa=False)
    values = np.concatenate(chunks)
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
        if backend == "auto":
            tiles_launches = (counts["stream_scatter"],
                              counts["stream_resolve"])
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
    res, scatter, resolve = stream_tiles_vs_twins(dev, lk, chunks)
    return (res, block_launches, values, (*scatter, tiles_launches[0]),
            (*resolve, tiles_launches[1]))


def engine_passes(chunks, limit=INPUT_SIZE_LIMIT):
    """The prepare's chunks grouped into the plane passes of the stream
    front end (``StreamingStreamLookup``): a pass ends after the chunk
    that brings it to ``limit`` queries."""
    passes, cur, n = [], [], 0
    for c in chunks:
        cur.append(c)
        n += len(c)
        if n >= limit:
            passes.append(cur)
            cur, n = [], 0
    return passes + ([cur] if cur else [])


def tile_split_faults(values, tiles, occ, res, num_sigs):
    """The ways a pass's device scatter breaks a valid channel split, each
    counted (all 0: valid): a placed query's cell holds its fingerprint
    below its home's count; an overflowed query's home has all C channels,
    none holding its fingerprint; a home's taken channels hold distinct
    fingerprints; cells past the count stay 0 (B2's bitmap skip)."""
    import torch

    from kmergutsjava_tpu_torch.lookup.sparse import FP_MOD

    t, o, r = _u(tiles), occ.long(), res.long()
    channels = t.shape[0]
    homes, fps = values % num_sigs, values % FP_MOD
    ok = r >= 0
    ch = torch.arange(channels, device=t.device)[:, None]
    taken = ch < o[None, :]
    held = torch.where(taken, t, -1 - ch).sort(0).values
    hn, fn = homes[~ok], fps[~ok]
    return {
        "count_past_c": int((o > channels).sum()),
        "channel_past_count": int((r[ok] >= o[homes[ok]]).sum()
                                  + (r >= channels).sum()),
        "cell_not_fingerprint": int((t[r[ok], homes[ok]] != fps[ok]).sum()),
        "overflow_home_not_full": int((o[hn] != channels).sum()),
        "overflow_fingerprint_held": int((t[:, hn] == fn[None, :]).any(
            0).sum()),
        "cell_past_count_set": int((t[~taken] != 0).sum()),
        "fingerprint_twice_in_home": int(((held[1:] == held[:-1])
                                          & (held[1:] >= 0)).sum()),
    }


def restored_ms(restore, fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events
    around each run; ``restore()`` before each, outside the events (a
    kernel that updates its inputs starts from the same state each run)."""
    import statistics

    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    got = []
    for _ in range(reps):
        restore()
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        got.append(start.elapsed_time(end))
    return statistics.median(got)


def stream_tiles_vs_twins(dev, lk, chunks):
    """The stream lookup's device stages on the read set's own chunks,
    pass by pass as the engine makes them (the first input_size_limit
    queries, then the rest), on the lookup's stream and pass set: each
    chunk scattered by the scatter kernel, timed against its twin from the
    same tiles and occupancy; the pass's split checked (tile_split_faults);
    B2 on the first pass's tiles against its twin (check_stream_kernel);
    each chunk resolved by the resolve kernel and by its twin on the same
    channels and answers, slots and counts compared bit for bit, and
    timed. Returns (B2's (max_abs_err, kernel_ms, twin_ms, bound)), then
    for the scatter and the resolve (faults or differing slots and counts,
    kernel_ms, twin_ms, bound), each summed over the launches."""
    import torch

    from kmergutsjava_tpu_torch.lookup import stream, stream_tiles
    from kmergutsjava_tpu_torch.lookup.sparse import on_stream

    ns, fw = lk.num_sigs, lk._exact.full_window
    s = lk._sets.take()
    b2 = None
    errs = {"scatter": 0, "resolve": 0}
    rows = {"scatter": [], "resolve": []}  # (kernel_ms, twin_ms, bytes, ops)
    with on_stream(lk._stream):
        for p, chunk_vals in enumerate(engine_passes(chunks)):
            parts = []
            for i, c in enumerate(chunk_vals):
                v = torch.from_numpy(c).to(dev)
                r = torch.empty(len(c), dtype=torch.int32, device=dev)
                t0, o0 = s.tiles.clone(), s.occ.clone()

                def restore():
                    s.tiles.copy_(t0)
                    s.occ.copy_(o0)

                t_ms = restored_ms(restore, lambda: stream_tiles.
                                   scatter_reference(v, s.tiles, s.occ, r,
                                                     ns), 3)
                k_ms = restored_ms(restore, lambda: stream_tiles.
                                   scatter_tiles(v, s.tiles, s.occ, r, ns),
                                   9)
                cells = int(s.occ.long().sum() - o0.long().sum())
                nbytes = 12 * len(c) + 3 * cells
                bnd = bound(nbytes, len(c))
                print(f"phase 7: scatter pass {p} chunk {i} queries="
                      f"{len(c)} slots={s.tiles.shape[1]} cells_written="
                      f"{cells} overflow={int((r < 0).sum())} "
                      f"kernel_ms={k_ms:.4f} twin_ms={t_ms:.4f} "
                      f"{bound_fields(k_ms, bnd)}", flush=True)
                rows["scatter"].append((k_ms, t_ms, nbytes, len(c)))
                parts.append((v, r))
                del t0, o0
            values = torch.cat([v for v, _ in parts])
            faults = tile_split_faults(values, s.tiles, s.occ,
                                       torch.cat([r for _, r in parts]), ns)
            print(f"phase 7: scatter pass {p} queries={len(values)} "
                  f"split faults {json.dumps(faults)}", flush=True)
            errs["scatter"] += sum(faults.values())
            del values
            if b2 is None:
                b2 = check_stream_kernel(dev, "phase 7: one pass's tiles "
                                         "(the device scatter's)", lk.fp,
                                         s.tiles, lk.w)
            answers = stream.stream_probe(lk.fp, s.tiles, lk.w, lk.channels,
                                          out=s.answers)
            for i, (v, ch) in enumerate(parts):
                got, want = ch.clone(), ch.clone()
                kc = torch.zeros(3, dtype=torch.int64, device=dev)
                tc = torch.zeros(3, dtype=torch.int64, device=dev)
                args = (answers, lk.fe, lk.hk, ns, lk.w, fw)
                stream_tiles.resolve_tiles(v, got, *args, kc)
                stream_tiles.resolve_reference(v, want, *args, tc)
                err = int((got != want).sum() + (kc != tc).sum())
                over, fell, hits = kc.tolist()
                res = ch.clone()

                def restore():
                    res.copy_(ch)

                k_ms = restored_ms(restore, lambda: stream_tiles.
                                   resolve_tiles(v, res, *args, kc), 9)
                t_ms = restored_ms(restore, lambda: stream_tiles.
                                   resolve_reference(v, res, *args, tc), 3)
                bnd = bound(29 * len(v), len(v))
                print(f"phase 7: resolve pass {p} chunk {i} queries={len(v)}"
                      f" overflow={over} fallback={fell} hits={hits} "
                      f"differing={err} kernel_ms={k_ms:.4f} "
                      f"twin_ms={t_ms:.4f} {bound_fields(k_ms, bnd)}",
                      flush=True)
                errs["resolve"] += err
                rows["resolve"].append((k_ms, t_ms, 29 * len(v), len(v)))
            del parts, answers
            s.zero()
    torch.cuda.synchronize(dev)
    lk._sets.give_back(s)
    got = [b2]
    for k in ("scatter", "resolve"):
        k_ms, t_ms, nbytes, ops = (sum(col) for col in zip(*rows[k]))
        got.append((errs[k], k_ms, t_ms, bound(nbytes, ops)))
    return tuple(got)


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
        check_launches("phase 11 stream", counts, STREAM_KERNELS)
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


def bound_fused_step(in_bytes, windows, out_per_window, first, reads,
                     plane_slots):
    """The fused kernel: its rows and counts (and a long contig's row_map,
    own_start and own_end) in once, each window's answer out once (2 B in
    B1's form, 4 B in B12's), and for each valid window (at a mesh position,
    each owned one; ``first`` its home in the plane, ``reads`` the slots up
    to and including its first event, or the window) the plane's 32-byte
    sectors under those slots, as bound_shard_probe counts them, at most
    the whole plane; 16 integer operations a window (packing, residues)
    and one a slot compared."""
    sectors = int(((first + reads - 1) // 16 - first // 16 + 1).sum())
    return bound(in_bytes + out_per_window * windows
                 + min(32 * sectors, 2 * plane_slots),
                 16 * windows + int(reads.sum()))


def first_event_reads(plane, homes, fps, w, chunk=1 << 20):
    """For each valid window whose w-slot window lies on ``plane`` (B1's
    form reads nothing for the rest): its home and the slots B1 reads, up
    to and including its first candidate or empty slot, else w."""
    import torch

    from kmergutsjava_tpu_torch.lookup.tilejoin import FP_EMPTY, _widen

    homes, fps = homes.reshape(-1), fps.reshape(-1)
    ok = (homes >= 0) & (homes.long() + w <= plane.numel())
    h, q = homes[ok].long(), _widen(fps)[ok]  # no uint16 mask on cuda
    slots = _widen(plane)
    rel = torch.arange(w, device=plane.device)
    reads = []
    for s in range(0, h.numel(), chunk):
        win = slots[h[s:s + chunk, None] + rel]
        ev = (win == q[s:s + chunk, None]) | (win == FP_EMPTY)
        reads.append(torch.where(ev.any(1), ev.int().argmax(1) + 1, w))
    return h, torch.cat(reads) if reads else h


def window_batches(prots, genome_fna, reads_fna):
    """The fused step's real launch shapes, as host arrays: one proteome
    bucket batch (512 proteins of at most 256 residues, the fused step's
    first bucket and batch), one read batch (512 reads in the 256-base
    bucket) and the genome's window batch (plan_windows at WIN_NT).
    Returns {label: (aa, ascii, counts, windowed extras or None)}."""
    import numpy as np

    from kmergutsjava_tpu_torch.constants import K
    from kmergutsjava_tpu_torch.formats.fasta import read_fasta
    from kmergutsjava_tpu_torch.models.spmd import WIN_NT
    from kmergutsjava_tpu_torch.parallel.seq_windows import plan_windows

    def rows(seqs, width):
        mat = np.zeros((len(seqs), width), np.uint8)
        for i, q in enumerate(seqs):
            mat[i, :len(q)] = np.frombuffer(q.encode("latin-1"), np.uint8)
        return mat, np.array([len(q) for q in seqs], np.int32)

    short = [p.seq for p in prots if len(p.seq) <= 256][:512]
    mat, lens = rows(short, 256)
    out = {"proteome bucket 256 x 512": (True, mat, lens - K, None)}
    reads = []
    for rec in read_fasta(reads_fna):
        reads.append(rec.seq)
        if len(reads) == 512:
            break
    out["read batch 256 x 512"] = (False, *rows(reads, 256), None)
    g = next(iter(read_fasta(genome_fna))).seq
    plan = plan_windows(len(g), WIN_NT)
    a = np.full((len(plan["s"]), WIN_NT), ord("N"), np.uint8)
    gb = np.frombuffer(g.encode("latin-1"), np.uint8)
    for i, (s0, e0) in enumerate(zip(plan["s"], plan["e"])):
        a[i, :e0 - s0] = gb[s0:e0]
    out[f"genome windows {WIN_NT} x {len(plan['s'])}"] = (
        False, a, plan["len_w"].astype(np.int32),
        tuple(plan[k].astype(np.int32)
              for k in ("row_map", "own_start", "own_end")))
    return out


def fused_kernel_vs_twin(dev, batches, plane, pw):
    """At the real launch shapes: B1 on the window twin's homes and
    fingerprints (``windows_reference`` on the card's tensors, at the
    sparse table's num_sigs) at the fused step's full window ``pw`` on the
    sparse table's ``plane`` (off and state, invalid windows included),
    against B1's twin; then the fused kernel's first-event entry (one
    launch a batch of the fused step on one card) against its twin, every
    off and state equal, with its device time a launch (kernel_device_ms,
    the L2 flushed before each), its twin's time and its bound. Returns
    ({label: the fused kernel's (max_abs_err, ms, twin_ms, bound)}, B1's
    max_abs_err over all batches)."""
    import torch

    from kmergutsjava_tpu_torch.lookup import tilejoin
    from kmergutsjava_tpu_torch.ops import kmer_windows as kw
    from kmergutsjava_tpu_torch.parallel import fused_probe as fp

    num_sigs = plane.numel() - pw
    fused, b1_err = {}, 0
    for label, (aa, mat, counts, extra) in batches.items():
        a = torch.from_numpy(mat).to(dev)
        c = torch.from_numpy(counts).to(dev)
        ex = [torch.from_numpy(x).to(dev) for x in extra or ()]
        th, tf = kw.windows_reference(a, c, aa, num_sigs, *ex)
        valid = int((th >= 0).sum())
        # B1 on these windows against its twin
        n = th.numel()
        off_k, st_k = tilejoin.answer_views(tilejoin.probe_answer(
            plane, tf.view(-1), th.view(-1), pw), n)
        off_t, st_t = tilejoin.first_event_reference(plane, tf.view(-1),
                                                     th.view(-1), pw)
        torch.cuda.synchronize(dev)
        e1 = max(int((off_k.int() - off_t.int()).abs().max()),
                 int((st_k.int() - st_t.int()).abs().max()))
        b1_err = max(b1_err, e1)
        states = torch.bincount(st_k.long(), minlength=3).tolist()
        print(f"phase 12: B1 on the window twin's {label} windows={n} "
              f"pw={pw} states(0/1/2)={states} max_abs_err={e1}", flush=True)
        del off_k, st_k, off_t, st_t
        in_b = mat.nbytes + counts.nbytes + sum(x.nbytes for x in extra or ())

        # the fused kernel (first-event form) against its twin on the same
        # rows
        def fused_run():
            return fp.first_event(plane, a, c, aa, num_sigs, pw, *ex)

        views = [tilejoin.answer_views(x, n) for x in (
            fused_run(), fp.first_event_reference(plane, a, c, aa, num_sigs,
                                                  pw, *ex))]
        torch.cuda.synchronize(dev)
        f_err = max(int((views[0][k].int() - views[1][k].int()).abs().max())
                    for k in range(2))
        f_states = torch.bincount(views[0][1].long(), minlength=3).tolist()
        del views
        f_ms, kept = kernel_device_ms(fused_run, dev, "fused_probe_kernel",
                                      key=f"fused {label}")
        f_t_ms = timed(lambda: fp.first_event_reference(
            plane, a, c, aa, num_sigs, pw, *ex), dev)
        first, reads = first_event_reads(plane, th, tf, pw)
        f_bnd = bound_fused_step(in_b, n, 2, first, reads, plane.numel())
        print(f"phase 12: fused kernel first-event {label} windows={n} "
              f"valid={valid} pw={pw} states(0/1/2)={f_states} "
              f"max_abs_err={f_err} (twin) device_ms={f_ms[0]:.5f} "
              f"runs_kept={kept}/5 twin_ms={f_t_ms:.4f} "
              f"{bound_fields(f_ms[0], f_bnd)}", flush=True)
        fused[label] = (f_err, f_ms[0], f_t_ms, f_bnd)
        del a, c, ex, th, tf, first, reads
    return fused, b1_err


def bound_ragged(n_bytes, rows, containers, valid, positions):
    """The window kernel's ragged entry: the bytes and row bounds in once,
    each valid window's value and position (12 B) and each container's
    count (4 B) out once; 16 integer operations a position (packing and
    its checks)."""
    return bound(n_bytes + 4 * (rows + 1) + 12 * valid + 4 * containers,
                 16 * positions)


def ragged_vs_twin(dev, prepares):
    """Phase 12: the window kernel's ragged entry at the ``--prepare jax``
    runs' own calls (taken by a spy on its wrapper: {cell: (aa, calls)}),
    each call's values, positions and counts equal to the twin's on the
    same inputs; the device time of a whole prepare's calls (the two
    kernels of each, summed; kernel_device_ms, the L2 flushed before the
    prepare), the twin's, the bound. Returns {cell: (max_abs_err, ms,
    twin_ms, bound, calls, kernel ms by name (zero, pass))}."""
    from kmergutsjava_tpu_torch.ops import kmer_windows as kw

    res = {}
    for cell, (aa, calls) in prepares.items():
        args = [a for a, _, _ in calls]
        err = 0
        for a, (values, pos, counts) in zip(args, (c for _, _, c in calls)):
            want = kw.ragged_values_reference(*a)
            if values.numel() != want[0].numel():
                err = max(err, abs(values.numel() - want[0].numel()))
                continue
            for g, w in zip((values, pos, counts), want):
                if g.numel():
                    err = max(err, int((g.long() - w.long()).abs().max()))

        def run():
            return [kw.ragged_values(*a) for a in args]

        ms, kept = kernel_device_ms(run, dev, "ragged_")
        each = len(ms) // len(args)  # kernels a call (0: timed by events)
        by_kernel = [sum(ms[i::each]) for i in range(each)] or ms
        t_ms = timed(lambda: [kw.ragged_values_reference(*a) for a in args],
                     dev, reps=2)
        n_bytes = sum(a[0].numel() for a in args)
        rows = sum(a[1].numel() - 1 for a in args)
        valid = sum(c[0].numel() for _, _, c in calls)
        containers = sum(c[2].numel() for _, _, c in calls)
        bnd = bound_ragged(n_bytes, rows, containers, valid,
                           n_bytes if aa else 2 * n_bytes)
        print(f"phase 12: ragged entry {cell} --prepare jax calls="
              f"{len(args)} kernels={len(ms)} bytes={n_bytes} rows={rows} "
              f"valid_windows={valid} max_abs_err={err} device_ms="
              f"{sum(ms):.5f} by_kernel={[round(x, 5) for x in by_kernel]} "
              f"(zero, pass) runs_kept={kept}/5 twin_ms={t_ms:.3f} "
              f"{bound_fields(sum(ms), bnd)}", flush=True)
        res[cell] = (err, sum(ms), t_ms, bnd, len(args), by_kernel)
    return res


def spmd_phase(dev, work, corpus, faa, fna, big, reads, prots, plane, pw):
    """Phase 12: the fused path (``--backend spmd``: one launch of the
    fused kernel a batch) and the device prepare (``--prepare jax``: the
    window kernel's ragged entry) on the card: the goldens, phase 4's and
    phase 7's reports, launches, cold wall times in turns against xla and
    auto, and B1 on the window twin's windows and the fused kernel against
    their twins at the real launch shapes; then the ragged entry at the
    ``--prepare jax`` runs' own calls (ragged_vs_twin). Returns ((the
    fused kernel's launches on the sparse proteome's spmd run, {cell: the
    ragged entry's calls on its ``--prepare jax`` run}),
    fused_kernel_vs_twin's result, ragged_vs_twin's result)."""
    def read(path):
        with open(path, "rb") as fh:
            return fh.read()

    def gunzip(name):
        with gzip.open(os.path.join(HERE, "tests", "data", name), "rb") as fh:
            return fh.read()

    def one(label, d, query, aa, extra, want, must):
        reset_counts()
        out = os.path.join(work, f"spmd_{len(os.listdir(work))}.txt")
        info, secs = run_cli(d, query, out, "cuda", extra, aa=aa)
        counts = read_counts()
        got = read(out)
        print(f"phase 12: {label} {' '.join(extra)} report_bytes={len(got)} "
              f"identical={got == want} launches={counts} wall_s={secs:.3f} "
              f"{phase_ms(info)}", flush=True)
        if got != want:
            raise RuntimeError(f"phase 12: {label} {extra} differs from "
                               "its reference")
        check_launches(f"phase 12 {label}", counts, must)
        return counts, secs

    spmd = ("--backend", "spmd")
    spmd_kernels = BACKEND_KERNELS["spmd"][0]
    one("golden_aa_full", corpus, faa, True, spmd,
        gunzip("golden_aa_full.txt.gz"), spmd_kernels)
    one("golden_dna_full (4.64 Mbp, windowed)", corpus, fna, False, spmd,
        gunzip("golden_dna_full.txt.gz"), spmd_kernels)
    want_aa = read(os.path.join(work, "big_cuda.txt"))
    want_reads = read(os.path.join(work, "reads_auto.txt"))
    counts, _ = one("sparse proteome", big, faa, True, spmd, want_aa,
                    spmd_kernels)
    fused_launches = counts["fused_probe"]
    print(f"phase 12: sparse proteome spmd fused_probe_launches="
          f"{fused_launches} (one a batch; B1 {counts['tilejoin']})",
          flush=True)
    from kmergutsjava_tpu_torch.ops import kmer_windows

    prepares, ragged_launches = {}, {}
    for cell, query, aa, want in (("sparse proteome", faa, True, want_aa),
                                  ("dense read set", reads, False,
                                   want_reads)):
        with spied(kmer_windows, "ragged_values", []) as calls:
            counts, _ = one(cell, big, query, aa,
                            ("--prepare", "jax", "--backend", "xla"), want,
                            ("kmer_ragged", "tilejoin"))
        prepares[cell] = (aa, calls)
        ragged_launches[cell] = counts["kmer_ragged"]
    launches = (fused_launches, ragged_launches)
    one("dense read set", big, reads, False, spmd, want_reads, spmd_kernels)

    # cold runs in turns: every run reads the table and builds its lookup
    # (or the fused program) as a fresh process would
    walls = {}
    for _ in range(3):
        for cell, query, aa, backends in (
                ("sparse proteome", faa, True, ("spmd", "xla")),
                ("dense read set", reads, False, ("spmd", "auto", "xla"))):
            for backend in backends:
                clear_engine_caches()
                _, secs = run_cli(big, query, os.path.join(work, "cold.txt"),
                                  "cuda", ("--backend", backend), aa=aa)
                walls.setdefault((cell, backend), []).append(round(secs, 3))
    for (cell, backend), secs in walls.items():
        print(f"phase 12: cold wall_s {cell} backend={backend} {secs}",
              flush=True)
    batches = window_batches(prots, fna, reads)
    return (launches, fused_kernel_vs_twin(dev, batches, plane, pw),
            ragged_vs_twin(dev, prepares))


def run_engine(data_dir, query, out_path, aa=True, **cfg):
    """The port's Engine on the card, through its API (``mesh_devices`` is
    not a CLI flag), the report to ``out_path``; returns (info lines,
    seconds)."""
    from kmergutsjava_tpu_torch.config import EngineConfig
    from kmergutsjava_tpu_torch.models.pipeline import Engine

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf), open(out_path, "w") as out:
        Engine(EngineConfig(aa=aa, device="cuda", **cfg)).run(
            data_dir, query, out, stdout=False)
    return buf.getvalue(), time.time() - t0


def cached_mesh():
    """The mesh of the lookup (or fused program) the last run left in the
    engine's one-slot cache, or None (a single-device lookup)."""
    from kmergutsjava_tpu_torch.models import pipeline

    return getattr(next(iter(pipeline._LOOKUP_CACHE.values())), "mesh",
                   None)


def bound_shard_probe(homes, answer, lo, s_loc, w):
    """B12: each query's home and fingerprint in and its answer out (10 B),
    and for the queries the shard owns the plane's 32-byte sectors from
    the home to the first match (or the window's end); one operation a
    query and a slot compared."""
    import torch

    local = homes.long() - lo
    mine = (local >= 0) & (local < s_loc)
    last = torch.where(answer > 0, answer.long() - lo - local, w)[mine]
    first = local[mine]
    sectors = int(((first + last - 1) // 16 - first // 16 + 1).sum())
    return bound(10 * homes.numel() + min(32 * sectors, 2 * (s_loc + w)),
                 homes.numel() + int(last.sum()))


def bound_route_bins(n, cells):
    """B13's binning: each query's home and fingerprint in and its cell out
    (10 B), every cell of the bins written (6 B); one operation a query and
    a cell."""
    return bound(10 * n + 6 * cells, n + cells)


def route_shard0(table, values, dev, shards=4):
    """Phase 13's B13 shape: the first of ``shards`` source shards of the
    proteome's queries in the routed run (cap 2 x its mean load a bin).
    Returns (q_fp u16, homes int32) on the card and (n_valid, s_loc,
    shards, cap)."""
    import numpy as np
    import torch

    from kmergutsjava_tpu_torch.lookup.sparse import FP_MOD

    n = len(values)
    n_loc = -(-n // shards)
    cap = max(64, int(n_loc / shards * 2.0))
    s_loc = -(-table.num_sigs // shards)
    v = np.zeros(n_loc * shards, np.int64)
    v[:n] = values
    q = torch.from_numpy((v[:n_loc] % FP_MOD).astype(np.uint16)).to(dev)
    h = torch.from_numpy((v[:n_loc] % table.num_sigs).astype(
        np.int32)).to(dev)
    return q, h, (min(n, n_loc), s_loc, shards, cap)


def route_owners(h, n_valid, s_loc, shards):
    """int32 owners of a B13 shard's queries, as the binning computes them
    (padded queries on owner T): the input of its library call."""
    import torch

    owner = torch.div(h, s_loc, rounding_mode="floor").clamp_(0, shards - 1)
    owner[n_valid:] = shards
    return owner


def library_device_ms(run, dev, reps=5, key="library", events=False):
    """Device milliseconds of every kernel one ``run()`` of a library call
    launches (whatever their names), summed, over ``reps`` runs after a
    warm-up: a torch.profiler trace in which a 256 MB bitwise-not, which
    also evicts the L2, parts the runs. A trace that lost kernel records
    is taken again, and ``events`` or a loss at TRACE_PAD_MAX_S times the
    runs by events, ``key`` going into EVENT_TIMED, as in
    kernel_device_ms. Returns (ms, kernels a run: None when timed by
    events)."""
    import torch

    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    run()
    torch.cuda.synchronize(dev)
    got = None if events else traced(
        lambda pad: _traced_library_runs(run, dev, reps, flush, pad),
        f"library_device_ms of {key}")
    if got is not None:
        return got
    EVENT_TIMED.add(key)
    return event_runs_ms(run, dev, key, reps, flush), None


def _traced_library_runs(run, dev, reps, flush, pad):
    """One torch.profiler trace of ``reps`` flushed runs of a library call,
    ``pad`` seconds idle before and after them; see library_device_ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(reps):
            flush.bitwise_not_()
            torch.cuda.synchronize(dev)
            run()
            torch.cuda.synchronize(dev)
        time.sleep(pad)
    with tempfile.TemporaryDirectory(prefix="kmer_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            kernels = sorted((e["ts"], e["dur"], "bitwise_not" in e["name"])
                             for e in json.load(fh)["traceEvents"]
                             if e.get("ph") == "X"
                             and e.get("cat") in ("kernel", "gpu_memset"))
    per_run = []
    for _, dur, is_flush in kernels:
        if is_flush:
            per_run.append([])
        elif per_run:
            per_run[-1].append(dur)
    counts = [len(r) for r in per_run]
    k = max(set(counts), key=counts.count, default=0)
    whole = [r for r in per_run if len(r) == k]
    if k == 0 or 2 * len(whole) < reps:
        raise RuntimeError(f"the trace holds runs of {counts} kernels for "
                           f"{reps} runs of the library call")
    return sum(map(sum, whole)) / len(whole) / 1000.0, k


def bound_route_unbin(n, answered):
    """B13's un-binning: each query's cell in (4 B) and its offset, state
    and overflow flag out (3 B), and the two answer bytes of each answered
    query's cell."""
    return bound(7 * n + 2 * answered, n)


@contextlib.contextmanager
def routed_trips():
    """Counts, for the enclosed work, the routed lookup's probes, its
    exchanges (``forward``: the fingerprint and home bins; ``answer``: the
    u8 back buffers) and its read-backs (copies to the host of an
    un-binning's [3, ld] buffer), each taken by a spy; yields the counts.
    """
    import torch

    from kmergutsjava_tpu_torch.parallel import routed_lookup

    counts = {"probes": 0, "forward_exchanges": 0, "answer_exchanges": 0,
              "read_backs": 0, "shards": 0}
    real_a2a = routed_lookup.all_to_all
    real_probe = routed_lookup.RoutedLookup.probe
    real_cpu = torch.Tensor.cpu
    inside = []

    def a2a(mesh, sends, outs):
        answer = any(o is not None and o.dtype == torch.uint8 for o in outs)
        counts["answer_exchanges" if answer else "forward_exchanges"] += 1
        return real_a2a(mesh, sends, outs)

    def probe(self, values):
        counts["probes"] += 1
        counts["shards"] += len([t for t in range(self.n_shards)
                                 if self.mesh.local(0, t)])
        inside.append(True)
        try:
            return real_probe(self, values)
        finally:
            inside.pop()

    def cpu(self, *args, **kwargs):
        if inside and self.dtype == torch.uint8 and self.dim() == 2 \
                and self.shape[0] == 3:
            counts["read_backs"] += 1
        return real_cpu(self, *args, **kwargs)

    routed_lookup.all_to_all = a2a
    routed_lookup.RoutedLookup.probe = probe
    torch.Tensor.cpu = cpu
    try:
        yield counts
    finally:
        routed_lookup.all_to_all = real_a2a
        routed_lookup.RoutedLookup.probe = real_probe
        torch.Tensor.cpu = real_cpu


def check_trips(label, trips):
    """The routed lookup's return trip: one answer exchange a probe and one
    read-back a shard of this process."""
    if trips["answer_exchanges"] != trips["probes"] \
            or trips["read_backs"] != trips["shards"]:
        raise RuntimeError(f"{label}: {trips}: not one answer exchange a "
                           "probe and one read-back a shard")


def mesh_devices_of_card():
    """Phase 13's four mesh positions: on four distinct cards where the
    machine has them, else repeated over the cards there are."""
    import torch

    n_cards = torch.cuda.device_count()
    return [f"cuda:{i % n_cards}" for i in range(4)]


def mesh_runs(work, big, faa, reads, tj_launches, fused_launches):
    """Phase 13's runs: the CLI at ``--mesh 1x1``, the Engine over four
    mesh positions and two single-device runs; each report against phase
    4's or phase 7's, each mesh on CUDA devices only, each run launching
    its kernels (the keys of its ``predicted``) as often as predicted
    (None: any number) and no others. Returns (B12's launches in the
    sharded (2, 2) run, B13's binning and un-binning launches in the
    routed run, the fused kernel's launches in the (2, 2) spmd run of the
    proteome)."""
    def read(path):
        with open(path, "rb") as fh:
            return fh.read()

    want = {True: read(os.path.join(work, "big_cuda.txt")),
            False: read(os.path.join(work, "reads_auto.txt"))}
    query = {True: faa, False: reads}
    four = mesh_devices_of_card()

    def one(label, aa, backend, predicted, cli_mesh=None, **cfg):
        reset_counts()
        out = os.path.join(work, f"mesh_{len(os.listdir(work))}.txt")
        with routed_trips() as trips:
            if cli_mesh:
                info, secs = run_cli(big, query[aa], out, "cuda",
                                     ("--backend", backend, "--mesh",
                                      cli_mesh), aa=aa)
            else:
                info, secs = run_engine(big, query[aa], out, aa=aa,
                                        backend=backend, **cfg)
        counts = read_counts()
        got = read(out)
        m = cached_mesh()
        devs = [] if m is None else [d for row in m.devices for d in row]
        shape = None if m is None else (m.shape["data"], m.shape["table"])
        print(f"phase 13: {label} backend={backend} mesh={shape} positions="
              f"{len(devs)} distinct_cards={len({str(d) for d in devs})} "
              f"report_bytes={len(got)} identical={got == want[aa]} "
              f"launches={counts} wall_s={secs:.3f} {phase_ms(info)}"
              + (f" routed_trips={trips}" if trips["probes"] else ""),
              flush=True)
        if trips["probes"]:
            check_trips(f"phase 13: {label} {backend}", trips)
        if got != want[aa]:
            raise RuntimeError(f"phase 13: {label} {backend} differs from "
                               f"phase {4 if aa else 7}'s report")
        if any(d.type != "cuda" for d in devs):
            raise RuntimeError(f"phase 13: {label} placed a shard off the "
                               f"card: {devs}")
        check_launches(f"phase 13 {label} {backend}", counts,
                       tuple(predicted))
        for name, n in predicted.items():
            if n is not None and counts[name] != n:
                raise RuntimeError(f"phase 13: {label} {backend} launched "
                                   f"{name} {counts[name]} times, "
                                   f"predicted {n}")
        return counts

    routed = {"route_bins": 1, "route_unbin": 1, "tilejoin": 1}
    # the CLI on one card at a 1x1 mesh (xla keeps its one-device lookup;
    # auto routes, since the proteome is sparse against this table)
    for backend, predicted in (("sharded", {"shard_probe": 1}),
                               ("routed", routed),
                               ("replicated", {"tilejoin": tj_launches}),
                               ("xla", {"tilejoin": tj_launches}),
                               ("auto", routed)):
        one("cli --mesh 1x1 proteome", True, backend, predicted,
            cli_mesh="1x1")
    passes = one("cli --mesh 1x1 reads", False, "stream", {"stream": None},
                 cli_mesh="1x1")["stream"]
    if passes < 2:
        raise RuntimeError(f"phase 13: {passes} plane passes for the read "
                           "set")
    # the Engine over four mesh positions: B12 once a position a step, B13
    # and B1 once a shard, B1 and B2 once a table shard a dispatch or pass,
    # B1 once a data device a dispatch (of a device's 2^19 queries), the
    # fused kernel once a position a batch
    b12 = one("engine proteome", True, "sharded", {"shard_probe": 4},
              mesh_shape=(2, 2), mesh_devices=four)["shard_probe"]
    one("engine proteome", True, "sharded", {"shard_probe": 4},
        mesh_shape=(1, 4), mesh_devices=four)
    counts = one("engine proteome", True, "routed",
                 {k: 4 for k in routed}, mesh_shape=(1, 4),
                 mesh_devices=four)
    b13 = (counts["route_bins"], counts["route_unbin"])
    one("engine proteome", True, "replicated",
        {"tilejoin": 2 * -(-tj_launches // 2)}, mesh_shape=(2, 1),
        mesh_devices=four)
    one("engine proteome", True, "xla", {"tilejoin": 4 * tj_launches},
        mesh_shape=(1, 4), mesh_devices=four)
    one("engine reads", False, "stream", {"stream": 4 * passes},
        mesh_shape=(1, 4), mesh_devices=four)
    spmd = (one("engine proteome", True, "spmd",
                {"fused_probe": 4 * fused_launches}, mesh_shape=(2, 2),
                mesh_devices=four)["fused_probe"],
            one("engine reads", False, "spmd", {"fused_probe": None},
                mesh_shape=(2, 2), mesh_devices=four)["fused_probe"])
    if spmd[1] % 4:
        raise RuntimeError(f"phase 13: spmd on the read set launched the "
                           f"fused kernel {spmd[1]} times: not once a "
                           "position a batch")
    # the single-device runs in the same conditions, for their wall times
    one("engine proteome single-device", True, "xla",
        {"tilejoin": tj_launches})
    one("engine reads single-device", False, "auto",
        {"stream": passes, "stream_scatter": None, "stream_resolve": None})
    return b12, b13, spmd[0]


def mesh_kernels_vs_twins(dev, big, faa):
    """Phase 13's kernels against their twins on the card at the mesh
    runs' shapes. B12: data row 0's queries of the sharded (2, 2) run (the
    proteome padded to 2 x 256) against each of the two table shards. B13:
    shard 0's queries of the routed run over 4 shards (cap 2 x its mean
    load a bin), its bins and cells, and the un-binning of answers the
    size of its back buffers. Every output equal; device times
    (kernel_device_ms, the L2 flushed), the twins' (CUDA events) and the
    bounds. Returns {"shard_probe": (...), "route_bins": (...),
    "route_unbin": (...)}, each (max_abs_err, kernel_ms, twin_ms,
    bound)."""
    import numpy as np
    import torch

    from kmergutsjava_tpu_torch.formats.kmer_table import \
        resolve_table_files
    from kmergutsjava_tpu_torch.lookup.sparse import FP_MOD
    from kmergutsjava_tpu_torch.models.pipeline import _cached_read_table
    from kmergutsjava_tpu_torch.parallel import route_bins, shard_probe
    from kmergutsjava_tpu_torch.parallel.sharded_lookup import \
        shard_table_planes

    table = _cached_read_table(resolve_table_files(big)[0])
    values = query_values(faa)
    n = len(values)
    res = {}

    # B12 at the sharded (2, 2) run's shape
    pw = max(8, table.max_probe)
    planes = shard_table_planes(table, 2, pw)
    s_loc = planes["s_loc"]
    n_pad = -(-n // 512) * 512
    v = np.zeros(n_pad, np.int64)
    v[:n] = values
    half = v[:n_pad // 2]
    q = torch.from_numpy((half % FP_MOD).astype(np.uint16)).to(dev)
    h = torch.from_numpy((half % table.num_sigs).astype(np.int32)).to(dev)
    per_shard = []
    for t in range(2):
        plane = torch.from_numpy(planes["fp"][t]).to(dev)

        def run():
            return shard_probe.shard_probe(plane, q, h, t * s_loc, s_loc, pw)

        got = run()
        twin = shard_probe.shard_probe_reference(plane, q, h, t * s_loc,
                                                 s_loc, pw)
        torch.cuda.synchronize(dev)
        err = int((got.long() - twin.long()).abs().max())
        ms, kept = kernel_device_ms(run, dev, "shard_probe_kernel",
                                    key=f"B12 shard {t}")
        t_ms = timed(lambda: shard_probe.shard_probe_reference(
            plane, q, h, t * s_loc, s_loc, pw), dev)
        bnd = bound_shard_probe(h, got, t * s_loc, s_loc, pw)
        owned = int(((h >= t * s_loc) & (h < (t + 1) * s_loc)).sum())
        print(f"phase 13: B12 table shard {t} of 2 queries={h.numel()} "
              f"owned={owned} s_loc={s_loc} pw={pw} "
              f"candidates={int((got > 0).sum())} max_abs_err={err} "
              f"device_ms={ms[0]:.5f} runs_kept={kept}/5 twin_ms={t_ms:.4f} "
              f"{bound_fields(ms[0], bnd)}", flush=True)
        per_shard.append((err, ms[0], t_ms, bnd))
        del plane, got, twin
    # the line's numbers are table shard 0's; its error is both shards'
    res["shard_probe"] = (max(r[0] for r in per_shard),) + per_shard[0][1:]

    # B13 at the routed run's shape (4 shards)
    q, h, (n_valid, r_s_loc, shards, cap) = route_shard0(table, values, dev)
    n_loc = h.numel()

    def bins():
        return route_bins.bins(q, h, n_valid, r_s_loc, shards, cap)

    got = bins()
    twin = route_bins.bins_reference(q, h, n_valid, r_s_loc, shards, cap)
    torch.cuda.synchronize(dev)
    err = max(int((_u(a) - _u(b)).abs().max()) for a, b in zip(got, twin))
    owner = route_owners(h, n_valid, r_s_loc, shards)
    (ms, kept), (lib_ms, lib_kernels) = same_timing(
        lambda ev: kernel_device_ms(bins, dev, "route_", events=ev),
        lambda ev: library_device_ms(
            lambda: torch.argsort(owner, stable=True), dev, key="argsort",
            events=ev))
    t_ms = timed(lambda: route_bins.bins_reference(q, h, n_valid, r_s_loc,
                                                   shards, cap), dev)
    bnd = bound_route_bins(n_loc, shards * cap)
    print(f"phase 13: B13 bins shard 0 of {shards} queries={n_loc} "
          f"cap={cap} overflow={int((got[2] < 0).sum())} max_abs_err={err} "
          f"device_ms={sum(ms):.5f} by_kernel={[round(x, 5) for x in ms]} "
          f"(rank, scan, fill, scatter) runs_kept={kept}/5 "
          f"twin_ms={t_ms:.4f} library_ms={lib_ms:.5f} (torch.argsort of "
          f"the int32 owners, stable: {lib_kernels} kernels) "
          f"{bound_fields(sum(ms), bnd)}", flush=True)
    res["route_bins"] = (err, sum(ms), t_ms, bnd, lib_ms)
    cell = got[2]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    back = torch.randint(0, 256, (shards, 2, cap), dtype=torch.uint8,
                         device=dev, generator=gen)

    def unbin():
        return route_bins.unbin(cell, back)

    got = unbin()
    twin = route_bins.unbin_reference(cell, back)
    torch.cuda.synchronize(dev)
    err = int((got.int() - twin.int()).abs().max())
    t_ms = timed(lambda: route_bins.unbin_reference(cell, back), dev)
    bnd = bound_route_unbin(n_loc, int((cell >= 0).sum()))
    timers = [lambda ev: kernel_device_ms(unbin, dev, "route_unbin",
                                          events=ev)]
    # its library yardstick, where no query overflows (index_select takes
    # no -1): the same [3, n] answer by PyTorch calls, an index_select of
    # the back buffer's offsets and states (as [2, T * cap]) by the cells,
    # and the flags
    if int((cell < 0).sum()) == 0:
        def take():
            rows = back.transpose(0, 1).reshape(2, shards * cap)
            return torch.cat((torch.index_select(rows, 1, cell),
                              (cell < 0).to(torch.uint8)[None]))

        err = max(err, int((take().int() - got[:, :n_loc].int()).abs()
                           .max()))
        timers.append(lambda ev: library_device_ms(
            take, dev, key="index_select", events=ev))
    (ms, kept), *lib = same_timing(*timers)
    lib_ms = lib[0][0] if lib else None
    print(f"phase 13: B13 unbin shard 0 of {shards} queries={n_loc} "
          f"cap={cap} overflow={int((cell < 0).sum())} max_abs_err={err} "
          f"device_ms={ms[0]:.5f} runs_kept={kept}/5 twin_ms={t_ms:.4f} "
          f"library_ms={lib_ms} (the back buffer's rows as [2, T * cap], "
          f"an index_select of them by cell, the flags, a cat) "
          f"{bound_fields(ms[0], bnd)}", flush=True)
    res["route_unbin"] = (err, ms[0], t_ms, bnd, lib_ms)
    return res


@contextlib.contextmanager
def spied(module, name, calls):
    """``module.name`` wrapped for the enclosed work: each call's arguments,
    keywords and a copy of its result (a tensor or a tuple of them, made on
    the caller's stream, before the path can sum into it) are appended to
    ``calls``."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, tuple(x.clone() for x in out)
                      if isinstance(out, tuple) else out.clone()))
        return out

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def mesh_inputs_vs_twins(big, faa, batches, four):
    """Phase 13: the fused kernel and B1 against their twins on the very
    inputs the mesh paths give them, each call taken by a spy on its
    wrapper: the fused kernel's shard entry in the (2, 2) ``spmd`` step on
    phase 12's proteome bucket batch and read batch (a data slice's rows
    against a table shard, a position a launch), each answer equal to its
    twin's, with its device time a launch and its bound; B1 at the four
    routed owners (their
    received bins: FP_EMPTY fill cells, homes local to the owner's slice,
    negative below it) on the whole proteome; B1 on each of the ``xla``
    lookup's four table shards (homes local to the shard) for the
    proteome's first dispatch. Every call's answer equal to its twin's
    (int32 slots; B1 off and state). Returns (the fused kernel's
    max_abs_err, B1's, {label: the fused kernel's (ms a launch, twin_ms,
    bound)})."""
    import numpy as np
    import torch

    from kmergutsjava_tpu_torch.config import EngineConfig
    from kmergutsjava_tpu_torch.constants import K
    from kmergutsjava_tpu_torch.formats.kmer_table import \
        resolve_table_files
    from kmergutsjava_tpu_torch.lookup import tilejoin
    from kmergutsjava_tpu_torch.lookup.sparse import FP_MOD
    from kmergutsjava_tpu_torch.models.pipeline import _cached_read_table
    from kmergutsjava_tpu_torch.models.spmd import SpmdProgram
    from kmergutsjava_tpu_torch.ops import kmer_windows as kw
    from kmergutsjava_tpu_torch.parallel import (fused_probe, routed_lookup,
                                                 tilejoin_shards)
    from kmergutsjava_tpu_torch.parallel.mesh import make_mesh

    table = _cached_read_table(resolve_table_files(big)[0])
    devs = [torch.device(d) for d in four]

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    fused_err, shard_res = 0, {}
    for label, (aa, mat, counts, extra) in batches.items():
        if extra is not None:  # the genome's windows: not a phase 13 input
            continue
        prog = SpmdProgram(table, EngineConfig(
            aa=aa, device="cuda", mesh_shape=(2, 2), mesh_devices=four))
        calls = []
        with spied(fused_probe, "shard_first_match", calls):
            prog.step(prog.planes["fp"], mat,
                      counts + K if aa else counts).read()
        sync()
        errs, owned, invalid, cands, n, bnds = [], 0, 0, 0, 0, []
        for args, _, got in calls:
            plane, a, c, _, num_sigs, lo, s_loc, w = args[:8]
            twin = fused_probe.shard_first_match_reference(*args)
            sync()
            errs.append(int((got.long() - twin.long()).abs().max()))
            homes, fps = kw.windows_reference(a, c, aa, num_sigs)
            homes = homes.reshape(-1)
            local = homes.long() - lo
            mine = (homes >= 0) & (local >= 0) & (local < s_loc)
            owned += int(mine.sum())
            invalid += int((homes < 0).sum())
            cands += int((got > 0).sum())
            n += homes.numel()
            reads = torch.where(got[mine] > 0,
                                got[mine].long() - lo - local[mine], w)
            bnds.append(bound_fused_step(
                a.numel() + 4 * c.numel(), homes.numel(), 4, local[mine],
                reads, s_loc + w))
        fused_err = max([fused_err] + errs)
        # the device time of one position's launch, in the step's order
        # (each position's on its own card)
        mine_calls = [c for c in calls if c[0][0].device == devs[0]]
        by_launch, _ = kernel_device_ms(
            lambda: [fused_probe.shard_first_match(*a)
                     for a, _, _ in mine_calls],
            devs[0], "fused_probe_kernel", key=f"fused shard {label}")
        k_ms = sum(by_launch) / len(mine_calls)
        t_ms = timed(lambda: [fused_probe.shard_first_match_reference(*a)
                              for a, _, _ in mine_calls],
                     devs[0]) / len(mine_calls)
        bnd = (sum(b[0] for b in bnds) / len(bnds), bnds[0][1])
        print(f"phase 13: fused kernel shard form in the (2, 2) spmd step on "
              f"{label}: launches={len(calls)} windows={n} owned={owned} "
              f"invalid={invalid} candidates={cands} pw={prog.pw} "
              f"max_abs_err={max(errs)} (twin) "
              f"device_ms_per_launch={k_ms:.5f} by_launch="
              f"{[round(x, 5) for x in by_launch]} twin_ms_per_launch="
              f"{t_ms:.4f} {bound_fields(k_ms, bnd)}", flush=True)
        shard_res[label] = (k_ms, t_ms, bnd)
        del prog, calls, mine_calls

    values = query_values(faa)
    b1_err = 0
    rl = routed_lookup.RoutedLookup(table, make_mesh(1, 4, devs),
                                    probe_window=max(16, table.max_probe))
    tj = tilejoin_shards.TileJoinShardedLookup(table, make_mesh(1, 4, devs))
    first = values[:tj.chunk]
    for label, run in (
            ("the routed owners' received bins (whole proteome)",
             lambda: rl.probe(values)),
            ("the xla lookup's table shards (first dispatch)",
             lambda: tj.resolve_probe(tj.dispatch_probe(
                 (first % FP_MOD).astype(np.uint16),
                 (first % table.num_sigs).astype(np.int32))))):
        calls = []
        with spied(tilejoin, "probe_answer", calls):
            run()
        sync()
        errs, fills, below, n = [], 0, 0, 0
        for (plane, q, h, w), _, answer in calls:
            off_k, st_k = tilejoin.answer_views(answer, q.numel())
            off_t, st_t = tilejoin.first_event_reference(plane, q, h, w)
            errs.append(max(int((off_k.int() - off_t.int()).abs().max()),
                            int((st_k.int() - st_t.int()).abs().max())))
            fills += int((q.view(torch.int16) == -1).sum())
            below += int((h < 0).sum())
            n += q.numel()
        b1_err = max([b1_err] + errs)
        print(f"phase 13: B1 on {label}: launches={len(calls)} queries={n} "
              f"fp_empty={fills} negative_homes={below} "
              f"max_abs_err={max(errs)}", flush=True)
        del calls
    del rl, tj
    return fused_err, b1_err, shard_res


def sorted_chunks_phase(dev, work, big, faa, table):
    """Phase 4, the chunk home sort: the proteome through the CLI with
    ``--sort-chunks 1`` and with ``--sort-chunks 1 --device-sort``, each
    report equal to the unsorted cuda run's, B1 its only kernel; then B1's
    device time a dispatch at the engine's launches with each chunk in
    home order, between two runs in the engine's order (check_chunks, each
    against the twin). Returns (the sorted order's device ms a full
    dispatch, the engine order's)."""
    import numpy as np
    import torch

    from kmergutsjava_tpu_torch.lookup.sparse import SparseLookup

    with open(os.path.join(work, "big_cuda.txt"), "rb") as fh:
        want = fh.read()
    for flags in (("--sort-chunks", "1"),
                  ("--sort-chunks", "1", "--device-sort")):
        out = os.path.join(work, "big_sorted.txt")
        reset_counts()
        info, secs = run_cli(big, faa, out, "cuda", flags)
        counts = read_counts()
        with open(out, "rb") as fh:
            got = fh.read()
        print(f"phase 4: {' '.join(flags)} wall_s={secs:.3f} "
              f"identical={got == want} launches={counts['tilejoin']} "
              f"{phase_ms(info)}", flush=True)
        if got != want:
            raise RuntimeError(f"phase 4: {' '.join(flags)} changed the "
                               "report")
        check_launches(f"phase 4 {' '.join(flags)}", counts, ("tilejoin",))
    values = query_values(faa)
    lk = SparseLookup(table, device=str(dev))
    res = {}
    for order in ("engine", "home", "engine"):
        chunks = engine_chunks(lk, values)
        if order == "home":
            chunks = [(q[o], h[o]) for q, h in chunks
                      for o in [np.argsort(h, kind="stable")]]
        on_card = [(torch.from_numpy(q).to(dev), torch.from_numpy(h).to(dev))
                   for q, h in chunks]
        err, k_ms, *_ = check_chunks(
            dev, f"phase 4: engine dispatches in {order} order", lk.fp,
            lk.w1, on_card, lambda: engine_launches(lk, chunks), lk.chunk)
        if err != 0:
            raise RuntimeError(f"phase 4: B1 and its twin disagree in "
                               f"{order} order")
        res.setdefault(order, []).append(k_ms)
    print(f"phase 4: B1 device_ms a full dispatch home_order="
          f"{res['home'][0]:.5f} engine_order={res['engine']}", flush=True)
    return res["home"][0], res["engine"]


def bound_scan(n_hits, n_cont, steps, emits):
    """B11: each hit's five columns in (20 B) and the container offsets
    (8 B each), each step's flag byte and each emitting step's record
    (28 B) out; one operation a step (its steps are a dependent chain, so
    the longest container may set the time instead)."""
    return bound(20 * n_hits + 8 * (n_cont + 1) + steps + 28 * emits, steps)


def scan_phase(dev, work, corpus, faa, fna, big, reads):
    """Phase 14: ``--grouping scan`` on the card. The CLI on the goldens
    (the corpus table) and on phase 4's proteome and phase 7's read set
    (phase 4's table): each report equal to its golden or to phase 4's or
    7's, one launch of the grouping kernel B11 a run, beside the lookup's.
    Then B11 against its twin on the engine's own container batches of the
    proteome and read-set runs (taken by a spy on the wrapper; flags at
    every step, records at emitting steps), with its device time
    (kernel_device_ms, the L2 flushed), the twin's (CUDA events), the
    bound and the longest container's steps. The kernel is timed in the
    wrapper's length order, computed once (the order's own device time,
    a ``torch.argsort`` of the lengths, is printed apart). Returns (B11's launches in the proteome run,
    {label: (max_abs_err, kernel_ms, twin_ms, bound, longest container's
    steps, order_ms)})."""
    import torch

    from kmergutsjava_tpu_torch.calls import scan_machine as sm

    def read(path, gz=False):
        with (gzip.open if gz else open)(path, "rb") as fh:
            return fh.read()

    golden = os.path.join(HERE, "tests", "data")
    runs = (("golden_aa_full", corpus, faa, True,
             read(os.path.join(golden, "golden_aa_full.txt.gz"), True)),
            ("golden_dna_full", corpus, fna, False,
             read(os.path.join(golden, "golden_dna_full.txt.gz"), True)),
            ("sparse proteome", big, faa, True,
             read(os.path.join(work, "big_cuda.txt"))),
            ("dense read set", big, reads, False,
             read(os.path.join(work, "reads_auto.txt"))))
    batches, launches = {}, None
    for label, d, query, aa, want in runs:
        out = os.path.join(work, "scan.txt")
        calls = []
        reset_counts()
        with spied(sm, "scan_containers", calls):
            info, secs = run_cli(d, query, out, "cuda",
                                 ("--grouping", "scan"), aa=aa)
        counts = read_counts()
        got = read(out)
        print(f"phase 14: {label} --grouping scan wall_s={secs:.3f} "
              f"identical={got == want} launches={counts} {phase_ms(info)}",
              flush=True)
        if got != want:
            raise RuntimeError(f"phase 14: {label} with --grouping scan "
                               "differs from its reference")
        # one launch for the run's batch; a batch with no container (all
        # past 4,096 hits: the genome's six) takes the host machine only
        n_cont = sum(c[0][1].numel() - 1 for c in calls)
        print(f"phase 14: {label} batch containers={n_cont} (the rest, "
              "past 4,096 hits, on the host machine)", flush=True)
        check_launches(f"phase 14 {label}", counts,
                       ("scan_machine",) if n_cont else (),
                       ("tilejoin", *STREAM_KERNELS))
        if counts["scan_machine"] != (1 if n_cont else 0):
            raise RuntimeError(f"phase 14: {label} launched B11 "
                               f"{counts['scan_machine']} times for "
                               f"{n_cont} containers")
        if label == "sparse proteome":
            launches = counts["scan_machine"]
        if label in ("sparse proteome", "dense read set"):
            batches[label] = calls[0]
    res = {}
    for label, ((hits, offsets), kw, (flags, recs)) in batches.items():
        t_flags, t_recs = sm.scan_containers_reference(hits, offsets, **kw)
        emit = (t_flags & 2) != 0
        err = max(int((flags.int() - t_flags.int()).abs().max()),
                  int((recs[emit].long() - t_recs[emit].long()).abs().max())
                  if bool(emit.any()) else 0)
        order = sm.length_order(offsets)
        order_ms, _ = library_device_ms(lambda: sm.length_order(offsets),
                                        dev, key="length_order")
        ms, kept = kernel_device_ms(
            lambda: sm.scan_containers(hits, offsets, order=order, **kw),
            dev, "scan_machine_kernel")
        t_ms = timed(lambda: sm.scan_containers_reference(hits, offsets,
                                                          **kw), dev, reps=1)
        lens = offsets[1:] - offsets[:-1]
        n, c = hits.shape[0], lens.numel()
        n_emit = int(emit.sum())
        longest_steps = int(lens.max()) + 1
        bnd = bound_scan(n, c, n + c, n_emit)
        print(f"phase 14: B11 on the {label} run's batch containers={c} "
              f"hits={n} steps={n + c} emits={n_emit} longest_container="
              f"{int(lens.max())} longest_steps={longest_steps} "
              f"mean_container={n / max(c, 1):.1f} {kw} max_abs_err={err} "
              f"device_ms={ms[0]:.5f} ns_per_longest_step="
              f"{ms[0] * 1e6 / longest_steps:.1f} runs_kept={kept}/5 "
              f"order_ms={order_ms:.5f} (length_order's kernels) "
              f"twin_ms={t_ms:.4f} {bound_fields(ms[0], bnd)}", flush=True)
        res[label] = (err, ms[0], t_ms, bnd, longest_steps, order_ms)
        del t_flags, t_recs
    del batches
    torch.cuda.synchronize(dev)
    return launches, res


def multiprocess_phase(work, big, faa):
    """Phase 15: two processes of the port on the card under gloo, each
    holding two mesh positions of the one card (``mp_worker``). Each rank's
    sharded (2, 2), routed 4 and stream-shard 4 hits of the proteome's
    queries against phase 4's table equal a single-process lookup's; each
    rank's engine report over its ``shard_records`` share, merged by
    ``merge_report_shards``, equals phase 4's report. The ranks are
    started together, waited for with a timeout and killed by their
    handles. Prints each rank's lines (walls and launches)."""
    import socket

    from kmergutsjava_tpu_torch.parallel.multihost import merge_report_shards

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{sock.getsockname()[1]}"
    write_mp_dna(work)
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mp-worker", addr, "2",
         str(rank), work, big, faa], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=HERE) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith("phase 15"):
                print(line, flush=True)
        if p.returncode != 0:
            raise RuntimeError(f"phase 15: rank {rank} exited "
                               f"{p.returncode}:\n{out[-3000:]}")
    shards = []
    for rank in range(2):
        with open(os.path.join(work, f"mp_report_{rank}.txt")) as fh:
            shards.append(fh.read())
    with open(os.path.join(work, "big_cuda.txt")) as fh:
        want = fh.read()
    merged = merge_report_shards(shards)
    print(f"phase 15: merged report of 2 ranks bytes={len(merged)} "
          f"identical_to_phase_4={merged == want} wall_s="
          f"{time.time() - t0:.3f}", flush=True)
    if merged != want:
        raise RuntimeError("phase 15: the merged report differs from phase "
                           "4's")


MP_READS = 20_000      # phase 7's first reads in phase 15's DNA query
MP_CONTIG = 150_000    # and the genome's first bases as one long contig


def write_mp_dna(work):
    """Phase 15's DNA query for the fused step: phase 7's first MP_READS
    reads and the genome's first MP_CONTIG bases as one contig, which is
    past LONG_NT and goes through the windowed step. Returns its path."""
    path = os.path.join(work, "mp_dna.fna")
    with open(os.path.join(work, "reads.fna")) as fh:
        lines = fh.read().splitlines()[:2 * MP_READS]
    with open(os.path.join(work, "genome.fna")) as fh:
        genome = "".join(line.strip() for line in fh
                         if not line.startswith(">"))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + f"\n>contig\n{genome[:MP_CONTIG]}\n")
    return path


def report_from_hits(data_dir, prep, hits, aa):
    """The report the engine makes from a lookup's ``prep`` and ``hits``
    (its grouping, the default parameters)."""
    from kmergutsjava_tpu_torch.calls.grouping import (
        GroupingParams, Report, process_aa_seq, process_dna_seq)
    from kmergutsjava_tpu_torch.config import EngineConfig
    from kmergutsjava_tpu_torch.formats.function_index import \
        load_function_index
    from kmergutsjava_tpu_torch.formats.kmer_table import resolve_table_files
    from kmergutsjava_tpu_torch.models.pipeline import Engine

    cfg = EngineConfig(aa=aa, device="cuda")
    functions = load_function_index(resolve_table_files(data_dir)[1])
    params = GroupingParams(min_hits=cfg.min_hits,
                            min_weighted_hits=cfg.min_weighted_hits,
                            max_gap=cfg.max_gap,
                            order_constraint=cfg.order_constraint)
    by_container = Engine(cfg)._bucket_hits(prep, hits, functions, params)
    out = io.StringIO()
    report = Report(out)
    for qid, length in prep.id_len.items():
        (process_aa_seq if aa else process_dna_seq)(
            qid, length, by_container, functions, report, params)
    report.flush()
    return out.getvalue()


def mp_spmd(rank, world, big, table, query, aa, devs, want_report=None):
    """Phase 15's fused step at one rank: the whole ``query`` through a
    (2, 2) mesh spanning the ranks (every rank consumes every record and
    decodes every answer), against a single-process (2, 2) mesh of this
    rank's card; the hits must be equal, the fused kernel's shard entry
    must launch (and nothing else), and the report made from the hits must
    equal ``want_report`` where one is given."""
    import numpy as np

    from kmergutsjava_tpu_torch.config import EngineConfig
    from kmergutsjava_tpu_torch.formats.fasta import read_fasta
    from kmergutsjava_tpu_torch.models import spmd
    from kmergutsjava_tpu_torch.parallel import fused_probe
    from kmergutsjava_tpu_torch.parallel.mesh import make_mesh

    mode = "aa" if aa else "dna"
    cfg = EngineConfig(aa=aa, backend="spmd", device="cuda")
    records = list(read_fasta(query))
    shard_calls = []
    real = fused_probe.shard_first_match

    def counted(*args, **kwargs):
        shard_calls.append(1)
        return real(*args, **kwargs)

    def run(program):
        ann = spmd.SpmdAnnotator(table, cfg, program=program)
        prep = ann.consume(records)
        return prep, ann.finish()

    reset_counts()
    t = time.time()
    prog = spmd.SpmdProgram(table, cfg, mesh=make_mesh(2, 2, devs,
                                                       distributed=True))
    built = time.time() - t
    t = time.time()
    fused_probe.shard_first_match = counted
    try:
        prep, hits = run(prog)
    finally:
        fused_probe.shard_first_match = real
    wall = time.time() - t
    counts = read_counts()
    t = time.time()
    _, want = run(spmd.SpmdProgram(table, EngineConfig(
        aa=aa, backend="spmd", device="cuda", mesh_shape=(2, 2),
        mesh_devices=[devs[0]] * 4)))
    single = time.time() - t
    same = all(np.array_equal(getattr(hits, c), getattr(want, c))
               for c in ("cnt_id", "pos", "otu", "avg_from_end", "fi", "wt"))
    report = ("" if want_report is None else
              f" report_identical_to_phase_4="
              f"{report_from_hits(big, prep, hits, aa) == want_report}")
    print(f"phase 15: rank {rank} spmd {mode} (2, 2) over {world} processes "
          f"positions={len(prog.mesh.positions())} records={len(records)} "
          f"build_s={built:.3f} lookup_s={wall:.3f} single_process_s="
          f"{single:.3f} hits={len(hits)} identical={same}{report} "
          f"launches={ {'fused_probe': counts['fused_probe']} } "
          f"shard_entry_calls={len(shard_calls)}", flush=True)
    if not same:
        raise RuntimeError(f"rank {rank}: spmd {mode} hits differ from the "
                           "single-process step's")
    if want_report is not None and "report_identical_to_phase_4=False" \
            in report:
        raise RuntimeError(f"rank {rank}: spmd {mode} report differs from "
                           "phase 4's")
    check_launches(f"phase 15 rank {rank} spmd {mode}", counts,
                   ("fused_probe",))
    if counts["fused_probe"] != len(shard_calls):
        raise RuntimeError(f"rank {rank}: spmd {mode} launched the fused "
                           f"kernel {counts['fused_probe']} times in "
                           f"{len(shard_calls)} calls of its shard entry")


def mp_worker(addr, world, rank, work, big, faa) -> int:
    """One rank of phase 15 (``chip_smoke.py --mp-worker ADDR WORLD RANK
    WORK BIG FAA``): gloo over ``world`` processes, ``4 // world`` mesh
    positions on card 0."""
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    import torch.distributed as dist

    from kmergutsjava_tpu_torch.config import EngineConfig
    from kmergutsjava_tpu_torch.formats.fasta import read_fasta
    from kmergutsjava_tpu_torch.formats.kmer_table import resolve_table_files
    from kmergutsjava_tpu_torch.lookup.sparse import SparseLookup
    from kmergutsjava_tpu_torch.models.pipeline import (Engine,
                                                        _cached_read_table)
    from kmergutsjava_tpu_torch.parallel import (routed_lookup,
                                                 sharded_lookup,
                                                 stream_shards,
                                                 tilejoin_shards)
    from kmergutsjava_tpu_torch.parallel.mesh import make_mesh
    from kmergutsjava_tpu_torch.parallel.multihost import (
        initialize_distributed, shard_records)

    world, rank = int(world), int(rank)
    torch.cuda.set_device(0)
    t0 = time.time()
    initialize_distributed(addr, world, rank, backend="gloo", timeout_s=600)
    devs = ["cuda:0"] * (4 // world)
    table = _cached_read_table(resolve_table_files(big)[0])
    values = query_values(faa)
    n = len(values)
    cnt = np.zeros(n, np.int64)
    pos = np.arange(n, dtype=np.int64)
    print(f"phase 15: rank {rank} of {world} (gloo) up with the table and "
          f"{n} queries in {time.time() - t0:.3f} s", flush=True)

    def canon(hits):
        o = np.argsort(hits.pos, kind="stable")
        return [np.asarray(x)[o] for x in (hits.pos, hits.otu,
                                            hits.avg_from_end, hits.fi,
                                            hits.wt)]

    t = time.time()
    want = canon(SparseLookup(table, device="cuda").lookup(
        values, cnt, pos, compute_kmers_found=False))
    print(f"phase 15: rank {rank} single-process xla lookup wall_s="
          f"{time.time() - t:.3f} hits={len(want[0])}", flush=True)
    names = {"tilejoin": "B1", "stream": "B2", "shard_probe": "B12",
             "route_bins": "B13"}
    # the kernels each step must launch at this rank's positions
    must = {"sharded (2, 2)": ("shard_probe",),
            "routed 4": ("route_bins", "route_unbin", "tilejoin"),
            "stream-shards 4": ("stream",),
            "tilejoin-shards (1, 4)": ("tilejoin",)}
    for label, build in (
            ("sharded (2, 2)", lambda: sharded_lookup.ShardedLookup(
                table, make_mesh(2, 2, devs, distributed=True),
                max(8, table.max_probe))),
            ("routed 4", lambda: routed_lookup.RoutedLookup(
                table, make_mesh(1, 4, devs, distributed=True),
                probe_window=max(16, table.max_probe))),
            ("stream-shards 4", lambda: stream_shards.StreamShardedLookup(
                table, stream_shards.make_stream_mesh(4, devs,
                                                      distributed=True))),
            ("tilejoin-shards (1, 4)",
             lambda: tilejoin_shards.TileJoinShardedLookup(
                 table, make_mesh(1, 4, devs, distributed=True)))):
        reset_counts()
        t = time.time()
        lk = build()
        built = time.time() - t
        t = time.time()
        with routed_trips() as trips:
            got = canon(lk.lookup(values, cnt, pos))
        wall = time.time() - t
        counts = read_counts()
        same = all(np.array_equal(a, b) for a, b in zip(got, want))
        print(f"phase 15: rank {rank} {label} positions="
              f"{len(lk.mesh.positions())} build_s={built:.3f} lookup_s="
              f"{wall:.3f} hits={len(got[0])} identical={same} launches="
              f"{ {names[k]: counts[k] for k in names} }"
              + (f" routed_trips={trips}" if trips["probes"] else ""),
              flush=True)
        if not same:
            raise RuntimeError(f"rank {rank}: {label} hits differ from the "
                               "single-process lookup's")
        check_launches(f"phase 15 rank {rank} {label}", counts, must[label])
        if trips["probes"]:
            check_trips(f"phase 15 rank {rank} {label}", trips)
        del lk
    with open(os.path.join(work, "big_cuda.txt")) as fh:
        want_aa = fh.read()
    mp_spmd(rank, world, big, table, faa, True, devs, want_aa)
    mp_spmd(rank, world, big, table, os.path.join(work, "mp_dna.fna"),
            False, devs)
    mine = list(shard_records(read_fasta(faa), rank, world))
    text = "".join(f">{r.id} {r.descr}\n{r.seq}\n" for r in mine)
    reset_counts()
    t = time.time()
    out = io.StringIO()
    Engine(EngineConfig(aa=True, device="cuda")).run(
        big, None, out, stdout=True, query_stream=io.StringIO(text))
    counts = read_counts()
    with open(os.path.join(work, f"mp_report_{rank}.txt"), "w") as fh:
        fh.write(out.getvalue())
    print(f"phase 15: rank {rank} engine on its share proteins={len(mine)} "
          f"wall_s={time.time() - t:.3f} launches="
          f"{ {names[k]: counts[k] for k in names} }", flush=True)
    check_launches(f"phase 15 rank {rank} engine", counts, ("tilejoin",))
    dist.barrier()
    dist.destroy_process_group()
    print(f"phase 15: rank {rank} done wall_s={time.time() - t0:.3f}",
          flush=True)
    return 0


# phase 16's rounds, chosen from the generator's keywords so that between
# them they hold aa (11, 15, 22, 26, 28, 30, 37) and DNA (10, 12, 18, 20,
# 24), a gzipped table (10, 30), a spill (-l: 12, 15, 18, 24, 26, 37),
# duplicate ids (11, 18, 26, 28, 37), debug (20, 24, 28), load 0.95 (18,
# 22, 28, 37) and --grouping scan on more than one container (every round
# without debug)
SOAK_SEEDS = (10, 11, 12, 15, 18, 20, 22, 24, 26, 28, 30, 37)
# the kernel counters that phase 16's runs must each move: (module, count)
SOAK_COUNTERS = (("tilejoin", "launches"), ("stream", "launches"),
                 ("blockprobe", "launches"), ("fused_probe", "launches"),
                 ("kmer_windows", "ragged_launches"),
                 ("shard_probe", "launches"), ("route_bins", "launches"),
                 ("route_bins", "unbin_launches"),
                 ("scan_machine", "launches"),
                 ("stream_tiles", "scatter_launches"),
                 ("stream_tiles", "resolve_launches"))


def first_difference(want, got):
    """The first line where two reports differ, as text."""
    a, b = want.splitlines(), got.splitlines()
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"line {i + 1}: want {x!r}, got {y!r}"
    return f"line {min(len(a), len(b)) + 1}: {len(a)} lines against {len(b)}"


def soak_phase(work):
    """Phase 16: every port run of each SOAK_SEEDS round on the card
    against the port's parity run on the CPU; the counts of SOAK_COUNTERS
    over the phase must all be above 0."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_soak_rounds as rounds

    mods = kernel_modules()
    threads = os.environ.get("KMER_NATIVE_THREADS")
    reset_counts()
    t0 = time.time()
    n_runs = 0
    try:  # the runs' info lines (without -o, on stdout) are dropped
        with contextlib.redirect_stdout(io.StringIO()):
            for seed in SOAK_SEEDS:
                tmp = os.path.join(work, f"soak_{seed}")
                os.makedirs(tmp)
                rng, d, fasta, kw = rounds.make_round(seed, tmp)
                base = rounds.parity_report(d, fasta, kw)
                for label, got in rounds.port_reports(
                        seed, tmp, rng, d, fasta, kw, "cuda",
                        os.environ.__setitem__):
                    n_runs += 1
                    if got != base:
                        raise RuntimeError(
                            f"phase 16: seed {seed}: {label} differs from "
                            f"the port's parity run on the CPU at "
                            f"{first_difference(base, got)}")
    finally:
        if threads is None:
            os.environ.pop("KMER_NATIVE_THREADS", None)
        else:
            os.environ["KMER_NATIVE_THREADS"] = threads
    wall = time.time() - t0
    totals = {f"{m}.{c}": getattr(mods[m], c) for m, c in SOAK_COUNTERS}
    print(f"phase 16: soak seeds {list(SOAK_SEEDS)}: {n_runs} runs on cuda, "
          f"each byte-equal to the port's parity run on the CPU; "
          f"wall_s={wall:.3f}", flush=True)
    print(f"phase 16: kernel launch totals {json.dumps(totals)}", flush=True)
    zero = [k for k, n in totals.items() if n == 0]
    if zero:
        raise RuntimeError(f"phase 16: the rounds never launched {zero}")


def _u(x):
    """A tensor's values as int64 (u16 storage widened)."""
    import torch

    from kmergutsjava_tpu_torch.lookup.tilejoin import _widen

    return _widen(x).long() if x.dtype == torch.uint16 else x.long()


def kernel_bound(ms, bnd, by):
    """A kernel entry's timing (``by``: "trace", "events" for CUDA events
    around reps launched back to back, or timed_by's "events_per_run"),
    bound, share (none for events_per_run: launch gaps and host syncs are
    in its times) and library call (none: no single PyTorch call computes
    a first-event window probe, an 8-mer's value, home or fingerprint from
    ASCII rows, a shard's first-match probe or the call-grouping state
    machine; B13's entry sets its own)."""
    return {"timed_by": by, "bound_ms": bnd[0], "bound_by": bnd[1],
            "share": None if by == "events_per_run" else bnd[0] / ms,
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

    from kmergutsjava_tpu_torch.utils import native
    host = native.status()
    print(f"host libraries: {json.dumps(host)}", flush=True)
    own = os.path.join(HERE, "kmergutsjava_tpu_torch", "native")
    not_own = [name for name, st in host.items()
               if not st["loaded"] or os.path.dirname(st["source"]) != own]
    if not_own:
        return fail(f"host libraries {not_own} not loaded from {own}")

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
        b1_home_ms, _ = sorted_chunks_phase(dev, work, big, faa, table)
        s_cmp = stream_vs_twin(dev)
        for label, (e, *_) in s_cmp.items():
            if e != 0:
                return fail(f"stream kernel and twin disagree at {label}")
        genome = write_genome(os.path.join(work, "genome.fna"))
        st_launches = golden_dna_run(work, corpus,
                                     os.path.join(work, "genome.fna"))
        ((s_err, s_ms, s_plain_ms, s_bnd), bp_launches, values, sc_row,
         rs_row) = dense_run(dev, work, big, table, genome)
        if s_err != 0:
            return fail("stream kernel and twin disagree on a pass's real "
                        "tiles")
        if sc_row[0] != 0:
            return fail("the stream scatter kernel's split of the read set's "
                        "passes is not valid")
        if rs_row[0] != 0:
            return fail("the stream resolve kernel and its twin disagree on "
                        "the read set's passes")
        bp_err, bp_ms, bp_plain_ms, bp_bnd = block_probe_vs_twin(
            dev, table, values)
        if bp_err != 0:
            return fail("block probe and twin disagree on the read set")
        # the fused step's plane of the sparse table, for phase 12's B1 check
        from kmergutsjava_tpu_torch.parallel.annotate_step import table_plane
        spmd_pw = max(8, table.max_probe)
        spmd_plane = table_plane(table, spmd_pw, dev)
        del values, table
        r_err, r_ms, r_plain_ms, r_launches, r_bnd = stream_reps_phase(dev)
        if r_err != 0:
            return fail("the stream kernel's repetition launch and twin "
                        "disagree")
        g_err, g_ms, g_plain_ms, g_launches, g_bnd = tjgather_phase(dev)
        if g_err != 0:
            return fail("lane-gather kernel and twin disagree")
        service_phase(work, big, faa, prots, w1, tj_launches)
        ((fused_launches, kr_launches), (fused_cmp, kw_b1_err),
         kr_cmp) = spmd_phase(dev, work, corpus, faa,
                       os.path.join(work, "genome.fna"), big,
                       os.path.join(work, "reads.fna"), prots, spmd_plane,
                       spmd_pw)
        del spmd_plane
        if kw_b1_err != 0:
            return fail("B1 and its twin disagree on the window twin's "
                        "windows")
        for label, (e, *_) in fused_cmp.items():
            if e != 0:
                return fail(f"the fused kernel disagrees with its twin on "
                            f"{label}")
        for cell, (e, *_) in kr_cmp.items():
            if e != 0:
                return fail(f"the window kernel's ragged entry and its twin "
                            f"disagree on the {cell}'s prepare")
        # the window kernel's line: its ragged entry (--prepare jax, the
        # path that launches it) over the sparse proteome's prepare
        kr_row, kr_reads = kr_cmp["sparse proteome"], kr_cmp["dense read set"]
        f_row = next(iter(fused_cmp.values()))
        t13 = time.time()
        b12_launches, (b13_launches, unbin_launches), spmd_mesh_launches = \
            mesh_runs(work, big, faa, os.path.join(work, "reads.fna"),
                      tj_launches, fused_launches)
        mesh_cmp = mesh_kernels_vs_twins(dev, big, faa)
        mesh_fused_err, mesh_b1_err, shard_cmp = mesh_inputs_vs_twins(
            big, faa, window_batches(prots, os.path.join(work, "genome.fna"),
                                     os.path.join(work, "reads.fna")),
            mesh_devices_of_card())
        print(f"phase 13: wall_s={time.time() - t13:.3f}", flush=True)
        for name, (e, *_) in mesh_cmp.items():
            if e != 0:
                return fail(f"{name} and its twin disagree")
        if mesh_fused_err != 0:
            return fail("the fused kernel's shard form disagrees with its "
                        "twin in the spmd mesh step")
        if mesh_b1_err != 0:
            return fail("B1 and its twin disagree on the routed owners' bins "
                        "or the xla lookup's table shards")
        t14 = time.time()
        scan_launches, scan_cmp = scan_phase(
            dev, work, corpus, faa, os.path.join(work, "genome.fna"), big,
            os.path.join(work, "reads.fna"))
        print(f"phase 14: wall_s={time.time() - t14:.3f}", flush=True)
        for label, (e, *_) in scan_cmp.items():
            if e != 0:
                return fail(f"the grouping kernel and its twin disagree on "
                            f"the {label} run's batch")
        clear_engine_caches()
        multiprocess_phase(work, big, faa)
        clear_engine_caches()
        soak_phase(work)

    print(json.dumps({"kernels": [{
        "name": "tilejoin_first_event",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/tilejoin.cu",
        "replaces": "kmergutsjava_tpu/lookup/pallas_tilejoin.py:145",
        "launches": tj_launches,
        "max_abs_err": max([err, kw_b1_err, mesh_b1_err]
                           + [r[0] for r in cmp.values()]),
        "ms": k_ms,
        "home_order_ms": b1_home_ms,
        "call_ms": call_ms,
        "plain_ms": t_ms,
        **kernel_bound(k_ms, tj_bnd, timed_by("first_event")),
    }, {
        "name": "stream_probe",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/stream_probe.cu",
        "replaces": "kmergutsjava_tpu/lookup/pallas_stream.py:81",
        "launches": st_launches,
        "max_abs_err": max([s_err] + [r[0] for r in s_cmp.values()]),
        "ms": s_ms,
        "plain_ms": s_plain_ms,
        **kernel_bound(s_ms, s_bnd, "events"),
    }, *({
        "name": name,
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/stream_tiles.cu",
        "replaces": replaces,
        "launches": row[4],
        "max_abs_err": row[0],
        "ms": row[1],
        "plain_ms": row[2],
        **kernel_bound(row[1], row[3], "events"),
    } for name, row, replaces in (
        ("stream_scatter", sc_row,
         "kmergutsjava_tpu/native/scatter.cpp:389 (host, per chunk)"),
        ("stream_resolve", rs_row,
         "kmergutsjava_tpu/native/scatter.cpp:137, :174 (host, per "
         "chunk)"))), {
        "name": "block_probe",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/block_probe.cu",
        "replaces": "kmergutsjava_tpu/lookup/pallas_kernel.py:56",
        "launches": bp_launches,
        "max_abs_err": bp_err,
        "ms": bp_ms,
        "plain_ms": bp_plain_ms,
        **kernel_bound(bp_ms, bp_bnd, "events"),
    }, {
        "name": "stream_probe_reps",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/stream_probe.cu",
        "replaces": "scripts/microbench_probe.py:180",
        "launches": r_launches,
        "max_abs_err": r_err,
        "ms": r_ms,
        "plain_ms": r_plain_ms,
        **kernel_bound(r_ms, r_bnd, "events"),
    }, {
        "name": "tjgather_probe",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/tjgather.cu",
        "replaces": "scripts/sweep.py:179",
        "launches": g_launches,
        "max_abs_err": g_err,
        "ms": g_ms,
        "plain_ms": g_plain_ms,
        **kernel_bound(g_ms, g_bnd, "events"),
    }, {
        "name": "kmer_windows",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/kmer_windows.cu",
        "replaces": "kmergutsjava_tpu/models/prepare.py:100 (:121), "
                    ":285 (:302); kmergutsjava_tpu/ops/kmerize.py:29",
        "launches": kr_launches["sparse proteome"],
        "max_abs_err": max(r[0] for r in kr_cmp.values()),
        "ms": kr_row[1],
        "plain_ms": kr_row[2],
        "by_kernel_ms": kr_row[5],
        "read_set_launches": kr_launches["dense read set"],
        "read_set_ms": kr_reads[1],
        "read_set_bound_ms": kr_reads[3][0],
        **kernel_bound(kr_row[1], kr_row[3], timed_by("ragged_")),
    }, {
        "name": "fused_probe",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/fused_probe.cu",
        "replaces": "kmergutsjava_tpu/parallel/annotate_step.py:52, :96 "
                    "(with kmergutsjava_tpu/parallel/sharded_lookup.py:129); "
                    "kmergutsjava_tpu/parallel/seq_windows.py:98",
        "launches": fused_launches,
        "mesh_launches": spmd_mesh_launches,
        "max_abs_err": max([mesh_fused_err]
                           + [r[0] for r in fused_cmp.values()]),
        "ms": f_row[1],
        "plain_ms": f_row[2],
        "shard_ms": next(iter(shard_cmp.values()))[0],
        **kernel_bound(f_row[1], f_row[3], timed_by(
            f"fused {next(iter(fused_cmp))}",
            f"fused shard {next(iter(shard_cmp))}")),
    }, {
        "name": "shard_probe",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/shard_probe.cu",
        "replaces": "kmergutsjava_tpu/parallel/sharded_lookup.py:129",
        "launches": b12_launches,
        "max_abs_err": mesh_cmp["shard_probe"][0],
        "ms": mesh_cmp["shard_probe"][1],
        "plain_ms": mesh_cmp["shard_probe"][2],
        **kernel_bound(mesh_cmp["shard_probe"][1],
                       mesh_cmp["shard_probe"][3],
                       timed_by("B12 shard 0")),
    }, {
        "name": "route_bins",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/route_bins.cu",
        "replaces": "kmergutsjava_tpu/parallel/routed_lookup.py:43 "
                    "(:57-81, :119-133)",
        "launches": b13_launches,
        "unbin_launches": unbin_launches,
        "max_abs_err": max(mesh_cmp["route_bins"][0],
                           mesh_cmp["route_unbin"][0]),
        "ms": mesh_cmp["route_bins"][1],
        "unbin_ms": mesh_cmp["route_unbin"][1],
        "plain_ms": mesh_cmp["route_bins"][2],
        "unbin_plain_ms": mesh_cmp["route_unbin"][2],
        **kernel_bound(mesh_cmp["route_bins"][1],
                       mesh_cmp["route_bins"][3],
                       timed_by("route_", "argsort", "route_unbin",
                                "index_select")),
        "library_ms": mesh_cmp["route_bins"][4],
        "unbin_bound_ms": mesh_cmp["route_unbin"][3][0],
        "unbin_bound_by": mesh_cmp["route_unbin"][3][1],
        "unbin_share": kernel_bound(
            mesh_cmp["route_unbin"][1], mesh_cmp["route_unbin"][3],
            timed_by("route_unbin", "index_select"))["share"],
        "unbin_library_ms": mesh_cmp["route_unbin"][4],
    }, {
        "name": "scan_machine",
        "route": "cuda",
        "source": "kmergutsjava_tpu_torch/csrc/scan_machine.cu",
        "replaces": "kmergutsjava_tpu/calls/scan_machine.py:62",
        "launches": scan_launches,
        "max_abs_err": max(r[0] for r in scan_cmp.values()),
        "ms": scan_cmp["sparse proteome"][1],
        "plain_ms": scan_cmp["sparse proteome"][2],
        "read_set_ms": scan_cmp["dense read set"][1],
        "longest_steps": scan_cmp["sparse proteome"][4],
        "ns_per_longest_step": scan_cmp["sparse proteome"][1] * 1e6
        / scan_cmp["sparse proteome"][4],
        "order_ms": scan_cmp["sparse proteome"][5],
        **kernel_bound(scan_cmp["sparse proteome"][1],
                       scan_cmp["sparse proteome"][3],
                       timed_by("scan_machine_kernel", "length_order")),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-worker"]:  # one rank of phase 15
        sys.exit(mp_worker(*sys.argv[2:]))
    sys.exit(main())
