#!/usr/bin/env python3
"""Sources of the sparse first-event probe (B1, csrc/tilejoin.cu) timed
against each other in turns on one NVIDIA GPU, at the engine's cases: the
source of PERF.md's in-turns tables for B1, the fused step's kernel, the
grouping kernel (B11), the routing bins (B13), the device prepare's ragged
entry (B8) and the shard probe (B12).

    python3 chip_turns.py --variant parent=build/parent/tilejoin.cu \\
        [--variant LABEL=PATH ...] [--b3 LABEL=PATH ...] \\
        [--fused LABEL=PATH ...] [--scan LABEL=PATH ...] \\
        [--route LABEL=PATH ...] [--values LABEL=PATH ...] \\
        [--budgets BYTES,...] [--shard LABEL=PATH ...] [--no-b1] \\
        [--walls] [--rounds 2] [--out turns.json]

The repository's csrc/tilejoin.cu is the variant ``new``; each
``--variant`` is another source with the same C entry, such as the parent
commit's or a copy with one change. Every source is built at once (one
nvcc each, ``-Xptxas -v``) and loaded in place of the wrapper's library,
so it is launched exactly as the engine launches the kernel; each one's
machine code is printed as the same as ``new``'s or not. Each
variant's answers on every case are held against the twin and printed as
equal or not (a copy that leaves out part of the work differs); the
repository's own source must equal the twin, or the script exits 1.
``--b3`` does the same for the block probe (csrc/block_probe.cu, ``new``)
and ``--fused`` for the fused step's kernel (csrc/fused_probe.cu,
``new``; ``--fused-only`` leaves B1's turns out). ``--scan`` times
sources of the grouping kernel (csrc/scan_machine.cu, ``new``; a source
whose entry takes no ``order``, such as the parent commit's, is called in
its own form) and ``--route`` sources of the routing bins
(csrc/route_bins.cu, ``new``, through the wrapper), the latter in turns
with ``torch.argsort(owner, stable=True)`` on the same owners (``argsort``,
the library yardstick), and each source's un-binning alone (device time)
and with its read-backs (host time): the packed entry's one copy of its
[3, ld] buffer, or the parent's form (two back buffers in, off and state
out) with its three copies (off, state, the cells for the flags); ``--values`` sources of the window kernel
(csrc/kmer_windows.cu, ``new``), each timed over the calls of its ragged
entry that a whole ``--prepare jax`` prepare of the proteome and of the
read set makes (at each launch budget of ``--budgets``, in bytes: the
tree's VALUES_LAUNCH_BYTES by default); ``--shard`` sources of
the shard probe (csrc/shard_probe.cu, ``new``, through the wrapper);
``--no-b1`` builds, checks and times no B1 source; ``--walls`` also runs
the CLI with ``--grouping scan`` on the proteome and the read set with
each ``--scan`` source in turns, for the wall and Grouping times, and with
``--prepare jax --backend xla`` with each ``--values`` source's tree (the
checkout that holds it, a fresh process a run, at each budget) in turns,
for the cold wall and Preparation times.

B1 cases: ``engine``, chip_smoke phase 4's launches (the 24M-signature
table, the E. coli proteome's eight dispatches through
SparseLookup.dispatch_probe and resolve_probe); ``synth8``, phase 2's eight
dispatches of 2^19 synthetic queries at w=16; ``synth4m``, 4M synthetic
queries in one launch at w=16. B3 cases: the proteome's 4.04M queries on
the same plane at w=16, in prepare's order and sorted by home. Fused
cases: chip_smoke phase 12's batches (a proteome bucket batch, a read
batch, the genome's windows) in the first-event form on the fused step's
plane, and the first two in the shard form at the (2, 2) step's
position (0, 0) (the batch's first half against table shard 0). B11
cases: the engine's own container batches of chip_smoke phase 14's
proteome and read-set runs (``--grouping scan`` on the 24M-signature
table, taken by a spy on the wrapper), each source checked against the
twin at every flag and emitting record. B13 case: chip_smoke phase 13's
first source shard of the routed run over 4 (1,009,459 queries, cap
504,729), each source checked against the twin cell for cell, its
un-binning (of seeded answers) too. B8
cases: the proteome's and the read set's prepares (the calls taken by a
spy on the wrapper, each call's windows held against the twin). B12 case:
chip_smoke phase
13's data row of the sharded (2, 2) run against table
shards 0 and 1, each answer held against the twin. Each time is a kernel's
device time from chip_smoke.kernel_device_ms (a torch.profiler trace, the
L2 flushed before each run): a full dispatch's mean for ``engine`` and
``synth8``. The variants run in the given order, then in reverse,
``--rounds`` times (A B C C B A ...). Needs one card; imports
nothing of JAX.
"""
import argparse
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as smoke  # noqa: E402

BUILD = os.path.join(HERE, "build", "turns")


def parse_variants(texts, source):
    """[(label, source path)], the repository's ``source`` first as new."""
    out = [("new", source)]
    for text in texts:
        label, _, path = text.partition("=")
        out.append((label, os.path.abspath(path)))
    return out


def build_all(jobs):
    """Compile every (label, source) at once; prints ptxas' register and
    spill lines. Returns {label: library path}."""
    from kmergutsjava_tpu_torch.lookup.tilejoin import NVCC_FLAGS, _nvcc

    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for label, src in jobs:
        out = os.path.join(BUILD, f"lib{label}.so")
        procs[label] = (out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", src, "-o", out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths = {}
    for label, (out, p) in procs.items():
        text = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{text}")
        keep = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build {label}: " + " | ".join(keep), flush=True)
        paths[label] = out
    return paths


ADDRESS = re.compile(r"\s*/\*[0-9a-f]{4,}\*/")  # an instruction's line


def sass(path):
    """The machine code of a built library (``cuobjdump -sass``): each
    kernel's instructions with their encodings, names and addresses left
    out, so that two builds of the same code compare equal."""
    from kmergutsjava_tpu_torch.lookup.tilejoin import _nvcc

    text = subprocess.run(
        [os.path.join(os.path.dirname(_nvcc()), "cuobjdump"), "-sass", path],
        capture_output=True, text=True, check=True, timeout=120).stdout
    kernels = []
    for ln in text.splitlines():
        if "Function :" in ln:
            kernels.append([])
        elif kernels and ADDRESS.match(ln):
            kernels[-1].append(ADDRESS.sub("", ln, count=1).strip())
    return sorted(kernels)


def compare_sass(paths, base):
    """Prints, for each library in ``paths`` ({label: path}), whether its
    machine code equals that of ``paths[base]``."""
    want = sass(paths[base])
    for label, path in paths.items():
        if label != base:
            got = sass(path)
            same = "same as" if got == want else "differs from"
            print(f"sass {label}: {same} {base} ({sum(map(len, got))} "
                  f"instructions, {base} {sum(map(len, want))})", flush=True)


def load(path, entry):
    """The library at ``path``, its C ``entry`` typed as both probes'
    entries are."""
    lib = ctypes.CDLL(path)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, i64, p, p, i64, ctypes.c_int32, p, p, p]
    return lib


@contextlib.contextmanager
def swapped(module, lib):
    """The wrapper ``module`` launches ``lib``'s kernel while inside."""
    old = module.load_kernel()
    module._lib = lib
    try:
        yield
    finally:
        module._lib = old


def in_turns(variants, rounds):
    order = []
    for r in range(rounds):
        order += variants if r % 2 == 0 else variants[::-1]
    return order


def equal(got, want):
    import torch

    return all(torch.equal(torch.as_tensor(g).to(w.device), w)
               for g, w in zip(got, want))


def signed(tensors):
    """The tensors with u16 ones viewed as int16 (the card compares no
    u16)."""
    import torch

    return [t.view(torch.int16) if t.dtype == torch.uint16 else t
            for t in tensors]


def fused_cases(table, batches, dev):
    """{case: (run, the twin's answer, the answer's defined views)} of the
    fused kernel at chip_smoke phase 12's batches (first-event form on the
    fused step's plane: off and state, not the bytes between them) and at
    the (2, 2) step's position (0, 0) for the whole-row batches (shard
    form: the batch's first half against table shard 0)."""
    import torch

    from kmergutsjava_tpu_torch.lookup import tilejoin
    from kmergutsjava_tpu_torch.parallel import fused_probe
    from kmergutsjava_tpu_torch.parallel.annotate_step import table_plane
    from kmergutsjava_tpu_torch.parallel.sharded_lookup import \
        shard_table_planes

    pw = max(8, table.max_probe)
    ns = table.num_sigs
    plane = table_plane(table, pw, dev)
    shards = shard_table_planes(table, 2, pw)
    shard0, s_loc = torch.from_numpy(shards["fp"][0]).to(dev), shards["s_loc"]
    cases = {}
    for label, (aa, mat, counts, extra) in batches.items():
        a = torch.from_numpy(mat).to(dev)
        c = torch.from_numpy(counts).to(dev)
        ex = [torch.from_numpy(x).to(dev) for x in extra or ()]
        name = label.split()[0]

        def first(a=a, c=c, aa=aa, ex=ex):
            return fused_probe.first_event(plane, a, c, aa, ns, pw, *ex)

        n = a.shape[0] * (a.shape[1] - 7 if aa else 6 * (a.shape[1] // 3
                                                          - 7))
        cases["first-event " + name] = (
            first, fused_probe.first_event_reference(plane, a, c, aa, ns, pw,
                                                     *ex),
            lambda ans, n=n: tilejoin.answer_views(ans, n))
        if extra is None:
            h = -(-len(mat) // 2)
            a0, c0 = a[:h].contiguous(), c[:h].contiguous()

            def shard(a0=a0, c0=c0, aa=aa):
                return fused_probe.shard_first_match(shard0, a0, c0, aa, ns,
                                                     0, s_loc, pw)

            cases["shard " + name] = (
                shard, fused_probe.shard_first_match_reference(
                    shard0, a0, c0, aa, ns, 0, s_loc, pw),
                lambda ans: [ans])
    return cases


def scan_entry(lib, src):
    """run(hits, offsets, order, kw, flags, recs): a launch of ``lib``'s
    grouping kernel as the wrapper makes it. A source whose C entry takes
    no ``order`` (the parent's) is called in that form."""
    import numpy as np
    import torch

    from kmergutsjava_tpu_torch.lookup.tilejoin import KernelError

    with open(src) as fh:
        ordered = "const void* order" in fh.read()
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    fn = lib.scan_machine
    fn.restype = ctypes.c_int
    tail = [i32, ctypes.c_float, i32, i32, p, p, p]
    fn.argtypes = [p, i64, p, p, i64] + tail if ordered else [p, p, i64] + tail

    def run(hits, offsets, order, kw, flags, recs):
        c = offsets.numel() - 1
        head = ((hits.data_ptr(), hits.shape[0], offsets.data_ptr(),
                 order.data_ptr(), c) if ordered
                else (hits.data_ptr(), offsets.data_ptr(), c))
        rc = fn(*head, int(kw["min_hits"]),
                float(np.float32(kw["min_weighted"])), int(kw["max_gap"]),
                int(bool(kw["order_constraint"])), flags.data_ptr(),
                recs.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise KernelError(f"scan machine launch failed: CUDA error {rc}")
        return flags, recs
    run.ordered = ordered
    return run


@contextlib.contextmanager
def scan_shim(module, run):
    """The grouping wrapper ``module.scan_containers`` launching ``run``
    (a ``scan_entry``) while inside: the engine's own path with another
    source's kernel."""
    import torch

    real = module.scan_containers

    def shim(hits, offsets, *, order=None, **kw):
        n, c = hits.shape[0], offsets.numel() - 1
        flags = torch.empty(n + c, dtype=torch.uint8, device=hits.device)
        recs = torch.empty((n + c, module.REC_INTS), dtype=torch.int32,
                           device=hits.device)
        if c:
            if order is None and run.ordered:
                order = module.length_order(offsets)
            run(hits, offsets, order, kw, flags, recs)
        return flags, recs

    module.scan_containers = shim
    try:
        yield
    finally:
        module.scan_containers = real


def scan_walls(work, big, faa, reads, scan, runs, rounds):
    """Rows of the CLI's wall time and Grouping time with ``--grouping
    scan`` on the proteome and the read set, each B11 source of ``scan``
    in turns (after one untimed run of each input)."""
    from kmergutsjava_tpu_torch.calls import scan_machine as sm

    out = os.path.join(work, "walls.txt")
    inputs = (("proteome", faa, True), ("read set", reads, False))
    for _, query, aa in inputs:
        smoke.run_cli(big, query, out, "cuda", ("--grouping", "scan"), aa=aa)
    rows = []
    for turn, (label, _) in enumerate(in_turns(scan, rounds)):
        with scan_shim(sm, runs[label]):
            for name, query, aa in inputs:
                info, secs = smoke.run_cli(big, query, out, "cuda",
                                           ("--grouping", "scan"), aa=aa)
                rows.append(dict(kernel="B11 wall", turn=turn,
                                 variant=label, case=name, ms=secs * 1e3,
                                 grouping_ms=smoke.phase_ms(info)
                                 ["Grouping"]))
                print("turn " + json.dumps(rows[-1]), flush=True)
    return rows


def packed_unbin(src):
    """Whether the routing source's un-binning entry writes the packed
    [3, ld] answer from one back buffer (else it is the parent's form: two
    back buffers in, off and state out)."""
    with open(src) as fh:
        return "const void* back_state" not in fh.read()


def route_lib(path, src):
    """The routing library at ``path`` (built from ``src``), its entries
    typed as the wrapper of the source's own commit types them."""
    lib = ctypes.CDLL(path)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.route_bins.restype = ctypes.c_int
    lib.route_bins.argtypes = [p, p, i64, i64, i64, ctypes.c_int32, i64,
                               p, p, p, p, p, p]
    lib.route_unbin.restype = ctypes.c_int
    lib.route_unbin.argtypes = ([p, i64, p, i64, p, p] if packed_unbin(src)
                                else [p, i64, p, p, p, p, p])
    return lib


def unbin_runs(lib, src, cell, back):
    """(launch, read) for ``lib``'s un-binning of ``cell`` against the
    answers ``back`` [T, 2, cap], as the routed lookup of the source's own
    commit makes it: launch() runs the kernel alone; read() runs it and
    its read-backs and returns the [3, n] host answer (offsets, states,
    overflow flags). The packed entry writes one [3, ld] buffer, read back
    in one copy; the parent's form takes the offsets and states as two
    buffers [T * cap], writes off and state, and is read back in three
    copies (off, state, and the cells for their overflow flags)."""
    import numpy as np
    import torch

    from kmergutsjava_tpu_torch.lookup.tilejoin import KernelError
    from kmergutsjava_tpu_torch.parallel.route_bins import row_stride

    n, cap, dev = cell.numel(), back.shape[2], cell.device

    def check(rc):
        if rc:
            raise KernelError(f"route_unbin launch failed: CUDA error {rc}")

    if packed_unbin(src):
        out = torch.empty((3, row_stride(n)), dtype=torch.uint8, device=dev)

        def launch():
            check(lib.route_unbin(cell.data_ptr(), n, back.data_ptr(), cap,
                                  out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream))
            return out

        return launch, lambda: launch().cpu().numpy()[:, :n]
    b_off, b_state = (back[:, k].contiguous().view(-1) for k in range(2))
    off = torch.empty(n, dtype=torch.uint8, device=dev)
    state = torch.empty(n, dtype=torch.uint8, device=dev)

    def launch():
        check(lib.route_unbin(cell.data_ptr(), n, b_off.data_ptr(),
                              b_state.data_ptr(), off.data_ptr(),
                              state.data_ptr(),
                              torch.cuda.current_stream().cuda_stream))
        return off, state

    def read():
        o, s = launch()
        return np.stack([o.cpu().numpy(), s.cpu().numpy(),
                         (cell.cpu().numpy() < 0).view(np.uint8)])

    return launch, read


def host_ms(run, reps):
    """The median host milliseconds of ``reps`` runs of ``run`` (which ends
    in a copy to the host), the card idle before each."""
    import torch

    run()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def scan_batches(work, big, faa, reads):
    """{label: (hits, offsets, kw)}: the grouping kernel's batches of the
    proteome's and the read set's ``--grouping scan`` runs on the card."""
    from kmergutsjava_tpu_torch.calls import scan_machine as sm

    out = {}
    for label, query, aa in (("proteome", faa, True),
                             ("read set", reads, False)):
        calls = []
        with smoke.spied(sm, "scan_containers", calls):
            smoke.run_cli(big, query, os.path.join(work, "scan.txt"), "cuda",
                          ("--grouping", "scan"), aa=aa)
        (hits, offsets), kw, _ = calls[0]
        out[label] = (hits, offsets, kw)
        print(f"setup: B11 {label} batch containers={offsets.numel() - 1} "
              f"hits={hits.shape[0]} longest="
              f"{int((offsets[1:] - offsets[:-1]).max())}", flush=True)
    return out


class _Discard:
    """A query store that keeps nothing (the prepare's calls are what is
    timed)."""

    def add_batch(self, values, cnt_id, pos):
        pass


def values_cases(faa, reads, budgets, dev):
    """{(cell, budget): (aa, the ragged entry's calls of a whole prepare
    at that launch budget)}, on the card."""
    from kmergutsjava_tpu_torch.formats.fasta import read_fasta
    from kmergutsjava_tpu_torch.models import prepare
    from kmergutsjava_tpu_torch.ops import kmer_windows as kw

    ragged = {}
    default = prepare.VALUES_LAUNCH_BYTES
    for cell, path, aa in (("proteome", faa, True),
                           ("read set", reads, False)):
        for budget in budgets:
            prepare.VALUES_LAUNCH_BYTES = budget
            try:
                with smoke.spied(kw, "ragged_values", []) as calls:
                    (prepare.prepare_aa if aa else prepare.prepare_dna)(
                        read_fasta(path), _Discard(), device=str(dev))
            finally:
                prepare.VALUES_LAUNCH_BYTES = default
            ragged[cell, budget] = (aa, [a for a, _, _ in calls])
            print(f"setup: B8 {cell} budget={budget} calls={len(calls)} "
                  f"bytes={sum(a[0].numel() for a, _, _ in calls)}",
                  flush=True)
    return ragged


def values_runs(ragged):
    """{case: (run(), calls)}: a window kernel library's ragged entry over
    each prepare's calls."""
    from kmergutsjava_tpu_torch.ops import kmer_windows as kw

    return {f"{cell} budget={b}": ((lambda calls=calls: [
        kw.ragged_values(*a) for a in calls]), len(calls))
        for (cell, b), (aa, calls) in ragged.items()}


def values_check(lib, ragged):
    """Whether ``lib``'s values agree with the twin on every case."""
    from kmergutsjava_tpu_torch.ops import kmer_windows as kw

    with swapped(kw, lib):
        return all(equal(kw.ragged_values(*a),
                         kw.ragged_values_reference(*a))
                   for _, calls in ragged.values() for a in calls)


WALL_RUNNER = (
    "import sys, time\n"
    "import torch\n"
    "from kmergutsjava_tpu_torch import cli\n"
    "from kmergutsjava_tpu_torch.models import prepare\n"
    "prepare.VALUES_LAUNCH_BYTES = int(sys.argv[1])\n"
    "torch.zeros(1, device='cuda')\n"
    "t0 = time.time()\n"
    "rc = cli.main(sys.argv[2:])\n"
    "print('WALL', time.time() - t0, flush=True)\n"
    "sys.exit(rc)\n")


def values_walls(work, big, faa, reads, trees, budgets, rounds):
    """Rows of cold ``--prepare jax --backend xla`` CLI runs, each in a
    fresh process of a tree of ``trees`` ({label: checkout}; the parent's
    at its own batching, the others at each budget), in turns: the wall
    of cli.main and the Preparation time."""
    out = os.path.join(work, "walls.txt")
    inputs = (("proteome", faa, True), ("read set", reads, False))
    runs = [(label, tree, b) for label, tree in trees.items()
            for b in (budgets if label != "parent" else budgets[:1])]

    def one(tree, budget, query, aa):
        args = [*(["-a"] if aa else []), "-D", big, "-q", query, "-o", out,
                "--device", "cuda", "--prepare", "jax", "--backend", "xla"]
        res = subprocess.run([sys.executable, "-c", WALL_RUNNER, str(budget),
                              *args], cwd=tree, capture_output=True,
                             text=True, timeout=600,
                             env=dict(os.environ, PYTHONPATH=tree))
        if res.returncode:
            raise RuntimeError(f"walls in {tree}: {res.stderr[-2000:]}")
        wall = float(res.stdout.split("WALL ")[-1].split()[0])
        return wall, smoke.phase_ms(res.stdout)

    for _, tree, b in runs:  # builds each tree's kernels, warms the files
        one(tree, b, faa, True)
    rows = []
    for turn, (label, tree, b) in enumerate(in_turns(runs, rounds)):
        for name, query, aa in inputs:
            wall, ms = one(tree, b, query, aa)
            rows.append(dict(kernel="B8 wall", turn=turn, variant=label,
                             case=f"{name} budget={b}", ms=wall * 1e3,
                             preparation_ms=ms.get("Preparation"),
                             lookup_ms=ms.get("Lookup")))
            print("turn " + json.dumps(rows[-1]), flush=True)
    return rows


def shard_case(table, values, dev):
    """chip_smoke phase 13's B12 shape: data row 0 of the sharded (2, 2)
    run (the proteome padded to 2 x 256, its first half) against table
    shards 0 and 1. Returns [(plane, q_fp, homes, lo, s_loc, w)]."""
    import numpy as np
    import torch

    from kmergutsjava_tpu_torch.lookup.sparse import FP_MOD
    from kmergutsjava_tpu_torch.parallel.sharded_lookup import \
        shard_table_planes

    pw = max(8, table.max_probe)
    planes = shard_table_planes(table, 2, pw)
    s_loc = planes["s_loc"]
    n = len(values)
    v = np.zeros(-(-n // 512) * 512, np.int64)
    v[:n] = values
    half = v[:len(v) // 2]
    q = torch.from_numpy((half % FP_MOD).astype(np.uint16)).to(dev)
    h = torch.from_numpy((half % table.num_sigs).astype(np.int32)).to(dev)
    return [(torch.from_numpy(planes["fp"][t]).to(dev), q, h, t * s_loc,
             s_loc, pw) for t in range(2)]


def shard_lib(path):
    """The shard probe library at ``path``, typed as the wrapper types
    it."""
    lib = ctypes.CDLL(path)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.shard_probe.restype = ctypes.c_int
    lib.shard_probe.argtypes = [p, i64, p, p, i64, i64, i64, ctypes.c_int32,
                                p, p]
    return lib


def b1_b3_cases(table, values, dev):
    """B1's cases ({case: (plane, w, chunks, run)}), B3's ({order: (q_fp,
    homes)}), the engine's chunk size and the plane, on the sparse lookup
    of ``table``."""
    import numpy as np
    import torch

    from kmergutsjava_tpu_torch.lookup import tilejoin
    from kmergutsjava_tpu_torch.lookup.sparse import SparseLookup

    lk = SparseLookup(table, device=str(dev))
    chunk = lk.chunk
    host_chunks = smoke.engine_chunks(lk, values)
    real = [(torch.from_numpy(q).to(dev), torch.from_numpy(h).to(dev))
            for q, h in host_chunks]
    fp8, q8, h8 = smoke.synthetic_probe(dev, 16, 8 * chunk)
    synth = [(q8[s:e], h8[s:e]) for s, e in smoke.chunk_spans(8 * chunk,
                                                              chunk)]
    fp4, q4, h4 = smoke.synthetic_probe(dev, 16, smoke.BIG_QUERIES, seed=1)
    cases = {
        "engine": (lk.fp, lk.w1, real,
                   lambda: smoke.engine_launches(lk, host_chunks)),
        "synth8": (fp8, 16, synth,
                   lambda: [tilejoin.tilejoin_probe(fp8, q, h, 16)
                            for q, h in synth]),
        "synth4m": (fp4, 16, [(q4, h4)],
                    lambda: [tilejoin.tilejoin_probe(fp4, q4, h4, 16)]),
    }
    print(f"setup: plane_slots={lk.fp.numel()} w1={lk.w1} "
          f"chunks={[h.numel() for _, h in real]}", flush=True)
    hv = values % lk.num_sigs
    b3_cases = {
        order: (torch.from_numpy((vals % 65535).astype(np.uint16)).to(dev),
                torch.from_numpy((vals % lk.num_sigs).astype(np.int32))
                .to(dev))
        for order, vals in (("prepare", values),
                            ("home", values[np.lexsort((values, hv))]))}
    return cases, b3_cases, chunk, lk.fp


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--b3", action="append", default=[])
    ap.add_argument("--fused", action="append", default=[])
    ap.add_argument("--fused-only", action="store_true")
    ap.add_argument("--scan", action="append", default=[])
    ap.add_argument("--route", action="append", default=[])
    ap.add_argument("--values", action="append", default=[])
    ap.add_argument("--budgets", default="")
    ap.add_argument("--shard", action="append", default=[])
    ap.add_argument("--no-b1", action="store_true")
    ap.add_argument("--walls", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        return smoke.fail("torch.cuda.is_available() is false")
    from kmergutsjava_tpu_torch.calls import scan_machine
    from kmergutsjava_tpu_torch.lookup import blockprobe, tilejoin
    from kmergutsjava_tpu_torch.models import prepare
    from kmergutsjava_tpu_torch.ops import kmer_windows
    from kmergutsjava_tpu_torch.parallel import (fused_probe, route_bins,
                                                 shard_probe)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    b1 = [] if args.no_b1 else parse_variants(args.variant, tilejoin.SOURCE)
    b3 = parse_variants(args.b3, blockprobe.SOURCE) if args.b3 else []
    fused = (parse_variants(args.fused, fused_probe.SOURCE) if args.fused
             or args.fused_only else [])
    scan = (parse_variants(args.scan, scan_machine.SOURCE) if args.scan
            else [])
    route = (parse_variants(args.route, route_bins.SOURCE) if args.route
             else [])
    b8 = (parse_variants(args.values, kmer_windows.SOURCE) if args.values
          else [])
    b12 = (parse_variants(args.shard, shard_probe.SOURCE) if args.shard
           else [])
    budgets = [int(b) for b in args.budgets.split(",") if b] or [
        prepare.VALUES_LAUNCH_BYTES]
    paths = build_all(b1 + [("b3_" + label, src) for label, src in b3]
                      + [("fused_" + label, src) for label, src in fused]
                      + [("scan_" + label, src) for label, src in scan]
                      + [("route_" + label, src) for label, src in route]
                      + [("values_" + label, src) for label, src in b8]
                      + [("shard_" + label, src) for label, src in b12])
    libs = {label: load(paths[label], "tilejoin_first_event")
            for label, _ in b1}
    b3_libs = {label: load(paths["b3_" + label], "block_probe")
               for label, _ in b3}
    if b1:
        compare_sass({label: paths[label] for label, _ in b1}, "new")
    if b3:
        compare_sass({"b3_" + label: paths["b3_" + label]
                      for label, _ in b3}, "b3_new")
    fused_libs = {label: fused_probe.bind(ctypes.CDLL(paths["fused_" + label]))
                  for label, _ in fused}
    if fused:
        compare_sass({"fused_" + label: paths["fused_" + label]
                      for label, _ in fused}, "fused_new")
    scan_runs = {label: scan_entry(ctypes.CDLL(paths["scan_" + label]), src)
                 for label, src in scan}
    route_libs = {label: route_lib(paths["route_" + label], src)
                  for label, src in route}
    values_libs = {label: kmer_windows.bind(ctypes.CDLL(
        paths["values_" + label])) for label, _ in b8}
    shard_libs = {label: shard_lib(paths["shard_" + label])
                  for label, _ in b12}
    for kind, jobs in (("scan_", scan), ("route_", route),
                       ("values_", b8), ("shard_", b12)):
        if jobs:
            compare_sass({kind + label: paths[kind + label]
                          for label, _ in jobs}, kind + "new")

    with tempfile.TemporaryDirectory(prefix="kmer_turns_") as work:
        prots = smoke.load_proteome()
        sig = smoke.corpus_signatures(prots)
        big, table, _ = smoke.big_table(work, sig)
        faa = os.path.join(work, "proteome.faa")
        smoke.write_proteome(prots, faa)
        values = smoke.query_values(faa)
        batches, s_batches, v_ragged, v_walls = {}, {}, {}, []
        if fused or scan or b8:
            fna = os.path.join(work, "genome.fna")
            reads = os.path.join(work, "reads.fna")
            smoke.write_reads(reads, smoke.write_genome(fna))
        if fused:
            batches = smoke.window_batches(prots, fna, reads)
        if scan:
            s_batches = scan_batches(work, big, faa, reads)
        wall_rows = (scan_walls(work, big, faa, reads, scan, scan_runs,
                                args.rounds) if scan and args.walls else [])
        if b8:
            v_ragged = values_cases(faa, reads, budgets, dev)
        if b8 and args.walls:
            trees = {label: os.path.dirname(os.path.dirname(
                os.path.dirname(src))) for label, src in b8}
            v_walls = values_walls(work, big, faa, reads, trees, budgets,
                                   args.rounds)
    cases, b3_cases, chunk, plane = {}, {}, 0, None
    if b1 or b3:
        cases, b3_cases, chunk, plane = b1_b3_cases(table, values, dev)
    for label, _ in b1:
        with swapped(tilejoin, libs[label]):
            same = all(
                equal(got, tilejoin.first_event_reference(fp, q, h, w))
                for fp, w, chunks, run in cases.values()
                for (q, h), got in zip(chunks, run()))
        print(f"check {label}: {'equal to' if same else 'DIFFERS from'} "
              f"the twin on {list(cases)}", flush=True)
        if label == "new" and not same:
            return smoke.fail("the repository's B1 differs from the twin")
    f_cases = fused_cases(table, batches, dev) if fused else {}
    for label, _ in fused:
        with swapped(fused_probe, fused_libs[label]):
            same = all(equal(view(run()), view(want))
                       for run, want, view in f_cases.values())
        print(f"check fused {label}: {'equal to' if same else 'DIFFERS from'}"
              f" the twin on {list(f_cases)}", flush=True)
        if label == "new" and not same:
            return smoke.fail("the repository's fused kernel differs from "
                              "the twin")
    for label, _ in b3:
        with swapped(blockprobe, b3_libs[label]):
            same = all(equal(blockprobe.block_probe(plane, q, h, 16),
                             blockprobe.block_probe_reference(plane, q, h,
                                                              16))
                       for q, h in b3_cases.values())
        print(f"check B3 {label}: {'equal to' if same else 'DIFFERS from'} "
              f"the twin", flush=True)
        if label == "new" and not same:
            return smoke.fail("the repository's B3 differs from the twin")

    s_cases = {}
    for name, (hits, offsets, kw) in s_batches.items():
        n, c = hits.shape[0], offsets.numel() - 1
        flags = torch.empty(n + c, dtype=torch.uint8, device=dev)
        recs = torch.empty((n + c, scan_machine.REC_INTS), dtype=torch.int32,
                           device=dev)
        s_cases[name] = (hits, offsets, scan_machine.length_order(offsets),
                         kw, flags, recs, scan_machine
                         .scan_containers_reference(hits, offsets, **kw))
    for label, _ in scan:
        same = True
        for hits, offsets, order, kw, flags, recs, want in s_cases.values():
            got = scan_runs[label](hits, offsets, order, kw, flags, recs)
            emit = (want[0] & 2) != 0
            same = same and torch.equal(got[0], want[0]) and torch.equal(
                got[1][emit], want[1][emit])
        print(f"check B11 {label}: {'equal to' if same else 'DIFFERS from'} "
              f"the twin on {list(s_cases)}", flush=True)
        if label == "new" and not same:
            return smoke.fail("the repository's B11 differs from the twin")
    if route:
        q, h, (n_valid, s_loc, shards, cap) = smoke.route_shard0(
            table, values, dev)
        owner = smoke.route_owners(h, n_valid, s_loc, shards)
        r_want = route_bins.bins_reference(q, h, n_valid, s_loc, shards, cap)
        r_cell = r_want[2]
        r_back = torch.randint(
            0, 256, (shards, 2, cap), dtype=torch.uint8, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
        u_want = route_bins.unbin_reference(r_cell, r_back).cpu().numpy()[
            :, :r_cell.numel()]
        route.append(("argsort", None))
    for label, _ in b8:
        same = values_check(values_libs[label], v_ragged)
        print(f"check B8 {label}: {'equal to' if same else 'DIFFERS from'} "
              f"the twin", flush=True)
        if label == "new" and not same:
            return smoke.fail("the repository's B8 differs from the twin")
    sh_cases = shard_case(table, values, dev) if b12 else []
    for label, _ in b12:
        with swapped(shard_probe, shard_libs[label]):
            same = all(equal([shard_probe.shard_probe(*c)],
                             [shard_probe.shard_probe_reference(*c)])
                       for c in sh_cases)
        print(f"check B12 {label}: {'equal to' if same else 'DIFFERS from'} "
              f"the twin", flush=True)
        if label == "new" and not same:
            return smoke.fail("the repository's B12 differs from the twin")
    unbins = {}
    for label, src in route[:-1]:
        with swapped(route_bins, route_libs[label]):
            same = equal(signed(route_bins.bins(q, h, n_valid, s_loc,
                                                shards, cap)),
                         signed(r_want))
        unbins[label] = unbin_runs(route_libs[label], src, r_cell, r_back)
        same = same and (unbins[label][1]() == u_want).all()
        print(f"check B13 {label}: {'equal to' if same else 'DIFFERS from'} "
              f"the twin (bins and un-binning)", flush=True)
        if label == "new" and not same:
            return smoke.fail("the repository's B13 differs from the twin")

    rows = wall_rows + v_walls
    for turn, (label, _) in enumerate(in_turns(
            [] if args.fused_only else b1, args.rounds)):
        with swapped(tilejoin, libs[label]):
            for name, (_, _, chunks, run) in cases.items():
                ms, kept = smoke.kernel_device_ms(run, dev, "first_event",
                                                  reps=args.reps)
                full = [m for m, (_, h) in zip(ms, chunks)
                        if h.numel() in (chunk, smoke.BIG_QUERIES)]
                rows.append(dict(kernel="B1", turn=turn, variant=label,
                                 case=name, ms=sum(full) / len(full),
                                 runs_kept=kept, by_launch=ms))
                print("turn " + json.dumps(rows[-1]), flush=True)
    for turn, (label, _) in enumerate(in_turns(b3, args.rounds)):
        with swapped(blockprobe, b3_libs[label]):
            for name, (q, h) in b3_cases.items():
                ms, kept = smoke.kernel_device_ms(
                    lambda: blockprobe.block_probe(plane, q, h, 16), dev,
                    "block_probe", reps=args.reps)
                rows.append(dict(kernel="B3", turn=turn, variant=label,
                                 case=name, ms=ms[0], runs_kept=kept))
                print("turn " + json.dumps(rows[-1]), flush=True)

    for turn, (label, _) in enumerate(in_turns(fused, args.rounds)):
        with swapped(fused_probe, fused_libs[label]):
            for name, (run, _, _) in f_cases.items():
                ms, kept = smoke.kernel_device_ms(
                    run, dev, "fused_probe_kernel", reps=args.reps)
                rows.append(dict(kernel="fused", turn=turn, variant=label,
                                 case=name, ms=ms[0], runs_kept=kept))
                print("turn " + json.dumps(rows[-1]), flush=True)

    for turn, (label, _) in enumerate(in_turns(scan, args.rounds)):
        for name, (hits, offsets, order, kw, flags, recs, _) in \
                s_cases.items():
            ms, kept = smoke.kernel_device_ms(
                lambda: scan_runs[label](hits, offsets, order, kw, flags,
                                         recs), dev, "scan_machine_kernel",
                reps=args.reps)
            rows.append(dict(kernel="B11", turn=turn, variant=label,
                             case=name, ms=ms[0], runs_kept=kept))
            print("turn " + json.dumps(rows[-1]), flush=True)
    for turn, (label, _) in enumerate(in_turns(route, args.rounds)):
        if label == "argsort":
            ms, kept = smoke.library_device_ms(
                lambda: torch.argsort(owner, stable=True), dev,
                reps=args.reps)
            by = [ms]
        else:
            with swapped(route_bins, route_libs[label]):
                by, kept = smoke.kernel_device_ms(
                    lambda: route_bins.bins(q, h, n_valid, s_loc, shards,
                                            cap), dev, "route_",
                    reps=args.reps)
        rows.append(dict(kernel="B13", turn=turn, variant=label,
                         case="shard 0 of 4", ms=sum(by), runs_kept=kept,
                         by_kernel=by))
        print("turn " + json.dumps(rows[-1]), flush=True)
        if label in unbins:
            launch, read = unbins[label]
            ms, kept = smoke.kernel_device_ms(launch, dev, "route_unbin",
                                              reps=args.reps)
            rows.append(dict(kernel="B13 unbin", turn=turn, variant=label,
                             case="shard 0 of 4", ms=ms[0], runs_kept=kept))
            print("turn " + json.dumps(rows[-1]), flush=True)
            rows.append(dict(kernel="B13 unbin + read-backs", turn=turn,
                             variant=label, case="shard 0 of 4",
                             ms=host_ms(read, 4 * args.reps)))
            print("turn " + json.dumps(rows[-1]), flush=True)

    for turn, (label, _) in enumerate(in_turns(b8, args.rounds)):
        with swapped(kmer_windows, values_libs[label]):
            for name, (run, calls) in values_runs(v_ragged).items():
                ms, kept = smoke.kernel_device_ms(run, dev, "ragged_",
                                                  reps=args.reps)
                each = len(ms) // calls  # kernels a call
                rows.append(dict(kernel="B8", turn=turn, variant=label,
                                 case=name, ms=sum(ms), runs_kept=kept,
                                 kernels=len(ms), by_kernel=[
                                     sum(ms[i::each]) for i in range(each)]))
                print("turn " + json.dumps(rows[-1]), flush=True)
    for turn, (label, _) in enumerate(in_turns(b12, args.rounds)):
        with swapped(shard_probe, shard_libs[label]):
            for t, c in enumerate(sh_cases):
                ms, kept = smoke.kernel_device_ms(
                    lambda: shard_probe.shard_probe(*c), dev,
                    "shard_probe_kernel", reps=args.reps)
                rows.append(dict(kernel="B12", turn=turn, variant=label,
                                 case=f"table shard {t} of 2", ms=ms[0],
                                 runs_kept=kept))
                print("turn " + json.dumps(rows[-1]), flush=True)

    summary = {}
    for row in rows:
        summary.setdefault(f"{row['kernel']} {row['variant']} {row['case']}",
                           []).append(row["ms"])
    for key, ms in summary.items():
        print(f"summary {key}: mean={sum(ms) / len(ms):.5f} "
              f"min={min(ms):.5f} max={max(ms):.5f} n={len(ms)}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(card=smi, torch=torch.__version__, rows=rows,
                           summary=summary), fh, indent=1)
    print("turns ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
