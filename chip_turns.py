#!/usr/bin/env python3
"""Sources of the sparse first-event probe (B1, csrc/tilejoin.cu) timed
against each other in turns on one NVIDIA GPU, at the engine's cases: the
source of PERF.md's in-turns tables for B1 and the fused step's kernel.

    python3 chip_turns.py --variant parent=build/parent/tilejoin.cu \\
        [--variant LABEL=PATH ...] [--b3 LABEL=PATH ...] \\
        [--fused LABEL=PATH ...] [--rounds 2] [--out turns.json]

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
``new``; ``--fused-only`` leaves B1's turns out).

B1 cases: ``engine``, chip_smoke phase 4's launches (the 24M-signature
table, the E. coli proteome's eight dispatches through
SparseLookup.dispatch_probe and resolve_probe); ``synth8``, phase 2's eight
dispatches of 2^19 synthetic queries at w=16; ``synth4m``, 4M synthetic
queries in one launch at w=16. B3 cases: the proteome's 4.04M queries on
the same plane at w=16, in prepare's order and sorted by home. Fused
cases: chip_smoke phase 12's batches (a proteome bucket batch, a read
batch, the genome's windows) in the first-event form on the fused step's
plane, and the first two in the shard form at the (2, 2) step's
position (0, 0) (the batch's first half against table shard 0). Each time is
a kernel's device time from chip_smoke.kernel_device_ms (a torch.profiler
trace, the L2 flushed before each run): a full dispatch's mean for
``engine`` and ``synth8``. The variants run in the given order, then in
reverse, ``--rounds`` times (A B C C B A ...). Needs one card; imports
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--b3", action="append", default=[])
    ap.add_argument("--fused", action="append", default=[])
    ap.add_argument("--fused-only", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return smoke.fail("torch.cuda.is_available() is false")
    from kmergutsjava_tpu_torch.lookup import blockprobe, tilejoin
    from kmergutsjava_tpu_torch.lookup.sparse import SparseLookup
    from kmergutsjava_tpu_torch.parallel import fused_probe

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    b1 = parse_variants(args.variant, tilejoin.SOURCE)
    b3 = parse_variants(args.b3, blockprobe.SOURCE) if args.b3 else []
    fused = (parse_variants(args.fused, fused_probe.SOURCE) if args.fused
             or args.fused_only else [])
    paths = build_all(b1 + [("b3_" + label, src) for label, src in b3]
                      + [("fused_" + label, src) for label, src in fused])
    libs = {label: load(paths[label], "tilejoin_first_event")
            for label, _ in b1}
    b3_libs = {label: load(paths["b3_" + label], "block_probe")
               for label, _ in b3}
    compare_sass({label: paths[label] for label, _ in b1}, "new")
    if b3:
        compare_sass({"b3_" + label: paths["b3_" + label]
                      for label, _ in b3}, "b3_new")
    fused_libs = {label: fused_probe.bind(ctypes.CDLL(paths["fused_" + label]))
                  for label, _ in fused}
    if fused:
        compare_sass({"fused_" + label: paths["fused_" + label]
                      for label, _ in fused}, "fused_new")

    with tempfile.TemporaryDirectory(prefix="kmer_turns_") as work:
        prots = smoke.load_proteome()
        sig = smoke.corpus_signatures(prots)
        _, table, _ = smoke.big_table(work, sig)
        faa = os.path.join(work, "proteome.faa")
        smoke.write_proteome(prots, faa)
        values = smoke.query_values(faa)
        batches = {}
        if fused:
            fna = os.path.join(work, "genome.fna")
            reads = os.path.join(work, "reads.fna")
            smoke.write_reads(reads, smoke.write_genome(fna))
            batches = smoke.window_batches(prots, fna, reads)
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
            same = all(equal(blockprobe.block_probe(lk.fp, q, h, 16),
                             blockprobe.block_probe_reference(lk.fp, q, h,
                                                              16))
                       for q, h in b3_cases.values())
        print(f"check B3 {label}: {'equal to' if same else 'DIFFERS from'} "
              f"the twin", flush=True)
        if label == "new" and not same:
            return smoke.fail("the repository's B3 differs from the twin")

    rows = []
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
                    lambda: blockprobe.block_probe(lk.fp, q, h, 16), dev,
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
