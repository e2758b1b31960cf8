#!/usr/bin/env python3
"""Profile of the PyTorch/CUDA package's cells on one NVIDIA GPU: the
source of the breakdowns in PERF.md section 5.

    python3 chip_profile.py [--cell sparse|dense] [--runs N] [--out profile.json]

Both cells query chip_smoke.py's realistic table: the corpus signatures
plus seeded filler, 24M signatures at load 0.6 (40M slots).

- ``sparse`` (chip_smoke phase 4): the E. coli K-12 proteome (4.04M query
  8-mers, ``-a``); ``auto`` takes the sparse tile-join path. The compared
  runs are ``--device cuda`` against ``--device cpu``.
- ``dense`` (chip_smoke phase 7): the seeded read set of 120,000 reads of
  150 bp (22.5M query 8-mers, DNA mode); ``auto`` takes the stream path in
  two plane passes. The compared runs are ``auto`` (stream) against
  ``--backend xla``, both on cuda.

The script makes one CLI run of the cell's ``auto`` on cuda with
``--profile``; from its torch.profiler trace come the device's busy time
(the union of kernel, copy and memset intervals), its idle share of the
run's phase time, and the totals by kind and by name. Then one warm run
(its lookup cached in the process), then N runs of each compared variant,
alternating, with their phase lines. Alternating, every run builds its
lookup (the engine's one-slot lookup cache holds the other variant's), as
a fresh CLI process does.

Prints one JSON line per measurement (and writes them all to ``--out``).
Exits non-zero if the compared variants' reports differ. Needs one card;
imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as smoke  # noqa: E402


def trace_summary(path, phase_ms):
    """Device busy time (union of kernel/copy/memset intervals), idle share
    of ``phase_ms`` and totals by kind and by name, from a Chrome trace."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans, by_kind, by_name = [], {}, {}
    for e in events:
        kind = e.get("cat", "")
        if e.get("ph") != "X" or kind not in ("kernel", "gpu_memcpy",
                                              "gpu_memset"):
            continue
        spans.append((e["ts"], e["ts"] + e["dur"]))
        by_kind[kind] = by_kind.get(kind, 0.0) + e["dur"] / 1000.0
        name = e.get("name", "")[:80]
        by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1000.0
    busy, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    busy_ms = busy / 1000.0
    return dict(device_events=len(spans), busy_ms=busy_ms,
                phase_ms=phase_ms,
                idle_share=1.0 - busy_ms / phase_ms if phase_ms else None,
                ms_by_kind=by_kind,
                ms_by_name=dict(sorted(by_name.items(),
                                       key=lambda kv: -kv[1])[:10]))


def cell(work, kind, runs):
    prots = smoke.load_proteome()
    d, _, _ = smoke.big_table(work, smoke.corpus_signatures(prots))
    if kind == "sparse":
        query, aa = os.path.join(work, "proteome.faa"), True
        smoke.write_proteome(prots, query)
        variants = (("cpu", "auto"), ("cuda", "auto"))
    else:
        query, aa = os.path.join(work, "reads.fna"), False
        smoke.write_reads(query, smoke.write_genome(
            os.path.join(work, "genome.fna")))
        variants = (("cuda", "xla"), ("cuda", "auto"))
    n_q = len(smoke.query_values(query, aa))
    report = os.path.join(work, "report.txt")

    def run(device, backend, extra=()):
        return smoke.run_cli(d, query, report, device,
                             ("--backend", backend, *extra), aa=aa)

    run(*variants[0])  # warm-up: kernel and host C++ builds, table cache

    tdir = os.path.join(work, "trace")
    info, secs = run("cuda", "auto", ("--profile", tdir))
    ms = smoke.phase_ms(info)
    out = {"cell": kind, "trace": trace_summary(
        os.path.join(tdir, "trace.json"), sum(ms.values()))}
    out["trace"].update(wall_s=secs, query_kmers=n_q, **ms)
    print("trace: " + json.dumps(out["trace"]), flush=True)

    info, secs = run("cuda", "auto")
    out["warm_cuda"] = dict(wall_s=secs, **smoke.phase_ms(info))
    print("warm cuda: " + json.dumps(out["warm_cuda"]), flush=True)

    out["runs"], reports = [], {}
    for i in range(runs):
        for device, backend in variants:
            info, secs = run(device, backend)
            with open(report, "rb") as fh:
                reports.setdefault((device, backend), fh.read())
            r = dict(run=i, device=device, backend=backend, wall_s=secs,
                     **smoke.phase_ms(info))
            print("run: " + json.dumps(r), flush=True)
            out["runs"].append(r)
    out["reports_identical"] = len(set(reports.values())) == 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", choices=("sparse", "dense"), default="sparse")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", help="write all measurements here as JSON")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        return smoke.fail("torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory(prefix="kmer_profile_") as work:
        result = dict(card=smi, torch=torch.__version__,
                      **cell(work, args.cell, args.runs))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    if not result["reports_identical"]:
        return smoke.fail("the compared runs' reports differ")
    print("profile ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
