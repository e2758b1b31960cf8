"""Command-line driver.

Covers the reference CLI surface (ref KmerGutsJava.java:560-654) with the
same single-char flags, fixed rather than bug-compatible: -t/-l actually
work (the reference's switch falls through, ref :605-610) and omitting -q
really reads stdin (the reference NPEs, ref :647). Port extensions use long
flags.

Usage: python -m kmergutsjava_tpu_torch.cli [options] -D DataDir
"""
from __future__ import annotations

import sys
from typing import List, Optional

from .config import EngineConfig
from .utils.timing import record, span

USAGE = """Usage: kmer_guts [options] -D DataDir
Arguments:
 -a - (optional) amino acids in input FASTA (default is DNA)
 -d - (optional) print debug messages
 -m - (optional) min. number of hits in result (integer, default = 5)
 -M - (optional) min. sum of hit weights (integer, default = 0)
 -O - (optional) order constraint (don't use order by default)
 -g - (optional) max. gap between hits to be joined (integer, default = 200)
 -D - (required) data directory with kmer-table and function-index files
 -q - (optional) query fasta file (STDIN if not defined)
 -o - (optional) output file (STDOUT if not defined)
 -t - (optional) temporary directory (system one is used by default)
 -l - (optional) limit for input Kmer array (long, default = 20,000,000)
 --device NAME - (optional) torch device of the probe: cuda (default; the CUDA kernel) or cpu (its PyTorch twin)
 --backend NAME - (optional) lookup backend: auto (default: stream vs xla by density; routed instead of xla with --mesh), xla, stream, spmd (fused device prepare+lookup), pallas, parity, replicated, sharded, routed
 --mesh DxT - (optional) device mesh for --backend sharded/routed/replicated/stream/xla/spmd/auto, e.g. 4x2 (D x T devices: the first card, then the others)
 --probe-window N - (optional) override table-derived probe window
 --chunk N - (optional) queries per device dispatch (default 524288)
 --prepare IMPL - (optional) encode impl: native (default), numpy, jax
 --grouping IMPL - (optional) call grouping: host (default) or scan (the grouping kernel on --device)
 --sort-chunks 0|1 - (optional) home-sort each sparse probe chunk before the probe (default: 0, also env KMER_SORT_CHUNKS)
 --device-sort - (optional) with --sort-chunks 1, run that sort on the device (also env KMER_DEVICE_SORT)
 --platform NAME - (optional) device platform, the first of a comma list: cpu (= --device cpu), gpu or cuda (= --device cuda)
 --threads N - (optional) native host-stage threads (default: all cores; also env KMER_NATIVE_THREADS)
 --profile DIR - (optional) write a torch.profiler trace of the run (DIR/trace.json) and its span and counter totals (DIR/spans.json)
 --checkpoint FILE - (optional) restartable run: commit progress to FILE after every batch and resume from it on restart (requires -q and -o, refuses -d; output is byte-identical to a single run)
 --checkpoint-every N - (optional) sequences per committed batch (default 100000)
"""

# --platform names and the device each pins
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def parse_args(argv: List[str]):
    cfg = EngineConfig()
    data_dir: Optional[str] = None
    query: Optional[str] = None
    output: Optional[str] = None
    n_threads: Optional[int] = None
    ckpt: Optional[str] = None
    ckpt_every: Optional[int] = None
    platform: Optional[str] = None
    device_given = False
    params = list(argv)
    while params:
        param = params.pop(0)
        if not param.startswith("-"):
            raise ValueError("Parameter name should start from '-': " + param)
        if param.startswith("--"):
            name = param[2:]
            if name == "device":
                cfg.device = params.pop(0)
                device_given = True
            elif name == "backend":
                cfg.backend = params.pop(0)
            elif name == "probe-window":
                cfg.probe_window = int(params.pop(0))
            elif name == "chunk":
                cfg.lookup_chunk = int(params.pop(0))
            elif name == "prepare":
                cfg.prepare_impl = params.pop(0)
            elif name == "grouping":
                cfg.grouping_impl = params.pop(0)
            elif name == "mesh":
                d, t = params.pop(0).split("x")
                cfg.mesh_shape = (int(d), int(t))
            elif name == "profile":
                cfg.profile_dir = params.pop(0)
            elif name == "threads":
                n_threads = int(params.pop(0))
                if n_threads < 1:
                    raise ValueError("--threads must be >= 1")
                # applied by main() after a successful parse, so a later
                # parse error can't leave the process env mutated
            elif name == "checkpoint":
                ckpt = params.pop(0)
            elif name == "checkpoint-every":
                ckpt_every = int(params.pop(0))
                if ckpt_every < 1:
                    raise ValueError("--checkpoint-every must be >= 1")
            elif name == "sort-chunks":
                cfg.sort_chunks = params.pop(0) == "1"
            elif name == "device-sort":
                cfg.device_sort = True
            elif name == "platform":
                platform = params.pop(0)
            else:
                raise ValueError("Unknown parameter: --" + name)
            continue
        name = param[1:]
        if len(name) != 1:
            raise ValueError("Unknown parameter: -" + name)
        c = name[0]
        if c == "a":
            cfg.aa = True
        elif c == "d":
            cfg.debug = True
        elif c == "m":
            cfg.min_hits = int(params.pop(0))
        elif c == "M":
            cfg.min_weighted_hits = int(params.pop(0))
        elif c == "O":
            cfg.order_constraint = True
        elif c == "g":
            cfg.max_gap = int(params.pop(0))
        elif c == "D":
            data_dir = params.pop(0)
        elif c == "q":
            query = params.pop(0)
        elif c == "o":
            output = params.pop(0)
        elif c == "t":
            cfg.temp_dir = params.pop(0)
        elif c == "l":
            cfg.input_size_limit = int(params.pop(0))
        else:
            raise ValueError("Unknown parameter: -" + name)
    if data_dir is None:
        raise ValueError("-D parameter is required")
    if platform is not None:
        name = platform.split(",")[0]
        if name not in PLATFORMS:
            raise ValueError(f"--platform {platform}: no such platform here "
                             "(cpu, gpu or cuda)")
        kind = cfg.device.split(":", 1)[0]
        if device_given and kind != PLATFORMS[name]:
            raise ValueError(f"--platform {platform} contradicts --device "
                             f"{cfg.device}")
        if not device_given:
            cfg.device = PLATFORMS[name]
    if ckpt is not None:
        if query is None or output is None:
            raise ValueError("--checkpoint requires -q FILE and -o FILE "
                             "(stdin/stdout runs cannot be resumed)")
        if cfg.debug:
            raise ValueError("--checkpoint does not support -d (debug "
                             "writes per-run info lines into the report)")
    elif ckpt_every is not None:
        raise ValueError("--checkpoint-every requires --checkpoint")
    cfg.__post_init__()  # validate what the flags set
    return cfg, data_dir, query, output, n_threads, ckpt, ckpt_every


def main(argv: Optional[List[str]] = None) -> int:
    # one run record a call, argument parsing to return (a --profile run
    # writes it as spans.json)
    with record("cli.main"):
        return _main(argv)


def _main(argv: Optional[List[str]]) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        (cfg, data_dir, query, output, n_threads,
         ckpt, ckpt_every) = parse_args(argv)
    except (ValueError, IndexError) as ex:
        print("Error: " + str(ex))
        print(USAGE, end="")
        return 2
    if n_threads is not None:
        import os

        # the native stages read this per call (getenv)
        os.environ["KMER_NATIVE_THREADS"] = str(n_threads)
    if ckpt is not None:
        with span("cli.imports"):
            from .models.checkpoint import (DEFAULT_BATCH_GROUPS,
                                            CheckpointError,
                                            run_with_checkpoint)

        # a KernelError is no CheckpointError: it propagates with its
        # traceback, and the sidecar stays at the last committed batch
        try:
            run_with_checkpoint(cfg, data_dir, query, output, ckpt,
                                ckpt_every or DEFAULT_BATCH_GROUPS)
        except CheckpointError as ex:
            print("Error: " + str(ex), file=sys.stderr)
            return 3
        return 0
    with span("cli.imports"):  # torch and the engine
        from .models.pipeline import Engine

    engine = Engine(cfg)
    if output is not None:
        with open(output, "w") as out:
            engine.run(data_dir, query, out, stdout=False,
                       query_stream=None if query else sys.stdin)
    else:
        engine.run(data_dir, query, sys.stdout, stdout=True,
                   query_stream=None if query else sys.stdin)
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
