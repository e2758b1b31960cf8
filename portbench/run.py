#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (kmergutsjava_tpu_torch): one run
of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
    python3 portbench/run.py --list

A run makes the cell's table and traffic from the seed, brings up and warms
the program (all of that is set-up), measures for ``--seconds`` seconds,
and then judges a sample of the window's answers against the plain
reference (``portbench/reference``). Its last line on standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number with its limit (also the last lines on standard error).

It exits non-zero and prints no result where CUDA is missing or has fewer
cards than the cell asks for, where the program is missing, and where JAX
or the JAX package was loaded in this process. Cells, configurations,
drivers, traffic generators and metrics are found by name (see
``core/registry.py``).
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def fixed_cache_dirs() -> None:
    """Build and kernel caches at fixed places inside the checkout, so that
    only a checkout's first run builds (the port itself builds its host
    libraries and kernels into ``kmergutsjava_tpu_torch/build``)."""
    cache = os.path.join(ROOT, "portbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)


def list_cells() -> int:
    from portbench.core import registry

    bench = registry.benchmark()
    for cell in registry.cells():
        try:
            got = registry.resolve(cell, bench)
        except (KeyError, ValueError, FileNotFoundError) as ex:
            print(f"{cell}: not runnable: {ex}")
            continue
        wl = got["workload"]
        print(f"{cell}: config={wl['config']} driver={wl['driver']} "
              f"traffic={wl['traffic']['name']} "
              f"generator={wl['traffic']['generator']} "
              f"chips={got['chips']} "
              f"end_to_end={','.join(m['name'] for m in got['end_to_end'])} "
              f"per_layer={','.join(m['name'] for m in got['per_layer'])}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=int, default=10)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    if args.list:
        return list_cells()
    if not args.workload:
        ap.error("--workload is required")

    from portbench.core import registry

    cell = registry.resolve(args.workload, registry.benchmark())
    fixed_cache_dirs()
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    import kmergutsjava_tpu_torch  # noqa: F401 - the program must be here

    from portbench.core.harness import Run

    run = Run(args.workload, cell["workload"], cell["config"],
              args.seed % (1 << 64), args.seconds, bool(args.trace), ROOT,
              T0)
    return measure(run, cell, torch.cuda.get_device_name(0))


def measure(run, cell: dict, kind: str) -> int:
    """The run after the look for a chip: set-up, window, judge, and the
    result line, or no result and a non-zero exit where JAX or the JAX
    package was loaded in this process or in a job's own process."""
    from portbench.core.forbidden import ForbiddenModules, loaded
    from portbench.core.harness import card, execute, result_line
    from portbench.core.judge import check_lines

    try:
        checks, correct, metrics = execute(run, cell)
    except ForbiddenModules as ex:
        print(f"loaded in a job's process: {ex}", file=sys.stderr)
        return 4
    found = loaded()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    print(f"card: {card()}; setup_s={run.setup_s} data_s={run.data_s}; "
          f"window {run.window[1] - run.window[0]} s, {run.attempted()} "
          "jobs", file=sys.stderr)
    for line in check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(result_line(run, metrics, checks, correct, kind, cell["chips"]))
    return 0

if __name__ == "__main__":
    sys.exit(main())
