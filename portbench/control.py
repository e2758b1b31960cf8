#!/usr/bin/env python3
"""The control of the benchmark's comparison, at a cell's own size: the
plain reference computed with bfloat16 weight sums put in the program's
place, judged as a run judges the program (``core/judge.py``). Its
readings set the upper end of each limit; the benchmark's runs do not run
it.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

For each seed: the cell's table and traffic as a run makes them, the
judge's sample drawn over the traffic pool (its longest job and others
drawn from the seed), and ``judge(run, precision="bfloat16")``: one JSON
line with the judge's checks, each with its limit, and its verdict
``correct``. Needs no card and loads nothing of the program.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell: dict, name: str, seed: int, work_root=None,
             config=None, workload=None) -> dict:
    from portbench.core.harness import Done, Run
    from portbench.core.judge import judge

    run = Run(name, workload or cell["workload"], config or cell["config"],
              seed % (1 << 64), 0, False, ROOT, time.time(),
              work_root=work_root)
    try:
        run.make_data(cell["generator"])
        run.done = [Done(job, 0.0, 0.0, True) for job in run.jobs]
        t = time.time()
        checks, correct = judge(run, precision="bfloat16")
        return {"workload": name, "seed": seed, "correct": correct,
                "checks": checks, "data_s": run.data_s,
                "judge_s": time.time() - t}
    finally:
        run.cleanup()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    from portbench.core import registry

    cell = registry.resolve(args.workload, registry.benchmark())
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
