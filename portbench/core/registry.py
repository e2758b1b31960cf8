"""Finds what a cell needs by name, so that a configuration, a cell, a
driver, a traffic generator or a metric is added by adding files:

- ``BENCHMARK.json`` at the checkout's root: the cells, and which metrics
  each cell reports (a metric without ``workloads`` is every cell's);
- ``portbench/workloads/<cell>.json``: its configuration, driver, traffic
  mix (generator and parameters), the judge's sample size and its why;
- ``portbench/configs/<config>.json``: the table and engine options;
- ``portbench/drivers/<driver>.py``, ``portbench/traffic/<generator>.py``;
- ``portbench/metrics/<metric>.py``: one reader a metric, ``read(run)``.
"""
from __future__ import annotations

import glob
import importlib.util
import json
import os
import re
from typing import Dict, List

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def data(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH, kind, name + ".json")) as fh:
        return json.load(fh)


def module(kind: str, name: str):
    path = os.path.join(BENCH, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    key = "portbench_" + kind + "_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cells() -> List[str]:
    return sorted(os.path.basename(p)[:-5] for p in
                  glob.glob(os.path.join(BENCH, "workloads", "*.json")))


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def resolve(cell: str, bench: dict) -> Dict[str, object]:
    """Everything a run of ``cell`` reads, loaded."""
    entry = [w for w in bench["workloads"] if w["name"] == cell]
    if not entry:
        raise KeyError(f"{cell} is no cell of BENCHMARK.json")
    wl = data("workloads", cell)
    if wl["config"] != entry[0]["config"]:
        raise ValueError(f"{cell}: BENCHMARK.json and workloads/{cell}.json"
                         " name different configurations")
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell)]
    layer = [m for m in bench["per_layer"] if _applies(m, cell)]
    return dict(
        workload=wl, config=data("configs", wl["config"]),
        chips=int(entry[0]["chips"]),
        driver=module("drivers", wl["driver"]),
        generator=module("traffic", wl["traffic"]["generator"]),
        end_to_end=e2e, per_layer=layer,
        readers={m["name"]: module("metrics", m["name"])
                 for m in e2e + layer})
