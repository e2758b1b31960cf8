"""A cell, a configuration and a metric are added by adding files: run.py
lists and resolves them with no edit to a file under portbench/."""
import json
import os
import shutil
import subprocess
import sys

from .conftest import ROOT, with_parked


def _copy(tmp_path):
    dst = tmp_path / "checkout"
    dst.mkdir()
    shutil.copytree(os.path.join(ROOT, "portbench"), dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    return dst


def _listing(checkout):
    out = subprocess.run([sys.executable, str(checkout / "portbench" /
                                               "run.py"), "--list"],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(checkout))
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_new_files_make_a_new_cell(tmp_path):
    """Served proteomes on a 48M-signature table: a configuration, a cell
    and a metric added as files, and their entries in BENCHMARK.json."""
    checkout = _copy(tmp_path)
    before = {str(p): p.read_bytes() for p in
              (checkout / "portbench").rglob("*") if p.is_file()}
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    config = json.loads((checkout / "portbench" / "configs" /
                         "ecoli-aa-t24m.json").read_text())
    config["table"]["total_signatures"] = 48_000_000
    (checkout / "portbench" / "configs" / "ecoli-aa-t48m.json").write_text(
        json.dumps(config))
    workload = json.loads((checkout / "portbench" / "workloads" /
                           "dna-genomes-served.json").read_text())
    workload["config"] = "ecoli-aa-t48m"
    workload["traffic"] = {"name": "proteomes-1k-6k",
                           "generator": "proteomes", "proteins_min": 1000,
                           "proteins_max": 6000, "substitution_rate": 0.01,
                           "pool": 64, "as": "text"}
    (checkout / "portbench" / "workloads" /
     "aa-genomes-served-t48m.json").write_text(json.dumps(workload))
    (checkout / "portbench" / "metrics" / "service.requests.aa48.py"
     ).write_text('"""Requests in the window."""\n\n\ndef read(run):\n'
                  '    return float(len(run.done))\n')
    bench["configs"].append(dict(bench["configs"][0], name="ecoli-aa-t48m",
                                 file="portbench/configs/ecoli-aa-t48m.json"))
    bench["workloads"].append(dict(bench["workloads"][0],
                                   name="aa-genomes-served-t48m",
                                   config="ecoli-aa-t48m",
                                   traffic="proteomes-1k-6k"))
    bench["per_layer"].append(dict(bench["per_layer"][0],
                                   name="service.requests.aa48", unit="1",
                                   moves="kmers_per_s",
                                   workloads=["aa-genomes-served-t48m"]))
    for m in bench["end_to_end"]:
        if m["name"] == "kmers_per_s":
            m["workloads"].append("aa-genomes-served-t48m")
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    listed = _listing(checkout)
    line = [ln for ln in listed.splitlines()
            if ln.startswith("aa-genomes-served-t48m:")]
    assert line and "config=ecoli-aa-t48m" in line[0]
    assert "driver=served" in line[0] and "generator=proteomes" in line[0]
    assert "per_layer=service.requests.aa48" in line[0]
    assert "end_to_end=kmers_per_s,setup_s" in line[0]
    for path, data in before.items():  # nothing already there was edited
        assert open(path, "rb").read() == data


def test_every_registered_cell_resolves():
    from portbench.core import registry

    bench = with_parked(registry.benchmark())
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names)
    assert sorted(names) == registry.cells()
    for cell in registry.cells():
        got = registry.resolve(cell, bench)
        assert got["end_to_end"] and got["per_layer"]
        assert "setup_s" in {m["name"] for m in got["end_to_end"]}


def test_no_cuda_no_result():
    """Without a card the run exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, os.path.join(ROOT, "portbench",
                                                        "run.py"),
                          "--workload", "dna-readsets-batch", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/ the run
    exits non-zero and prints no result."""
    checkout = _copy(tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "dna-readsets-batch", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=str(checkout),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_parked_cell_does_not_run(tmp_path):
    """A cell kept out of BENCHMARK.json is listed as not runnable."""
    listed = _listing(_copy(tmp_path))
    assert "dna-genomes-served: not runnable" in listed
