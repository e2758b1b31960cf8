"""Module compile report (the entrypoint's ``report`` mode).

The reference's entrypoint (ref scripts/entrypoint.sh, "report" branch)
sets KB_SDK_COMPILE_REPORT_FILE and reruns codegen so the KBase catalog
can inspect what the module exposes. This framework has no codegen step;
the equivalent artifact is produced directly: a JSON document describing
the module, its RPC surface (service/SPEC.md is the source of truth) and
the build environment.

The RPC surface is the JAX package's; ``spec_file`` names this package's
own copy of its spec, service/SPEC.md, shipped as package data; the build
environment is torch's and CUDA's.

Usage: python -m kmergutsjava_tpu_torch.service.compile_report [out.json]
(default honors KMER_COMPILE_REPORT_FILE, else ./work/compile_report.json).
"""
from __future__ import annotations

import json
import os
import sys
from typing import List, Optional

from .. import __version__

RPC_METHODS = [
    {"name": "status", "params": [], "returns": "state/message/version/"
     "git_url/git_commit_hash object (reference servlet payload keys)"},
    {"name": "warm", "params": [], "returns": "num_sigs/max_probe/"
     "probe_window object (table + device planes preloaded)"},
    {"name": "annotate", "params": ["AnnotateParams"], "returns": "report"},
    {"name": "_annotate_submit", "params": ["AnnotateParams"],
     "returns": "job_id (async-job protocol, baseclient-compatible)"},
    {"name": "_check_job", "params": ["job_id"],
     "returns": "{finished, result | error}"},
]


def build_report() -> dict:
    import platform

    spec = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "SPEC.md")
    report = {
        "module_name": "KmerGutsJava",
        "implementation": "kmergutsjava-tpu PyTorch/CUDA port "
                          "(kmergutsjava_tpu_torch)",
        "version": __version__,
        "language": "python (PyTorch) + CUDA C++ kernels (sm_90a) + C++ "
                    "natives",
        "rpc_prefix": "KmerGutsJava.",
        "functions": RPC_METHODS,
        "spec_file": spec if os.path.exists(spec) else None,
        "python": platform.python_version(),
    }
    import torch

    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda  # None in a CPU-only build
    return report


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = (argv[0] if argv else
           os.environ.get("KMER_COMPILE_REPORT_FILE",
                          os.path.join("work", "compile_report.json")))
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(build_report(), f, indent=2)
        f.write("\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
