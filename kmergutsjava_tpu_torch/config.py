"""Typed engine configuration.

One dataclass covering the reference's CLI surface (ref
KmerGutsJava.java:560-654: flags -a -d -m -M -O -g -D -q -o -t -l) plus the
port's extensions: backend selection, probe/chunk sizing and the torch
device. Values the JAX package accepts but this package does not run yet
are rejected with a ValueError that points at ROADMAP.md.
"""
from __future__ import annotations

import tempfile
from dataclasses import dataclass
from typing import Optional

# lookup backends: "auto" (stream vs xla by query density — both are exact,
# so the choice only costs speed), "xla" (the sparse tile-join probe),
# "stream" (the dense stream probe), "pallas" (the merge-join block probe;
# "xla" and "pallas" keep the JAX package's names, so its command lines run
# unchanged) and "parity" (the exact streaming scan). "auto" never picks
# "pallas".
BACKENDS = ("auto", "xla", "stream", "pallas", "parity")
PREPARE_IMPLS = ("native", "numpy")
GROUPING_IMPLS = ("host",)


def not_ported(what: str) -> ValueError:
    return ValueError(f"{what} is not ported to the PyTorch package yet "
                      "(see ROADMAP.md)")


@dataclass
class EngineConfig:
    # reference-equivalent parameters (ref :102-109)
    aa: bool = False
    order_constraint: bool = False
    min_hits: int = 5
    min_weighted_hits: int = 0
    max_gap: int = 200
    debug: bool = False
    input_size_limit: int = 20 * 1000 * 1000  # max query k-mers in RAM
    temp_dir: Optional[str] = None

    # port extensions
    backend: str = "auto"
    # encode implementation for the feeder pipeline: "native" (C++ feeder
    # via ctypes, default; numpy fallback if no toolchain) or "numpy"
    prepare_impl: str = "native"
    # only "host" is ported; the field is kept so that a JAX command line's
    # --grouping scan fails with a pointer to ROADMAP.md
    grouping_impl: str = "host"
    # queries per device dispatch; None = SparseLookup.DEFAULT_CHUNK
    lookup_chunk: Optional[int] = None
    probe_window: Optional[int] = None  # override table-derived window
    profile_dir: Optional[str] = None  # torch.profiler trace output dir
    # torch device of the fingerprint plane and the probe: "cuda" runs the
    # hand-written kernel, "cpu" its plain PyTorch twin
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise not_ported(f"backend {self.backend!r}")
        if self.prepare_impl not in PREPARE_IMPLS:
            raise not_ported(f"prepare implementation {self.prepare_impl!r}")
        if self.grouping_impl not in GROUPING_IMPLS:
            raise not_ported(f"grouping implementation "
                             f"{self.grouping_impl!r}")
        kind = self.device.split(":", 1)[0]
        if kind not in ("cpu", "cuda"):
            raise ValueError(f"unknown device {self.device!r} "
                             "(expected cpu, cuda or cuda:N)")

    def resolved_temp_dir(self) -> str:
        return self.temp_dir if self.temp_dir is not None else tempfile.gettempdir()
