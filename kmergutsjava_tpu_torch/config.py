"""Typed engine configuration.

One dataclass covering the reference's CLI surface (ref
KmerGutsJava.java:560-654: flags -a -d -m -M -O -g -D -q -o -t -l) plus the
port's extensions: backend selection, probe/chunk sizing and its home
sort, call grouping, the mesh and the torch device. An unknown backend,
prepare or grouping is rejected with a ValueError that points at
ROADMAP.md.
"""
from __future__ import annotations

import tempfile
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

# lookup backends: "auto" (stream vs xla by query density — both are exact,
# so the choice only costs speed), "xla" (the sparse tile-join probe),
# "stream" (the dense stream probe), "spmd" (the fused device path: k-mer
# windows and their sparse probe in one kernel), "pallas" (the merge-join
# block probe; "xla", "spmd" and "pallas" keep the JAX package's names, so
# its command lines run unchanged), "parity" (the exact streaming scan) and
# the multi-device lookups over a mesh (parallel/): "replicated" (the plane
# on every data device), "sharded" (slot ranges over the table axis, a sum
# of their answers) and "routed" (each query sent to the shard that owns its
# home). "auto" never picks "spmd" or "pallas"; with a mesh its sparse side
# is "routed".
BACKENDS = ("auto", "xla", "stream", "spmd", "pallas", "parity",
            "replicated", "sharded", "routed")
# "jax" (the JAX package's name) is the device prepare: the k-mer window
# kernel's ragged entry on the config's device
PREPARE_IMPLS = ("native", "numpy", "jax")
# "scan" is the call-grouping kernel (B11, calls/scan_machine.py) on the
# config's device; debug runs and min_hits < 2 keep the host machine
GROUPING_IMPLS = ("host", "scan")


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
    # via ctypes, default; numpy fallback if no toolchain), "numpy", or
    # "jax" (the k-mer window kernel on the device)
    prepare_impl: str = "native"
    # call grouping: "host" (the native machine) or "scan" (the grouping
    # kernel on ``device``)
    grouping_impl: str = "host"
    # queries per device dispatch; None = SparseLookup.DEFAULT_CHUNK
    lookup_chunk: Optional[int] = None
    probe_window: Optional[int] = None  # override table-derived window
    length_bucket_base: int = 256  # smallest padded batch length for aa mode
    profile_dir: Optional[str] = None  # torch.profiler trace output dir
    # home sort of each sparse probe chunk before B1 (None: env
    # KMER_SORT_CHUNKS, else off), on the device with device_sort (None:
    # env KMER_DEVICE_SORT); the JAX package's defaults for its tile-join
    # probe. Reports are the same either way
    sort_chunks: Optional[bool] = None
    device_sort: Optional[bool] = None
    # torch device of the fingerprint plane and the probe: "cuda" runs the
    # hand-written kernel, "cpu" its plain PyTorch twin
    device: str = "cuda"
    mesh_shape: Optional[Tuple[int, int]] = None  # (data, table) shards
    # the devices a mesh takes, in order (the JAX package's make_mesh
    # devices=); None: every CUDA card on "cuda", the one CPU on "cpu". A
    # device may repeat, so that several shards share one card. API only
    # (no CLI flag); each must be of the kind of ``device``
    # (parallel/mesh.py mesh_devices checks it)
    mesh_devices: Optional[Sequence[str]] = None

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
        if self.mesh_shape is not None and (
                len(self.mesh_shape) != 2
                or min(int(x) for x in self.mesh_shape) < 1):
            raise ValueError(f"mesh shape {self.mesh_shape!r} is not two "
                             "positive sizes (data x table)")

    def resolved_temp_dir(self) -> str:
        return self.temp_dir if self.temp_dir is not None else tempfile.gettempdir()
