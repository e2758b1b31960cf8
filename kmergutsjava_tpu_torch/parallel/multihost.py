"""Multi-process runs (the counterpart of the JAX package's
``parallel/multihost.py``).

The reference is a single JVM with no distribution story; the port's
multi-process path is:

- ``initialize_distributed`` per process: ``torch.distributed`` with the
  coordinator's address, the world size and the rank given explicitly, and
  the backend the caller names (NCCL for one rank a card, gloo for CPU
  ranks or for ranks that share a card);
- a mesh over the processes (``parallel/mesh.py`` ``make_mesh(...,
  distributed=True)``), whose collectives take their process-group form, so
  that the sharded, routed, stream-shard and sharded sparse-probe lookups
  and the fused step (``models/spmd.py`` ``SpmdProgram(..., mesh=)``) span
  processes and every rank gets the whole answer (the replicated lookup
  refuses such a mesh: the JAX package's cannot read its answer across
  processes either);
- input sharding at the FASTA level: each process parses only its share of
  the records (round-robin by record index, ``shard_records``); hit
  containers stay where they were parsed, so grouping and report emission
  need no collective: each process writes its own report shard, and
  ``merge_report_shards`` interleaves the shards back into record order,
  byte for byte the single run's report.

``shard_records``, ``split_report_blocks`` and ``merge_report_shards`` are
framework-free copies of the JAX module's, with its errors.
"""
from __future__ import annotations

import datetime
from typing import Iterable, Iterator, Optional

from ..formats.fasta import FastaRecord

BACKENDS = ("gloo", "nccl")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = 300.0) -> None:
    """Bring up ``torch.distributed`` (a no-op for a single process, as
    the JAX function is): ``init_process_group`` at
    ``tcp://<coordinator_address>`` (``host:port``) with the world size
    ``num_processes``, the rank ``process_id``, the caller's ``backend``
    ("gloo" or "nccl"; nothing picks one) and a timeout for every
    collective. Raises ValueError on a missing or unknown argument."""
    if num_processes is None or num_processes <= 1:
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: name one of {BACKENDS} "
                         "(NCCL for one rank a card, gloo for CPU ranks or "
                         "ranks that share a card)")
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator's "
                         "address and this process's rank")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"rank {process_id} is not in [0, "
                         f"{num_processes})")
    import torch.distributed as dist

    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def shard_records(records: Iterable[FastaRecord], process_id: int,
                  num_processes: int) -> Iterator[FastaRecord]:
    """Round-robin record assignment: host p takes records i with
    i % num_processes == p. Deterministic, order-preserving per host, and
    balanced for corpora of many records.

    Precondition for report parity: sequence ids must be unique across
    the corpus. The reference groups same-id sequences at the id's FIRST
    occurrence with the LAST occurrence's containers
    (KmerGutsJava.java:805-818), which record-level sharding cannot
    reproduce once occurrences land on different hosts (single-host runs
    and checkpointed runs both handle duplicates; see
    models/checkpoint.py)."""
    for i, rec in enumerate(records):
        if i % num_processes == process_id:
            yield rec


# Every non-debug report line belongs to exactly one record's block, and
# each block starts with exactly one of these (the reference output
# grammar): "PROTEIN-ID\t<id>\t<len>" opens an aa record
# (KmerGutsJava.java:529), "processing <id>[<len>]" opens a DNA record
# (:541); all other lines (TRANSLATION :545-548, CALL :398-404,
# OTU-COUNTS :516-522) continue the current block. Timing/progress lines
# only enter the report in debug mode (printInfoLine :891-898), which the
# multi-host path refuses like checkpointing does.
_BLOCK_HEADS = ("PROTEIN-ID\t", "processing ")


def split_report_blocks(report: str) -> list:
    """Split a NON-DEBUG report into its per-record blocks, in order.

    Raises ValueError on content before the first block head (debug info
    lines, or a report produced with debug=True) — merging such text
    would silently misplace lines."""
    blocks: list = []
    cur: Optional[list] = None
    for line in report.splitlines(keepends=True):
        if line.startswith(_BLOCK_HEADS):
            if cur is not None:
                blocks.append("".join(cur))
            cur = [line]
        elif cur is None:
            raise ValueError(
                "report text before the first record block (debug-mode "
                f"report?): {line[:80]!r}")
        else:
            cur.append(line)
    if cur is not None:
        blocks.append("".join(cur))
    return blocks


def merge_report_shards(shard_reports) -> str:
    """Interleave per-host report shards back into reference record order.

    ``shard_reports[p]`` must be the report text host ``p`` produced over
    its ``shard_records(records, p, P)`` share. Because round-robin
    assignment is order-preserving per host, global record k is block
    k // P of shard k % P; the merged text is byte-identical to a
    single-process run over the whole corpus (given the unique-id
    precondition of shard_records)."""
    per = [split_report_blocks(t) for t in shard_reports]
    nproc = len(per)
    total = sum(len(b) for b in per)
    out = []
    for k in range(total):
        shard = per[k % nproc]
        i = k // nproc
        if i >= len(shard):
            raise ValueError(
                f"shard {k % nproc} has only {len(shard)} blocks but "
                f"global record {k} maps to its block {i}: shards are not "
                "a round-robin partition of one corpus")
        out.append(shard[i])
    return "".join(out)
