"""Checkpoint/resume for long annotation runs.

The reference engine is one monolithic pass (KmerGutsJava.java:742-819):
a crash 10 hours into a metagenome sweep loses everything. This module
adds exact, restartable execution with no engine changes, exploiting a
property of the report grammar: every report line belongs to exactly one
query sequence (PROTEIN-ID/processed-seq header, CALL/OTU-COUNTS lines —
ref :398-404, :516-522), and the grouping state machine carries no state
across sequences. Concatenating per-batch reports therefore reproduces
the single-run report byte-for-byte in non-debug mode (debug mode writes
per-RUN info lines into the report, so checkpointing refuses it) —
PROVIDED no sequence id spans a batch boundary: phase 3 walks containers
grouped by id, so same-id sequences print at the id's FIRST occurrence
with the LAST occurrence's length/containers (ref :805-818; LinkedHashMap
put semantics), which batches cannot reproduce across a boundary. A
pre-scan therefore maps every duplicated id to its last occurrence and
the batcher defers each commit until no id seen so far recurs later —
all occurrences of an id share a batch, inside which the ordinary Engine
reproduces the single-run grouping exactly (found by scripts/soak.py
seed 253355989, which now byte-verifies checkpointed duplicate runs).

Mechanism:

- the input FASTA splits into raw line groups at every line whose
  Java-trimmed form starts with ``>`` — the exact boundary rule of the
  reference parser (readFasta, ref :1132-1192; see formats/fasta.py).
  Groups are never re-serialized: the original lines (terminators
  included) feed the engine unchanged, so every parser quirk (short-line
  skips, raw-line appends, caption errors) behaves as in a single run.
- groups are batched (``--checkpoint-every``, default 100k) and each
  batch runs through the ordinary Engine, appending to the output file.
- after each batch: flush + fsync the output, then atomically replace
  the checkpoint sidecar (JSON: input identity, a config signature,
  groups done, committed output byte offset, and a running digest of
  every input line consumed so far).
- on restart with the same checkpoint path: the sidecar is validated
  against the input file and config, the output is truncated to the last
  committed offset (discarding any torn tail from the crash), the first
  ``groups_done`` groups are skipped — re-hashing them and comparing to
  the sidecar's prefix digest, so ANY in-place edit of the already-
  committed region is caught exactly (the whole-file identity check is
  sampled above _FULL_HASH_MAX bytes) — and the run continues.

This is the JAX package's module run on this package's Engine. The
sidecar's version, fields and config signature are the same, so a run
started by either package resumes in the other. A KernelError in a batch
is not a CheckpointError: it propagates, and the sidecar stays at the
last committed batch.
"""
from __future__ import annotations

import io
import json
import os
from typing import Iterator, List, Optional, TextIO

from ..config import EngineConfig
from ..formats.fasta import _java_trim, open_text_maybe_gz

CKPT_VERSION = 2  # v2: full-hash identity for small inputs + prefix digest
DEFAULT_BATCH_GROUPS = 100_000
# Inputs up to this size get a FULL content hash (a few hundred ms of IO);
# larger ones fall back to the sampled fingerprint, where the committed
# prefix is still covered exactly by the running prefix digest.
_FULL_HASH_MAX = 256 << 20


class CheckpointError(ValueError):
    pass


def _config_signature(cfg: EngineConfig, data_dir: str) -> str:
    """Everything that shapes report bytes. Backend/impl knobs and the
    torch device are EXCLUDED on purpose: all backends and devices are
    byte-identical (the parity contract), so a resume may legitimately
    switch e.g. xla -> stream, or cuda -> cpu. The fields are named, not
    taken from the dataclass, so the signature equals the JAX package's."""
    from ..formats.kmer_table import resolve_table_files

    table_path, func_path = resolve_table_files(data_dir)

    def ident(p):
        try:
            return [os.path.realpath(p), os.path.getsize(p)]
        except OSError:
            return [p, None]

    sig = {
        "aa": cfg.aa,
        "min_hits": cfg.min_hits,
        "min_weighted_hits": cfg.min_weighted_hits,
        "max_gap": cfg.max_gap,
        "order_constraint": cfg.order_constraint,
        "table": ident(table_path),
        "functions": ident(func_path),
    }
    return json.dumps(sig, sort_keys=True)


def _input_identity(path: str) -> dict:
    """Size + content hash. Full sha256 up to _FULL_HASH_MAX; above that,
    a sampled fingerprint (head, tail, and 8 strided 1 MB interior blocks
    — <=10 MB read however large the input; a size-preserving edit between
    samples is then caught by the resume-time prefix digest instead, for
    the committed region). mtime is deliberately NOT used: restoring the
    same bytes from a backup or re-copying the input must not strand a
    resumable run."""
    import hashlib

    size = os.path.getsize(path)
    h = hashlib.sha256()
    block = 1 << 20
    if size <= _FULL_HASH_MAX:
        with open(path, "rb") as fh:
            while True:
                chunk = fh.read(block)
                if not chunk:
                    break
                h.update(chunk)
        return {"path": os.path.realpath(path), "size": size,
                "sha256": h.hexdigest()}
    offsets = {0, max(0, size - block)}
    for i in range(1, 9):
        offsets.add((size * i // 9) // block * block)
    with open(path, "rb") as fh:
        for off in sorted(offsets):
            fh.seek(off)
            h.update(fh.read(block))
    return {"path": os.path.realpath(path), "size": size,
            "sample_sha256": h.hexdigest()}


def iter_groups(stream: TextIO) -> Iterator[List[str]]:
    """Raw line groups, split at every line whose Java-trimmed form starts
    with '>'. Lines before the first such boundary (skipped or rejected by
    the parser while seeking a caption) ride with the first group so the
    parser sees them in the same seeking state as in a single run."""
    group: List[str] = []
    started = False  # current group contains a '>' boundary line
    for line in stream:
        if _java_trim(line).startswith(">"):
            if started:
                yield group
                group = []
            started = True
        group.append(line)
    if group:
        yield group


def _group_id(group: List[str]) -> Optional[str]:
    """The sequence id the reference parser would assign this group: first
    whitespace token after '>' of the group's boundary caption line (see
    formats/fasta.py); None when the group has no usable caption (bare
    '>' — the parser skips it while seeking)."""
    for line in group:
        t = _java_trim(line)
        if t.startswith(">"):
            toks = t[1:].split()
            return toks[0] if toks else None
    return None


def _id_digest(gid: str) -> bytes:
    import hashlib

    return hashlib.blake2b(gid.encode("utf-8", "surrogateescape"),
                           digest_size=8).digest()


def _scan_duplicate_spans(query_path: str) -> dict:
    """Pre-scan: map each DUPLICATED sequence id (8-byte blake2b digest)
    to the group index of its LAST occurrence.

    Why: the report is NOT emitted in input order when ids repeat — phase
    3 iterates containers grouped BY ID, so every same-id sequence prints
    at the id's first occurrence with the LAST occurrence's length and
    containers (reference KmerGutsJava.java:805-818: LinkedHashMap
    ``queryIdToLen.put`` keeps first position / last value, and the
    ``hitCnts.put`` overwrite keeps the last container per key; caught by
    scripts/soak.py seed 253355989). Batched execution reproduces that iff
    all occurrences of an id share one batch, so the batcher holds a batch
    open until no id it contains recurs later. Only duplicated ids are
    kept (unique ids impose no constraint), bounding memory to the
    duplicate count; a digest collision can only merge two batches
    unnecessarily, never produce a wrong report."""
    first: dict = {}
    dup_last: dict = {}
    with open_text_maybe_gz(query_path) as qf:
        for idx, group in enumerate(iter_groups(qf)):
            gid = _group_id(group)
            if gid is None:
                continue
            d = _id_digest(gid)
            if d in first:
                dup_last[d] = idx
            else:
                first[d] = idx
    return dup_last


def _write_checkpoint(ckpt_path: str, state: dict) -> None:
    tmp = ckpt_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(state, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, ckpt_path)
    # fsync the directory so the rename itself survives a power cut
    dfd = os.open(os.path.dirname(os.path.abspath(ckpt_path)) or ".",
                  os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _load_checkpoint(ckpt_path: str, input_id: dict, cfg_sig: str,
                     output_path: str) -> Optional[dict]:
    if not os.path.exists(ckpt_path):
        return None
    with open(ckpt_path) as fh:
        state = json.load(fh)
    if state.get("version") != CKPT_VERSION:
        raise CheckpointError(
            f"checkpoint {ckpt_path} has version {state.get('version')}, "
            f"this build writes {CKPT_VERSION}")
    if state.get("input") != input_id:
        raise CheckpointError(
            f"checkpoint {ckpt_path} was written for a different input "
            f"file ({state.get('input')} != {input_id}); delete it to "
            "start over")
    if state.get("config_sig") != cfg_sig:
        raise CheckpointError(
            f"checkpoint {ckpt_path} was written with different parameters; "
            "delete it to start over")
    if not os.path.exists(output_path):
        raise CheckpointError(
            f"checkpoint {ckpt_path} exists but output {output_path} does "
            "not; delete the checkpoint to start over")
    if os.path.getsize(output_path) < state["out_offset"]:
        raise CheckpointError(
            f"output {output_path} is shorter ({os.path.getsize(output_path)}"
            f" B) than the checkpoint's committed offset "
            f"({state['out_offset']} B); delete the checkpoint to start over")
    return state


def run_with_checkpoint(cfg: EngineConfig, data_dir: str, query_path: str,
                        output_path: str, ckpt_path: str,
                        batch_groups: int = DEFAULT_BATCH_GROUPS,
                        progress: bool = True) -> int:
    """Run the annotation restartably. Returns the number of sequence
    groups processed in THIS invocation (0 when already complete)."""
    from .pipeline import Engine

    if cfg.debug:
        raise CheckpointError(
            "checkpoint mode requires non-debug output (-d writes per-run "
            "info lines into the report, which would differ from a single "
            "run)")
    if batch_groups < 1:
        raise CheckpointError("--checkpoint-every must be >= 1")
    input_id = _input_identity(query_path)
    cfg_sig = _config_signature(cfg, data_dir)
    # duplicate-id pre-scan BEFORE any batch runs: one extra parse pass of
    # the input (annotation dominates it) that tells the batcher which
    # group spans must not be split.
    dup_last = _scan_duplicate_spans(query_path)
    state = _load_checkpoint(ckpt_path, input_id, cfg_sig, output_path)
    groups_done = 0
    out_offset = 0
    if state is not None:
        groups_done, out_offset = state["groups_done"], state["out_offset"]
        if state.get("complete"):
            if progress:
                print(f"checkpoint: {ckpt_path} is complete "
                      f"({groups_done} groups); nothing to do")
            return 0

    # binary file + explicit TextIOWrapper: wrapper.flush() pushes text to
    # the raw file, whose tell() is then a true byte offset for truncate()
    mode = "r+b" if (state is not None and os.path.exists(output_path)) \
        else "wb"
    raw = open(output_path, mode)
    done_this_run = 0
    try:
        raw.truncate(out_offset)  # drop any torn tail past the last commit
        raw.seek(out_offset)
        # utf-8 to match the plain CLI's open(output, "w") byte-for-byte
        out = io.TextIOWrapper(raw, encoding="utf-8", newline="")
        engine = Engine(cfg)
        import hashlib

        # Running digest of every input line consumed (committed batches
        # only — updated as lines are read, persisted at each commit).
        # On resume it re-covers the skipped prefix exactly, so in-place
        # edits of already-committed input are caught even when the
        # whole-file identity above is only sampled (large inputs).
        prefix_h = hashlib.blake2b(digest_size=16)
        with open_text_maybe_gz(query_path) as qf:
            groups = iter_groups(qf)
            skipped = 0
            while skipped < groups_done:
                g = next(groups, None)
                if g is None:
                    raise CheckpointError(
                        f"checkpoint says {groups_done} groups are done but "
                        f"the input has only {skipped}; was the input file "
                        "changed in place?")
                for line in g:
                    prefix_h.update(line.encode("utf-8", "surrogateescape"))
                skipped += 1
            if state is not None:
                want = state.get("prefix_blake2b")
                if want is not None and want != prefix_h.hexdigest():
                    raise CheckpointError(
                        f"the first {groups_done} sequence groups of "
                        f"{query_path} no longer match the bytes the "
                        "checkpoint committed (in-place edit of the input?); "
                        "delete the checkpoint to start over")
            next_idx = groups_done  # input index of the next group to read
            # furthest last-occurrence index among duplicated ids seen so
            # far; a batch may only close once the input position has
            # passed it (all occurrences of every id share one batch —
            # the single-run first-occurrence grouping then reproduces
            # inside the batch; see _scan_duplicate_spans)
            open_span = -1
            while True:
                batch: List[str] = []
                n_groups = 0
                for group in groups:
                    batch.extend(group)
                    for line in group:
                        prefix_h.update(
                            line.encode("utf-8", "surrogateescape"))
                    if dup_last:
                        gid = _group_id(group)
                        if gid is not None:
                            last = dup_last.get(_id_digest(gid), -1)
                            if last > open_span:
                                open_span = last
                    n_groups += 1
                    next_idx += 1
                    if n_groups >= batch_groups and open_span < next_idx:
                        break
                if n_groups == 0:
                    break
                engine.run(data_dir, None, out, stdout=False,
                           query_stream=io.StringIO("".join(batch)))
                out.flush()
                os.fsync(raw.fileno())
                groups_done += n_groups
                done_this_run += n_groups
                out_offset = raw.tell()
                _write_checkpoint(ckpt_path, {
                    "version": CKPT_VERSION, "input": input_id,
                    "config_sig": cfg_sig, "groups_done": groups_done,
                    "out_offset": out_offset,
                    "prefix_blake2b": prefix_h.hexdigest(),
                    "complete": False})
                if progress:
                    print(f"checkpoint: {groups_done} groups committed "
                          f"({out_offset} B)")
        _write_checkpoint(ckpt_path, {
            "version": CKPT_VERSION, "input": input_id,
            "config_sig": cfg_sig, "groups_done": groups_done,
            "out_offset": out_offset,
            "prefix_blake2b": prefix_h.hexdigest(), "complete": True})
    finally:
        raw.close()
    return done_this_run
