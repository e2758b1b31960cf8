#!/usr/bin/env python
"""On-card stream-probe microbenchmark: the port of the kernel-bearing parts
of ``scripts/microbench_probe.py`` (``stream_reps``, ``bench_stream`` and
the real-table correctness check).

The whole rep loop runs as one launch of the stream kernel with a leading
repetition grid axis (``stream.stream_probe_reps``), timed with CUDA events
around that launch after a warm-up launch of the same shape. Operands come
from a seeded ``torch.Generator`` on the card, with a match planted in half
the tile cells; the probe's time depends on their contents (cells whose
fingerprint the plane span holds are listed and scanned or looked up). Each row holds its timed
launch's output against the plain twin (``stream_probe_reference``) on the
same operands, so its numbers belong to a launch that was right. The
real-table check holds the stream lookup (the main path's ``stream_probe``
entry) against the parity scan.

    python -m kmergutsjava_tpu_torch.scripts.microbench_probe

prints one JSON line for the card, one for the check and one per
configuration (4M, 64M and 128M slots at reps 64, 16 and 8, w = 16). It
needs a CUDA device and exits 1 without one, or when a check fails. The
original's XLA gather rows (``gather``, ``rows``, ``rows1``) time TPU forms
of the sparse probe that the port replaced with one kernel, and are not
ported.
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from kmergutsjava_tpu_torch.lookup import stream
from kmergutsjava_tpu_torch.lookup.stream import CHANNELS, SLOT_ALIGN

W = 16
# (slots, reps) of the original's stream rows
CONFIGS = ((4_000_000, 64), (64_000_000, 16), (128_000_000, 8))


def card() -> dict:
    """The card's name, power limit and count (nvidia-smi and torch)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return {"device": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi.stdout.strip().splitlines()[:1]}


def random_u16(shape, g: torch.Generator, dev) -> torch.Tensor:
    return torch.randint(-32768, 32768, shape, generator=g, device=dev,
                         dtype=torch.int16).view(torch.uint16)


def stream_operands(n_slots: int, device: str = "cuda"):
    """A random u16 plane of ``n_slots`` (padded to the kernel's block) + W
    slots and random tiles ``[CHANNELS, slots]``, half the cells holding the
    plane value a random offset into their window; seed 1."""
    dev = torch.device(device)
    slots = -(-n_slots // SLOT_ALIGN) * SLOT_ALIGN
    g = torch.Generator(device=dev).manual_seed(1)
    fp = random_u16((slots + W,), g, dev)
    tiles = random_u16((CHANNELS, slots), g, dev).view(torch.int16)
    plane = fp.view(torch.int16)
    base = torch.arange(slots, device=dev)
    for c in range(CHANNELS):  # a row at a time: int64 indices of one row
        at = base + torch.randint(0, W, (slots,), generator=g, device=dev)
        plant = torch.rand(slots, generator=g, device=dev) < 0.5
        tiles[c] = torch.where(plant, plane[at], tiles[c])
    return fp, tiles.view(torch.uint16)


def bench_stream(n_slots: int, reps: int) -> dict:
    """One launch of ``reps`` plane passes over ``n_slots`` (padded to the
    kernel's block) at w = W on the card: seconds by CUDA events,
    slot-channels a second, and the largest difference of that launch's
    output from the twin's."""
    fp, tiles = stream_operands(n_slots)
    slots = tiles.shape[1]
    stream.stream_probe_reps(fp, tiles, W, CHANNELS, reps)  # warm: build, load
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = stream.stream_probe_reps(fp, tiles, W, CHANNELS, reps)
    end.record()
    torch.cuda.synchronize()
    secs = start.elapsed_time(end) / 1000.0
    want = stream.stream_probe_reference(fp, tiles, W, CHANNELS)
    err = int((out.long() - want.long()).abs().max())
    return {"kind": "cuda_stream", "plane_mb": slots * 2 / 2**20, "w": W,
            "slot_channels": slots * CHANNELS, "reps": reps, "secs": secs,
            "slot_channels_per_sec": slots * CHANNELS * reps / secs,
            "max_abs_err": err}


def correctness_on_card(device: str = "cuda") -> dict:
    """Small real table and real queries: the stream lookup on the card (the
    main path's ``stream_probe`` entry, not the repetition entry) against
    the parity scan."""
    from kmergutsjava_tpu_torch.formats.kmer_table import build_table
    from kmergutsjava_tpu_torch.lookup.parity import lookup_stream
    from kmergutsjava_tpu_torch.lookup.stream import StreamLookup

    rng = np.random.default_rng(5)
    kmers = np.unique(rng.integers(0, 20**8, 300_000, dtype=np.int64))
    table = build_table(kmers,
                        rng.integers(0, 100, len(kmers)).astype(np.int32),
                        rng.integers(0, 500, len(kmers)).astype(np.int32),
                        rng.integers(0, 999, len(kmers)).astype(np.int32),
                        rng.random(len(kmers)).astype(np.float32))
    n = 200_000
    values = np.concatenate([rng.choice(kmers, n // 2),
                             rng.integers(0, 20**8, n - n // 2,
                                          dtype=np.int64)])
    cnt = np.arange(n, dtype=np.int64) % 7
    pos = np.arange(n, dtype=np.int64)
    a = lookup_stream(table, values, cnt, pos)
    b = StreamLookup(table, device=device).lookup(values, cnt, pos)

    def rec(h):
        return sorted(zip(h.cnt_id, h.pos, h.fi, h.otu, h.avg_from_end,
                          h.wt))

    ok = rec(a) == rec(b) and a.kmers_found == b.kmers_found
    return {"kind": "stream_correctness_gpu", "hits": len(b), "ok": bool(ok)}


def main() -> int:
    if not torch.cuda.is_available():
        print("microbench_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    print(json.dumps(card()), flush=True)
    check = correctness_on_card()
    print(json.dumps(check), flush=True)
    if not check["ok"]:
        return 1
    for n_slots, reps in CONFIGS:
        row = bench_stream(n_slots, reps)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()  # drop this config's operands
        if row["max_abs_err"] != 0:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
