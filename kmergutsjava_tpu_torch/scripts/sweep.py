#!/usr/bin/env python
"""On-card sweep harness: the port of the ``tjgather`` section of
``scripts/sweep.py``, the lane-gather tile-join experiment (the CUDA kernel
``csrc/tjgather.cu`` behind ``lookup/tjgather.tjgather_probe``).

Measurement rules, kept from the original:

1. **Synchronize before reading the clock.** CUDA events around the rep
   loop, then ``torch.cuda.synchronize``.
2. **Marginal two-point fit.** Rate = d(work)/d(time) between ``r`` and
   ``4r`` reps (the best of 2 runs each, after a warm-up at the same rep
   count), so the fixed cost of starting a loop drops out.
3. **Per-rep input variation.** Rep ``i`` probes packed variant
   ``i % SWEEP_NB``.
4. **Device-generated inputs.** A seeded ``torch.Generator`` on the card;
   correctness is pinned by the tests and ``chip_smoke.py``, not here.

    python -m kmergutsjava_tpu_torch.scripts.sweep [tjgather]

Env: SWEEP_PLANE_MB (default 512), SWEEP_TJG_CAPS (default "256,512"),
SWEEP_NB (default 4), SWEEP_REPS (default 20). Prints the card, one line per
case as it finishes, and one JSON line at the end. Needs a CUDA device and
exits 1 without one. The original's other sections (``tilejoin``,
``sparse``, ``stream``) time TPU forms of the probes that the port replaced
with one kernel each, and are not ported (ROADMAP.md); asked for one, it
exits 2.
"""
from __future__ import annotations

import json
import os
import sys

import torch

from kmergutsjava_tpu_torch.lookup import tjgather
from kmergutsjava_tpu_torch.lookup.tjgather import TILE, TPG, W
from kmergutsjava_tpu_torch.scripts.microbench_probe import card

NOT_PORTED = ("tilejoin", "sparse", "stream")


def settings() -> dict:
    """The section's knobs from the environment, read at call time."""
    return dict(
        plane_mb=float(os.environ.get("SWEEP_PLANE_MB", 512)),
        caps=[int(c) for c in
              os.environ.get("SWEEP_TJG_CAPS", "256,512").split(",")],
        nb=int(os.environ.get("SWEEP_NB", 4)),
        reps=int(os.environ.get("SWEEP_REPS", 20)))


def plane_tiles(plane_mb: float) -> int:
    return int(plane_mb * 2**20) // (TILE * TILE * 2)


def make_plane(tiles: int, device, seed: int = 7):
    """Random u16 plane tiles ``[tiles, 128, 128]`` and the sequential
    super-tile ids ``arange(tiles // TPG)``."""
    g = torch.Generator(device=device).manual_seed(seed)
    plane3 = torch.randint(-32768, 32768, (tiles, TILE, TILE), generator=g,
                           device=device, dtype=torch.int16).view(
        torch.uint16)
    return plane3, torch.arange(tiles // TPG, dtype=torch.int32,
                                device=device)


def make_packed(nsup: int, cap: int, nb: int, device, seed: int = 8
                ) -> torch.Tensor:
    """``nb`` variants of packed cells ``[nb, nsup, TPG, cap/128, 128]``
    (``qfp << 14 | row << 7 | off``, off < 128 - W) from random 32-bit
    fields, as the original builds them."""
    g = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(0, 2**32, (nb, nsup, TPG, cap // TILE, TILE),
                         generator=g, device=device, dtype=torch.int64)
    return (((bits >> 16) << 14) | (((bits >> 9) & 127) << 7)
            | (bits % (TILE - W))).to(torch.int32)


def timed(run, r: int, device) -> float:
    """Best of 2 runs of ``run(r)`` in seconds by CUDA events, after a
    warm-up at the same rep count."""
    run(r)
    torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(r)
        end.record()
        torch.cuda.synchronize(device)
        best = min(best, start.elapsed_time(end) / 1000.0)
    return best


def measure(name: str, work_per_rep: int, run, reps: int, device) -> dict:
    """The marginal two-point rate between ``reps`` and ``4 * reps``."""
    r1, r2 = reps, 4 * reps
    t1, t2 = timed(run, r1, device), timed(run, r2, device)
    dt = max(t2 - t1, 1e-9)
    rate = work_per_rep * (r2 - r1) / dt
    print(f"{name}: {rate / 1e6:.1f}M/s  (t1={t1:.4f}s t2={t2:.4f}s, "
          f"work/rep={work_per_rep}, ms/rep={dt / (r2 - r1) * 1e3:.4f})",
          flush=True)
    return {name: rate, f"{name}_ms_per_rep": dt / (r2 - r1) * 1e3}


def section_tjgather(device="cuda") -> dict:
    """The lane-gather probe over a ``SWEEP_PLANE_MB`` plane, all super-tiles
    in order, at each cap of ``SWEEP_TJG_CAPS``. Work is counted in cells
    (tiles x cap)."""
    dev = torch.device(device)
    cfg = settings()
    tiles = plane_tiles(cfg["plane_mb"])
    plane3, ids = make_plane(tiles, dev)
    out = {}
    for cap in cfg["caps"]:
        pk_nb = make_packed(ids.numel(), cap, cfg["nb"], dev)

        def run(r, pk_nb=pk_nb):
            for i in range(r):
                tjgather.tjgather_probe(plane3, ids, pk_nb[i % cfg["nb"]])

        out.update(measure(f"tjgather_{int(cfg['plane_mb'])}mb_cap{cap}",
                           tiles * cap, run, cfg["reps"], dev))
        del pk_nb
        torch.cuda.empty_cache()  # drop this cap's operands
    return out


def main(argv=None) -> int:
    names = list(sys.argv[1:] if argv is None else argv)
    if names not in ([], ["tjgather"]):
        if set(names) & set(NOT_PORTED):
            print(f"sections {sorted(set(names) & set(NOT_PORTED))} time TPU "
                  "forms that the port replaced; they are not ported (see "
                  "ROADMAP.md)", file=sys.stderr)
        else:
            print(f"unknown sections {names}; the port has 'tjgather'",
                  file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("sweep: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(json.dumps(card()), flush=True)
    print("=== section tjgather ===", flush=True)
    print(json.dumps(section_tjgather()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
