"""Published peaks of the card, and the work of a cell's probe.

NVIDIA H100 SXM (data sheet, 700 W): 3.35 TB/s of HBM3. The card's power
limit is printed beside every run (``harness.card``); a card set below
700 W runs slower under load.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def probe_bytes(n: int, slots: int) -> int:
    """The least bytes a probe of ``n`` query 8-mers against a plane of
    ``slots`` slots moves: 8 B read and 4 B written a query, and the
    plane's sectors the windows touch, at most the whole u16 plane."""
    return 12 * n + min(2 * slots, 32 * n)


def probe_ops(n: int, slots: int) -> int:
    """One operation a query and a plane slot read (as chip_smoke.py's
    bound_window_probe counts them). No integer peak is published, so no
    bound is taken from it; at these counts bytes bound the probe by far."""
    return n + min(slots, 16 * n)
