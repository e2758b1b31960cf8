"""Long records cut into overlapping windows for the fused step (the
counterpart of the JAX package's ``parallel/seq_windows.py``), on one
device or over a mesh's data axis.

The fused step pads each record to its batch's length bucket, so one very
long contig or protein would make a bucket of its own; instead it is cut
into fixed-size windows that overlap by one 8-mer (24 bases, or 7 amino
acids), the windows go through the step as rows, and each hit maps back to
its exact global container and position. The plans are numpy copies of the
JAX package's, whose exactness argument holds unchanged:

- windows start at multiples of 3, so window-local forward frame f IS
  global frame f shifted by start/3 codons;
- window [s, e) of the contig is slice [L-e, L-s) of the global reverse
  complement, so window-local reverse frame (f - (L-e)) mod 3 is global
  reverse frame f shifted by (L - e + f' - f)/3 codons;
- every global 8-mer occupies 24 bases of its strand; the window whose
  stride bucket holds the 8-mer's lowest base OWNS it (the last window
  owns its tail), and the >= 24-base overlap puts all 24 bases in the
  owner, so each global 8-mer is emitted exactly once;
- DNA frames have no skip-last-window quirk, so local validity is global
  validity; aa windows carry the quirk in their start counts.

On the device the fused kernel takes each window's ``row_map``,
``own_start`` and ``own_end`` (``parallel/fused_probe.py``): container g of
a window reads local frame row_map[g] and is valid on its owned interval.
On a mesh the windows are rows of the mesh step
(``annotate_step.mesh_step``): split over the data axis, probed in B12's
form on every table shard.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from ..constants import K
from ..formats.kmer_table import KmerTable
from ..ops.hostvalues import aa_values_at, dna_values_at
from . import fused_probe
from .annotate_step import candidates, mesh_step
from .mesh import Mesh, upload
from .sharded_lookup import gather_hit_metadata

OVERLAP_NT = 3 * K  # one aa 8-mer spans 24 bases of its strand
_BIG = np.int32(2 ** 30)


def plan_windows(length: int, win_nt: int) -> dict:
    """Host-side plan for one contig: window byte ranges plus, per
    (window, global container g in +0+1+2-0-1-2 order), the local frame
    row, the global codon offset, and the owned local-window interval.

    Returns numpy arrays: s/e/len_w [n_win]; row_map/j0/own_start/own_end
    [n_win, 6] (own_end exclusive; empty intervals where a window owns
    nothing in a frame).
    """
    if win_nt % 3 or win_nt <= OVERLAP_NT:
        raise ValueError("win_nt must be a multiple of 3 greater than 24")
    L = int(length)
    stride = win_nt - OVERLAP_NT
    n_win = max(L - OVERLAP_NT, 0) // stride + 1
    s = np.arange(n_win, dtype=np.int64) * stride
    e = np.minimum(s + win_nt, L)
    row_map = np.zeros((n_win, 6), np.int32)
    j0 = np.zeros((n_win, 6), np.int64)
    own_start = np.zeros((n_win, 6), np.int64)
    own_end = np.zeros((n_win, 6), np.int64)
    last = n_win - 1
    for f in range(3):
        # forward: local frame f == global frame f at codon offset s/3
        row_map[:, f] = f
        j0[:, f] = s // 3
        # owned anchors a = s + f + 3j'' with a in [s, s+stride)
        own_end[:, f] = (stride - f + 2) // 3
        own_end[last, f] = _BIG  # the tail has no next window
        # reverse: window [s,e) == global revComp slice [L-e, L-s)
        g = 3 + f
        fp = (f - (L - e)) % 3
        row_map[:, g] = 3 + fp
        j0[:, g] = (L - e + fp - f) // 3
        # owned anchors a = L - f - 3*(j0+j'') - 24 in [s, s+stride)
        t = L - f - 3 * j0[:, g] - OVERLAP_NT - s
        own_end[:, g] = t // 3 + 1
        own_start[:, g] = (t - stride) // 3 + 1
        own_start[last, g] = 0  # the tail (smallest j'') has no next window
    np.clip(own_start, 0, None, out=own_start)
    np.clip(own_end, 0, None, out=own_end)
    return {"s": s, "e": e, "len_w": e - s, "stride": stride,
            "row_map": row_map, "j0": j0,
            "own_start": own_start, "own_end": own_end}


OVERLAP_AA = K - 1  # aa-mode window overlap: 7 aa


def plan_aa_windows(length: int, win_aa: int) -> dict:
    """Window plan for one PROTEIN: aa windows overlapping by K-1 = 7, so
    every global 8-aa window lies whole in exactly one owner window. The
    reference's ``i < len - K`` bound (ref :912; the final full window of a
    protein is SKIPPED, a parity quirk) becomes a per-window start count:
    num_starts[w] = clamp(L - K - s_w, 0, stride) with the last window
    unclamped above."""
    if win_aa <= OVERLAP_AA:
        raise ValueError("win_aa must be greater than 7")
    L = int(length)
    stride = win_aa - OVERLAP_AA  # == win_aa - K + 1 = local start capacity
    n_win = max(L - K - 1, 0) // stride + 1  # anchors i in [0, L-K-1]
    s = np.arange(n_win, dtype=np.int64) * stride
    e = np.minimum(s + win_aa, L)
    num_starts = np.maximum(L - K - s, 0)
    num_starts[:-1] = np.minimum(num_starts[:-1], stride)
    return {"s": s, "e": e, "len_w": e - s, "stride": stride,
            "num_starts": num_starts}


def make_windowed_dna_step(table: KmerTable, probe_window: int, win_nt: int,
                           planes: dict) -> Tuple[Callable, dict]:
    """The windowed DNA step on ``planes`` (the program's plane, shared
    with its whole-contig step): step(fp, ascii_u8[W, win_nt], len_w[W],
    row_map[W, 6], own_start[W, 6], own_end[W, 6]) (host arrays) -> (B1's
    answer on the device, its window shape [W, 6, win_nt//3 - 7])."""
    if win_nt % 3:
        raise ValueError("win_nt must be a multiple of 3")

    def step(fp, ascii_u8, len_w, row_map, own_start, own_end):
        a, lens, rm, os_, oe = upload(
            fp.device, ascii_u8,
            *(np.asarray(x).astype(np.int32)
              for x in (len_w, row_map, own_start, own_end)))
        w = max(win_nt // 3 - K + 1, 0)
        return (fused_probe.first_event(fp, a, lens, False, table.num_sigs,
                                        probe_window, rm, os_, oe),
                (ascii_u8.shape[0], 6, w))

    return step, planes


def make_sharded_windowed_dna_step(mesh: Mesh, table: KmerTable,
                                   probe_window: int, win_nt: int,
                                   planes: dict) -> Tuple[Callable, dict]:
    """The windowed DNA step over ``mesh`` on ``planes`` (the program's
    sharded planes): the windows are split over the data axis; step(fp,
    ascii_u8[W, win_nt], len_w[W], row_map[W, 6], own_start[W, 6],
    own_end[W, 6]) (host arrays) -> ``MeshAnswer`` [W, 6, win_nt//3 - 7]
    of per-(window, container, local window) slot + 1."""
    if win_nt % 3:
        raise ValueError("win_nt must be a multiple of 3")
    return mesh_step(mesh, planes, probe_window, table.num_sigs, False,
                     lambda width: (6, max(width // 3 - K + 1, 0))), planes


def windowed_protein_hits(step, planes, table: KmerTable,
                          seq_ascii: np.ndarray, win_aa: int,
                          probe_window: int = None):
    """Host driver: one long protein through the aa annotate step, windowed.

    ``step``/``planes`` come from annotate_step.make_annotate_step (or its
    mesh form, make_sharded_annotate_step); its body
    takes num_starts as ``lengths - K``, so synthetic lengths = num_starts +
    K make the unmodified aa step enforce each window's exact global start
    count (including the reference's skip-last-window quirk at the true
    end). Returns (pos, otu, avg_from_end, fi, wt) in global protein
    coordinates for the protein's single container."""
    L = len(seq_ascii)
    plan = plan_aa_windows(L, win_aa)
    n_win = len(plan["s"])
    a = np.full((n_win, win_aa), ord("*"), np.uint8)  # invalid aa pad
    for i in range(n_win):
        a[i, : plan["len_w"][i]] = seq_ascii[plan["s"][i]: plan["e"][i]]
    lengths = plan["num_starts"] + K
    (wi, ji), slots = candidates(step(planes["fp"], a, lengths),
                                 table.num_sigs)
    pos = plan["s"][wi] + ji
    # fingerprint-candidate protocol: recompute the query values at the
    # global positions, verify, drop resolved misses
    vals = aa_values_at(seq_ascii[None, :], np.zeros(len(pos), np.int64),
                        pos)
    found, otu, avg, fi, wt = gather_hit_metadata(
        table, slots(vals), values=vals, probe_window=probe_window)
    pos = pos[found]
    return (pos.astype(np.int64), otu[found], avg[found], fi[found],
            wt[found])


def windowed_contig_hits(step, planes, table: KmerTable,
                         seq_ascii: np.ndarray, win_nt: int,
                         probe_window: int = None):
    """Host driver: run one contig through the windowed step.

    seq_ascii: uint8 ASCII bases. Returns hit columns in global frame
    coordinates: (container g in 0..5 reference order, protein position,
    otu, avg_from_end, fi, wt), ready for the per-container grouping
    machine (calls/grouping.py), which re-fuses the windows exactly."""
    L = len(seq_ascii)
    plan = plan_windows(L, win_nt)
    n_win = len(plan["s"])
    a = np.full((n_win, win_nt), ord("N"), np.uint8)  # invalid base pad
    for i in range(n_win):
        a[i, : plan["len_w"][i]] = seq_ascii[plan["s"][i]: plan["e"][i]]
    (wi, gi, ji), slots = candidates(step(
        planes["fp"], a, plan["len_w"], plan["row_map"], plan["own_start"],
        plan["own_end"]), table.num_sigs)
    pos = plan["j0"][wi, gi] + ji
    # fingerprint-candidate protocol: global container + protein position
    # map straight to nucleotide coordinates of the one contig
    vals = dna_values_at(seq_ascii[None, :], np.array([L], np.int64),
                         np.zeros(len(pos), np.int64), gi, pos)
    found, otu, avg, fi, wt = gather_hit_metadata(
        table, slots(vals), values=vals, probe_window=probe_window)
    gi, pos = gi[found], pos[found]
    return (gi.astype(np.int64), pos.astype(np.int64), otu[found],
            avg[found], fi[found], wt[found])
