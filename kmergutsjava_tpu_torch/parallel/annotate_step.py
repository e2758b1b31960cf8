"""The fused annotation step on one device: ASCII rows -> k-mer windows ->
sparse probe -> candidates (the counterpart of the JAX package's
``parallel/annotate_step.py``, without its mesh).

A step uploads a batch of ASCII rows and their lengths in one copy, runs
the k-mer window kernel (``ops/kmer_windows.py``: encode, six-frame
translation in DNA mode, 8-mer packing, each window's home slot and u16
fingerprint) and the sparse probe (``lookup/tilejoin.py``, B1) at the full
window ``pw`` over the flat windows, and leaves B1's one answer buffer on the
device; ``read_candidates`` copies it back in one copy. The host verifies
each candidate against the query value recomputed at its coordinates
(``ops/hostvalues.py``) and gathers the metadata
(``parallel/sharded_lookup.py``).

The plane is the u16 fingerprint of every slot (``value % 65535``,
``FP_EMPTY`` for an empty slot) and ``pw`` slots of FP_EMPTY past the end,
so every home's window lies on the plane; a window that is not valid has
home -1, which B1 answers as off the plane. The JAX package's planes in
overlapped 128-lane rows, sharded by slot range and merged by a psum, are
TPU layouts for its row-gather probe and are not carried.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..constants import K
from ..formats.kmer_table import KmerTable
from ..lookup import tilejoin
from ..lookup.sparse import fingerprint_plane
from ..ops import kmer_windows


def table_plane(table: KmerTable, probe_window: int, device) -> torch.Tensor:
    """The table's u16 fingerprint plane with ``probe_window`` slots of
    FP_EMPTY past its end, on ``device`` (on the current stream)."""
    return torch.from_numpy(fingerprint_plane(
        table, table.num_sigs + probe_window)).to(device)


def upload(device, *arrays: np.ndarray):
    """Host arrays to ``device`` in one copy of one host buffer (each
    array at a 16-byte boundary); returns tensor views of their dtypes and
    shapes."""
    at, spans = 0, []
    for a in arrays:
        spans.append(at)
        at += -(-a.nbytes // 16) * 16
    host = np.empty(at, np.uint8)
    for a, s in zip(arrays, spans):
        host[s:s + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)
    buf = torch.from_numpy(host).to(device)
    return [buf[s:s + a.nbytes].view(getattr(torch, a.dtype.name)).view(
        a.shape) for a, s in zip(arrays, spans)]


def read_candidates(answer: torch.Tensor, shape: tuple):
    """Copy one step's answer back (one copy) -> (coordinates of the
    windows with a candidate, as np.nonzero gives them over ``shape``, and
    each one's window offset). State 2 (an empty slot first) and state 0
    (no event within the full window, or a window that is not valid) are
    misses."""
    n = int(np.prod(shape))
    off, state = tilejoin.answer_views(answer.cpu().numpy(), n)
    idx = np.nonzero(state.reshape(shape) == 1)
    return idx, off.reshape(shape)[idx].astype(np.int64)


def candidate_slots(values: np.ndarray, off: np.ndarray, num_sigs: int
                    ) -> np.ndarray:
    """The candidates' slot + 1 (the JAX step's answer) from their values
    and window offsets."""
    return values % np.int64(num_sigs) + off + 1


def _encode_and_probe(fp, ascii_u8, num_starts, *, probe_window, num_sigs):
    """Protein rows on the device -> B1's answer over their windows."""
    homes, fps = kmer_windows.aa_homes_fps(ascii_u8, num_starts, num_sigs)
    return tilejoin.probe_answer(fp, fps.view(-1), homes.view(-1),
                                 probe_window)


def _dna_encode_and_probe(fp, ascii_u8, lengths, *, probe_window, num_sigs,
                          row_map=None, own_start=None, own_end=None):
    """Contig rows (or a long contig's windows) on the device -> B1's
    answer over their [B, 6, W] windows, containers in the reference's
    order +0,+1,+2,-0,-1,-2. Lpad need not be a multiple of 3."""
    homes, fps = kmer_windows.dna_homes_fps(ascii_u8, lengths, num_sigs,
                                            row_map, own_start, own_end)
    return tilejoin.probe_answer(fp, fps.view(-1), homes.view(-1),
                                 probe_window)


def make_annotate_step(table: KmerTable, probe_window: int, device
                       ) -> Tuple[Callable, dict]:
    """Returns (step, planes). step(fp, ascii_u8[B, L], lengths[B]) (host
    arrays) -> (B1's answer on the device, its window shape [B, L-7]);
    the reference's window bound i < len - K (ref KmerGutsJava.java:912)
    becomes num_starts = lengths - K."""
    def step(fp, ascii_u8: np.ndarray, lengths: np.ndarray):
        a, ns = upload(fp.device, ascii_u8,
                       (np.asarray(lengths) - K).astype(np.int32))
        w = max(ascii_u8.shape[1] - K + 1, 0)
        return (_encode_and_probe(fp, a, ns, probe_window=probe_window,
                                  num_sigs=table.num_sigs),
                (ascii_u8.shape[0], w))

    return step, {"fp": table_plane(table, probe_window, device)}


def make_dna_step(table: KmerTable, probe_window: int, device
                  ) -> Tuple[Callable, dict]:
    """Returns (step, planes). step(fp, ascii_u8[B, Lpad], lengths[B])
    (host arrays) -> (B1's answer on the device, its window shape [B, 6,
    Lpad//3 - 7])."""
    def step(fp, ascii_u8: np.ndarray, lengths: np.ndarray):
        a, lens = upload(fp.device, ascii_u8,
                         np.asarray(lengths).astype(np.int32))
        w = max(ascii_u8.shape[1] // 3 - K + 1, 0)
        return (_dna_encode_and_probe(fp, a, lens, probe_window=probe_window,
                                      num_sigs=table.num_sigs),
                (ascii_u8.shape[0], 6, w))

    return step, {"fp": table_plane(table, probe_window, device)}
