"""The fused annotation step: ASCII rows -> k-mer windows -> probe ->
candidates (the counterpart of the JAX package's
``parallel/annotate_step.py``), on one device and on a mesh.

On one device (``make_annotate_step``, ``make_dna_step``: the program of a
(1, 1) mesh) a step uploads a batch of ASCII rows and their lengths in one
copy and runs one launch of the fused kernel (``parallel/fused_probe.py``
``first_event``: encode, six-frame translation in DNA mode, 8-mer packing,
each window's home slot and u16 fingerprint, and the sparse probe B1's
first event at the full window ``pw``), which leaves B1's one answer
buffer on the device; ``read_candidates`` copies it back in one copy. The
plane is the u16 fingerprint of every slot (``value % 65535``, ``FP_EMPTY``
for an empty slot) and ``pw`` slots of FP_EMPTY past the end, so every
home's window lies on the plane; a window that is not valid is answered as
off the plane (state 0) without a read.

On a larger ``data x table`` mesh (``make_sharded_annotate_step``,
``make_sharded_dna_step``) the step is the JAX step's body: the rows are
split over the data axis (padded with empty rows to a multiple of it, as
the JAX engine pads them), every position (d, t) runs one launch of the
fused kernel in the shard probe B12's form (``fused_probe.py``
``shard_first_match``) on data slice d's rows against table shard t's
slice of the plane, and each data row's answers are summed
(``mesh.psum``): per window the first fingerprint-match slot + 1, 0 for
none, bit for bit the JAX step's answer (``MeshAnswer``). On a mesh over
processes each rank runs its own positions, a row's sum is an
``all_reduce`` where the row spans ranks, and every rank reads every row
(``fetch_global``).

Either way the host verifies each candidate against the query value
recomputed at its coordinates (``ops/hostvalues.py``) and gathers the
metadata (``parallel/sharded_lookup.py``); ``candidates`` reads either
answer back.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..constants import K
from ..formats.kmer_table import KmerTable
from ..lookup import tilejoin
from ..lookup.sparse import fingerprint_plane, on_stream
from . import fused_probe
from .mesh import DATA_AXIS, TABLE_AXIS, Mesh, fetch_global, psum, upload
from .sharded_lookup import place_planes, shard_table_planes, split_rows


def table_plane(table: KmerTable, probe_window: int, device) -> torch.Tensor:
    """The table's u16 fingerprint plane with ``probe_window`` slots of
    FP_EMPTY past its end, on ``device`` (on the current stream)."""
    return torch.from_numpy(fingerprint_plane(
        table, table.num_sigs + probe_window)).to(device)


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


class MeshAnswer(NamedTuple):
    """A mesh step's answer: each data row's int32 slot + 1 on its first
    position of this process (None for a row this process holds no
    position of), for the first ``shape[0]`` of the padded batch's rows."""
    mesh: Mesh
    rows: list
    shape: tuple

    def read(self) -> np.ndarray:
        """The answer on the host, of ``shape`` (every row's, on every
        rank of a mesh over processes: each rank must read each step's
        answer, in the same order)."""
        got = fetch_global(self.mesh, self.rows)
        return got.reshape(-1, *self.shape[1:])[:self.shape[0]]


def candidates(out, num_sigs: int):
    """Read one step's output back -> (the coordinates of the windows with
    a candidate, as np.nonzero gives them, and a function of their k-mer
    values that returns their slot + 1): B1's (answer, shape) on one
    device, or a ``MeshAnswer``."""
    if isinstance(out, MeshAnswer):
        slotp = out.read()
        idx = np.nonzero(slotp)
        chosen = slotp[idx]
        return idx, lambda values: chosen
    idx, off = read_candidates(*out)
    return idx, lambda values: candidate_slots(values, off, num_sigs)


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
        return (fused_probe.first_event(fp, a, ns, True, table.num_sigs,
                                        probe_window),
                (ascii_u8.shape[0], w))

    return step, {"fp": table_plane(table, probe_window, device)}


def make_dna_step(table: KmerTable, probe_window: int, device
                  ) -> Tuple[Callable, dict]:
    """Returns (step, planes). step(fp, ascii_u8[B, Lpad], lengths[B])
    (host arrays) -> (B1's answer on the device, its window shape [B, 6,
    Lpad//3 - 7], containers in the reference's order +0,+1,+2,-0,-1,-2;
    Lpad need not be a multiple of 3)."""
    def step(fp, ascii_u8: np.ndarray, lengths: np.ndarray):
        a, lens = upload(fp.device, ascii_u8,
                         np.asarray(lengths).astype(np.int32))
        w = max(ascii_u8.shape[1] // 3 - K + 1, 0)
        return (fused_probe.first_event(fp, a, lens, False, table.num_sigs,
                                        probe_window),
                (ascii_u8.shape[0], 6, w))

    return step, {"fp": table_plane(table, probe_window, device)}


def sharded_planes(mesh: Mesh, table: KmerTable, probe_window: int) -> dict:
    """The table's plane cut into the mesh's table shards, each on its
    positions of this process (``fp`` [d][t]), and the slots a shard owns
    (``s_loc``)."""
    planes = shard_table_planes(table, mesh.shape[TABLE_AXIS], probe_window)
    return {"fp": place_planes(mesh, planes["fp"]), "s_loc": planes["s_loc"]}


def mesh_step(mesh: Mesh, planes: dict, probe_window: int, num_sigs: int,
              aa: bool, width: Callable[[int], tuple]) -> Callable:
    """A step over the mesh: step(fp, rows, counts, *extra) (host arrays of
    one batch: ``rows`` uint8 [B, L], ``counts`` [B] num_starts or lengths
    as ``fused_probe`` takes them, ``extra`` a long contig's row_map,
    own_start and own_end [B, 6]) -> ``MeshAnswer`` of shape (B,
    *width(L)). The batch is padded with zero rows (no windows) to a
    multiple of the data axis; position (d, t) uploads data slice d and
    runs the fused kernel's shard entry on it against table shard t;
    ``psum`` adds row d's answers. On a mesh over processes each rank runs
    its own positions only, and every rank must make the same steps on
    the same batches: the padding and the slices do not depend on the
    rank, ``psum`` joins a row across its ranks and ``MeshAnswer.read``
    gathers every row on every rank."""
    s_loc = planes["s_loc"]

    def step(fp, rows: np.ndarray, *cols):
        b = rows.shape[0]
        n_data = mesh.shape[DATA_AXIS]
        b_pad = -(-b // n_data) * n_data
        arrays = []
        for x in (rows, *(np.asarray(c).astype(np.int32) for c in cols)):
            arrays.append(np.concatenate(
                [x, np.zeros((b_pad - b, *x.shape[1:]), x.dtype)]))
        out = []
        for d, (a, e) in enumerate(split_rows(b_pad, n_data)):
            parts = [None] * mesh.shape[TABLE_AXIS]
            for t in range(mesh.shape[TABLE_AXIS]):
                if not mesh.local(d, t):
                    continue
                dev, stream = mesh.at(d, t)
                with on_stream(stream):
                    rows_d, counts, *extra = upload(dev, *(x[a:e]
                                                           for x in arrays))
                    parts[t] = fused_probe.shard_first_match(
                        fp[d][t], rows_d, counts, aa, num_sigs, t * s_loc,
                        s_loc, probe_window, *extra)
            out.append(psum(mesh, d, parts))
        return MeshAnswer(mesh, out, (b, *width(rows.shape[1])))

    return step


def make_sharded_annotate_step(mesh: Mesh, table: KmerTable,
                               probe_window: int) -> Tuple[Callable, dict]:
    """Returns (step, planes). step(fp, ascii_u8[B, L], lengths[B]) (host
    arrays) -> ``MeshAnswer`` [B, L-7] of per-window candidate slot+1 (0 =
    miss), B split over the data axis; num_starts = lengths - K as on one
    device."""
    planes = sharded_planes(mesh, table, probe_window)
    inner = mesh_step(mesh, planes, probe_window, table.num_sigs, True,
                      lambda width: (max(width - K + 1, 0),))

    def step(fp, ascii_u8: np.ndarray, lengths: np.ndarray):
        return inner(fp, ascii_u8, np.asarray(lengths) - K)

    return step, planes


def make_sharded_dna_step(mesh: Mesh, table: KmerTable, probe_window: int
                          ) -> Tuple[Callable, dict]:
    """Returns (step, planes). step(fp, ascii_u8[B, Lpad], lengths[B])
    (host arrays) -> ``MeshAnswer`` [B, 6, Lpad//3 - 7] of per-(contig,
    frame, window) candidate slot+1 (0 = miss)."""
    planes = sharded_planes(mesh, table, probe_window)
    return mesh_step(mesh, planes, probe_window, table.num_sigs, False,
                     lambda width: (6, max(width // 3 - K + 1, 0))), planes
