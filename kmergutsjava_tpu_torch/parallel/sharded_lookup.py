"""Multi-device lookup: the plane sharded by slot range over the ``table``
axis of a mesh, the queries split over its ``data`` axis, and a sum of the
shards' answers (the counterpart of the JAX package's
``parallel/sharded_lookup.py``).

- each table shard holds its slot range plus a ``probe_window`` halo
  (``shard_table_planes``), so that any window whose home it owns lies in
  its slice;
- every position (d, t) probes data slice d against table shard t with the
  shard probe (B12, ``parallel/shard_probe.py``): the first slot of the
  window that holds the query's u16 fingerprint (``value % 65535``), as the
  global slot + 1, for the queries whose home it owns, 0 for the others;
- the answers are summed over the table axis on each data row's first
  position (``mesh.psum``) and read back (``mesh.fetch_global``).

The host half is a copy of the JAX module's: a true match always
fingerprint-matches at or before itself, so candidates are a superset of
matches; the host verifies each against the full k-mer value and re-probes
the rare fingerprint collision over the exact window
(``verify_candidates``), then gathers the hit metadata from the table's
host arrays (``gather_hit_metadata``). The JAX package's 128-lane
overlapped rows are a layout for its TPU row gather and are not carried:
a shard's plane is a flat slice.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from ..formats.kmer_table import KmerTable
from ..lookup.parity import LookupHits
from ..lookup.sparse import FP_MOD, fingerprint_plane, on_stream
from . import shard_probe
from .mesh import (DATA_AXIS, TABLE_AXIS, Mesh, fetch_global, psum,
                   upload)


def shard_table_planes(table: KmerTable, n_shards: int, probe_window: int
                       ) -> dict:
    """Host-side prep: each table shard's slice of the u16 fingerprint plane
    with its halo, ``fp`` [n_shards, s_loc + probe_window] (shard t holds
    global slots [t * s_loc, t * s_loc + s_loc + probe_window), FP_EMPTY
    past the table), and ``s_loc``, the slots a shard owns."""
    if probe_window > 128:
        raise ValueError("sharded lookup requires probe_window <= 128 "
                         "(two-row gather); rebuild the table at a lower "
                         "load factor")
    if table.num_sigs + probe_window >= 2**31 - 1:
        # the probe answer (candidate global slot + 1) rides the sum as
        # int32; a larger table would silently wrap to a wrong slot
        raise ValueError("sharded lookup encodes slots as int32; "
                         f"num_sigs={table.num_sigs} would overflow — "
                         "shard the table across hosts instead")
    s_loc = -(-table.num_sigs // n_shards)
    fp = fingerprint_plane(table, n_shards * s_loc + probe_window)
    slices = np.lib.stride_tricks.as_strided(
        fp, shape=(n_shards, s_loc + probe_window),
        strides=(s_loc * fp.itemsize, fp.itemsize))
    return {"fp": np.ascontiguousarray(slices), "s_loc": s_loc}


def place_planes(mesh: Mesh, fp: np.ndarray) -> List[List[torch.Tensor]]:
    """Table shard t's plane slice ``fp[t]`` on every position (d, t) of
    this process (None at other processes'), each uploaded on its
    position's stream; waits for the uploads."""
    out = [[None] * mesh.shape[TABLE_AXIS]
           for _ in range(mesh.shape[DATA_AXIS])]
    for d, t in mesh.positions():
        dev, stream = mesh.at(d, t)
        with on_stream(stream):
            out[d][t] = torch.from_numpy(fp[t]).to(dev)
    mesh.synchronize()
    return out


def split_rows(n_rows: int, n_data: int) -> List[Tuple[int, int]]:
    """The data slices of ``n_rows`` rows, a multiple of ``n_data``."""
    per = n_rows // n_data
    return [(d * per, (d + 1) * per) for d in range(n_data)]


def make_sharded_lookup(mesh: Mesh, table: KmerTable, probe_window: int
                        ) -> Tuple[Callable, dict]:
    """Build a sharded lookup step and its device-ready fp planes.

    Returns (step, planes): step(fp, qfp, homes) (host arrays, their
    length a multiple of the data axis) -> each data row's candidate slot+1
    (0 = miss) on its first position, for ``fetch_global``. On a mesh over
    processes each rank probes at its own positions only (its rows' other
    entries are None), with the same arrays on every rank. Data slice d's
    fingerprints and homes (6 B a query) go up to every position (d, t),
    B12 probes them against table shard t there, and ``psum`` adds the
    answers of row d. The host verifies candidates and gathers metadata
    (`verify_candidates` / `gather_hit_metadata`)."""
    planes = shard_table_planes(table, mesh.shape[TABLE_AXIS], probe_window)
    s_loc = planes["s_loc"]

    def step(fp, qfp: np.ndarray, homes: np.ndarray):
        rows = []
        for d, (a, b) in enumerate(split_rows(len(homes),
                                              mesh.shape[DATA_AXIS])):
            parts = [None] * mesh.shape[TABLE_AXIS]
            for t in range(mesh.shape[TABLE_AXIS]):
                if not mesh.local(d, t):
                    continue  # another process's position
                dev, stream = mesh.at(d, t)
                with on_stream(stream):
                    h, q = upload(dev, homes[a:b], qfp[a:b])
                    parts[t] = shard_probe.shard_probe(
                        fp[d][t], q, h, t * s_loc, s_loc, probe_window)
            rows.append(psum(mesh, d, parts))
        return rows

    return step, {"fp": place_planes(mesh, planes["fp"])}


def verify_candidates(table: KmerTable, slotp: np.ndarray,
                      values: np.ndarray, probe_window: int):
    """Resolve fingerprint-candidate answers into exact matches.

    ``slotp``: the device's candidate slot+1 per query (0 = no candidate);
    ``values``: the queries' full k-mer values, aligned. Returns
    (found, slots): the exact first-value-match slot per query.

    A true match fingerprints equal, so the device candidate offset is
    <= the true offset; three cases per candidate:
    - stored kmer == value: the candidate IS the first value match
      (any earlier value match would have been an earlier fp match);
    - mismatch (fp collision, ~probe_window/65535 of queries): exact
      full-window host re-probe; the true match, if any, is later in
      the window;
    - no candidate: a true miss (a match implies a candidate).
    Slots past num_sigs (padded tail, reachable only by corrupted-input
    values equal to the empty sentinel) count as misses. The window scan
    treats beyond-end slots as empty."""
    slots = slotp.astype(np.int64) - 1
    cand = (slotp > 0) & (slots < table.num_sigs)
    tk = table.slots["kmer"]
    found = np.zeros(len(slots), dtype=bool)
    sel = np.nonzero(cand)[0]
    v = np.asarray(values, dtype=np.int64)
    found[sel] = tk[slots[sel]] == v[sel]
    bad = sel[~found[sel]]
    if len(bad):
        homes = (v[bad] % np.int64(table.num_sigs)).astype(np.int64)
        f2 = np.zeros(len(bad), dtype=bool)
        off2 = np.zeros(len(bad), dtype=np.int64)
        ns = table.num_sigs
        # reverse order + overwrite == first-match offset; beyond-end
        # reads clamp to a masked miss (treated as empty)
        for l in range(probe_window - 1, -1, -1):
            idx = homes + l
            ok = idx < ns
            m = ok & (tk[np.minimum(idx, ns - 1)] == v[bad])
            off2[m] = l
            f2 |= m
        found[bad] = f2
        slots[bad] = np.where(f2, homes + off2, 0)
    slots = np.where(found, slots, 0)
    return found, slots


def gather_hit_metadata(table: KmerTable, slotp: np.ndarray,
                        values: np.ndarray = None,
                        probe_window: int = None):
    """Host-side metadata gather at slot+1 answers (0 = miss). Returns
    (found_bool, otu, avg_from_end, fi, wt) aligned with the queries.
    With ``values`` given (the fingerprint-candidate protocol), answers
    are first verified and collision-resolved by `verify_candidates`;
    callers MUST drop rows where found is False. Without values the
    answers are trusted exact; a slot in the padded tail past num_sigs
    still counts as a miss rather than indexing out of bounds."""
    if values is not None:
        if probe_window is None:
            if table.max_probe is None:
                table.compute_max_probe()
            probe_window = max(8, table.max_probe)
        found, slots = verify_candidates(table, slotp, values, probe_window)
    else:
        slots = slotp.astype(np.int64) - 1
        found = (slotp > 0) & (slots < table.num_sigs)
        slots = np.where(found, slots, 0)
    t = table.slots
    z32 = np.int32(0)
    return (found,
            np.where(found, t["otu"][slots], z32),
            np.where(found, t["avg_from_end"][slots], z32),
            np.where(found, t["fi"][slots], z32),
            np.where(found, t["wt"][slots], np.float32(0)))


def sharded_lookup_queries(mesh: Mesh, step, device_planes,
                           values: np.ndarray, table: KmerTable,
                           pad_multiple: int, probe_window: int = None):
    """Host convenience: pad values to the data-shard multiple, run the
    device candidate probe, verify + gather metadata host-side."""
    n = len(values)
    n_data = mesh.shape[DATA_AXIS]
    mult = n_data * pad_multiple
    n_pad = -(-max(n, 1) // mult) * mult
    v = np.zeros(n_pad, dtype=np.int64)
    v[:n] = values
    homes = (v % np.int64(table.num_sigs)).astype(np.int32)
    qfp = (v % np.int64(FP_MOD)).astype(np.uint16)
    # padding rows have value 0 / home 0; they may return a candidate for
    # kmer 0 but are sliced off below
    slotp = fetch_global(mesh, step(device_planes["fp"], qfp, homes))[:n]
    return gather_hit_metadata(table, slotp, values=v[:n],
                               probe_window=probe_window)


class ShardedLookup:
    """The ``sharded`` backend's lookup (the JAX engine's
    ``_sharded_lookup``): the step and planes of ``make_sharded_lookup`` on
    ``mesh``, each batch padded to ``pad_multiple`` queries a data row."""

    def __init__(self, table: KmerTable, mesh: Mesh, probe_window: int,
                 pad_multiple: int = 256):
        self.table = table
        self.mesh = mesh
        self.probe_window = probe_window
        self.pad_multiple = pad_multiple
        self.step, self.planes = make_sharded_lookup(mesh, table,
                                                     probe_window)

    def lookup(self, values: np.ndarray, cnt_id, pos: np.ndarray,
               compute_kmers_found: bool = True) -> LookupHits:
        values = np.asarray(values, dtype=np.int64)
        found, otu, avg, fi, wt = sharded_lookup_queries(
            self.mesh, self.step, self.planes, values, self.table,
            self.pad_multiple, self.probe_window)
        mask = found.astype(bool)
        return LookupHits(
            cnt_id=np.asarray(cnt_id)[mask].astype(np.int64),
            pos=np.asarray(pos)[mask].astype(np.int64),
            otu=otu[mask], avg_from_end=avg[mask], fi=fi[mask],
            wt=wt[mask],
            kmers_found=(int(np.unique(values[mask]).size)
                         if compute_kmers_found else -1))
