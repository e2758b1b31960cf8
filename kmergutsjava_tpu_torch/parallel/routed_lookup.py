"""All-to-all routed sharded lookup (the counterpart of the JAX package's
``parallel/routed_lookup.py``).

The sharded lookup (``sharded_lookup.py``) sends every query to every table
shard and sums the answers; per-query traffic grows with the shard count.
Here each of ``T`` shards owns a slot range of the plane AND a slice of the
query stream: each shard bins its queries by owner shard (``home //
s_loc``) with the routing bins (B13, ``parallel/route_bins.py``), the bins
are exchanged (``mesh.all_to_all``: one copy for each pair of shards), each
owner probes the queries it received against its slice with the sparse
probe (B1, ``lookup/tilejoin.py``, at homes local to the slice), the
answers return by the mirrored exchange (one piece a pair of shards, each
cell's offset and state together), and B13 writes them back in query
order, with each query's overflow flag, into one buffer a shard that the
host reads back in one copy. Per-query traffic does not grow with the
shard count.

The bins have a fixed capacity, the mean load per owner times a slack
factor. Queries that would overflow a bin (and padded ones) come back
unanswered, and the host resolves them, with the candidates that fail
verification, by the exact full-window pass (``lookup/sparse.py``
``HostWindow``): the result is exact. Only (fingerprint, home) travel; the
host verifies against the table's host arrays.

The owner's probe is B1's first event, where the JAX step answers a
candidate before any empty slot as state 1, plus 2 when the window holds
an empty slot anywhere (state 3 for a candidate with an empty slot after
it). The offsets and bit 0 are the same, and so is bit 1 where bit 0 is 0;
the host reads bit 0 first, so the verified hits are the same.
"""
from __future__ import annotations

import numpy as np
import torch

from ..formats.kmer_table import KmerTable
from ..lookup import tilejoin
from ..lookup.parity import LookupHits
from ..lookup.sparse import (FP_EMPTY, FP_MOD, HostWindow, _device_fault,
                             on_stream)
from . import route_bins
from .mesh import TABLE_AXIS, Mesh, all_to_all, gather_host, upload
from .sharded_lookup import place_planes, shard_table_planes


class RoutedLookup(HostWindow):
    """Host driver around the routed exchange, over a ``1 x T`` mesh; the
    host half (verification, exact pass) comes from ``HostWindow``."""

    def __init__(self, table: KmerTable, mesh: Mesh, probe_window: int = 16,
                 slack: float = 2.0):
        if probe_window > 128:
            raise ValueError("routed lookup requires probe_window <= 128 "
                             "(two-row gather); rebuild the table at a "
                             "lower load factor")
        super().__init__(table)
        self.mesh = mesh
        self.n_shards = mesh.shape[TABLE_AXIS]
        self.s_loc = -(-table.num_sigs // self.n_shards)
        self.probe_window = probe_window
        self.slack = slack
        planes = shard_table_planes(table, self.n_shards, probe_window)
        with _device_fault("plane upload"):
            self.planes = place_planes(mesh, planes["fp"])[0]

    def probe(self, values: np.ndarray):
        """Each query's (off, state, overflow) from the routed exchange,
        in order: the batch padded to ``T * n_loc`` (fingerprint FP_EMPTY,
        home 0, not valid), shard s binning queries [s * n_loc, (s+1) *
        n_loc) at ``cap = max(64, n_loc / T * slack)``. On a mesh over
        processes each rank bins, probes and un-bins at its own shards,
        the exchanges cross the processes, and the shards' answers are
        all-gathered, so every rank returns the whole answer (every rank
        gives the same values)."""
        t_n = self.n_shards
        n = len(values)
        n_loc = -(-n // t_n)
        n_pad = n_loc * t_n
        homes = np.zeros(n_pad, np.int32)
        homes[:n] = (values % np.int64(self.num_sigs)).astype(np.int32)
        qfp = np.full(n_pad, FP_EMPTY, np.uint16)
        qfp[:n] = (values % FP_MOD).astype(np.uint16)
        cap = max(64, int(n_loc / t_n * self.slack))
        at = self.mesh.at
        mine = [t for t in range(t_n) if self.mesh.local(0, t)]
        sends, cells = [None] * t_n, [None] * t_n
        recv = [None] * t_n
        with _device_fault("dispatch", "routed probe"):
            for s in mine:
                dev, stream = at(0, s)
                lo = s * n_loc
                with on_stream(stream):
                    h, q = upload(dev, homes[lo:lo + n_loc],
                                  qfp[lo:lo + n_loc])
                    b_qfp, b_home, cells[s] = route_bins.bins(
                        q, h, n - lo, self.s_loc, t_n, cap)
                sends[s] = (b_qfp, b_home)
            for t in mine:
                dev, stream = at(0, t)
                with on_stream(stream):
                    recv[t] = (
                        torch.empty((t_n, cap), dtype=torch.uint16,
                                    device=dev),
                        torch.empty((t_n, cap), dtype=torch.int32,
                                    device=dev))
            for k in range(2):  # fingerprints, then homes
                all_to_all(self.mesh, [
                    None if x is None else [x[k][t] for t in range(t_n)]
                    for x in sends], [None if r is None else r[k]
                                      for r in recv])
            answers = [None] * t_n
            for t in mine:
                r_qfp, r_home = recv[t]
                dev, stream = at(0, t)
                with on_stream(stream):
                    local = r_home.view(-1) - t * self.s_loc
                    answer = tilejoin.probe_answer(
                        self.planes[t], r_qfp.view(-1), local,
                        self.probe_window)
                    # source s's cells, offsets and states together: a
                    # [2, cap] view of B1's answer (off, then state at the
                    # next 16-byte boundary), one piece a pair
                    _, state = tilejoin.answer_views(answer, t_n * cap)
                    gap = state.storage_offset() - answer.storage_offset()
                    answers[t] = answer.as_strided((t_n, 2, cap),
                                                   (cap, gap, 1))
                    # the mirrored exchange's receive buffer: back[T, 2, cap]
                    recv[t] = torch.empty((t_n, 2, cap), dtype=torch.uint8,
                                          device=dev)
            all_to_all(self.mesh, [None if a is None else list(a)
                                   for a in answers], recv)
            outs = {}
            for s in mine:
                with on_stream(at(0, s)[1]):
                    outs[s] = route_bins.unbin(cells[s], recv[s])
        parts = {}
        with _device_fault("read-back", "routed probe"):
            for s in mine:  # one copy a shard: off, state and flag rows
                with on_stream(at(0, s)[1]):
                    parts[s] = outs[s].cpu().numpy().reshape(-1)
            if self.mesh.distributed:  # every rank gets the whole answer
                parts = gather_host(self.mesh, parts, range(t_n), np.uint8)
        got = np.concatenate([
            parts[s].reshape(3, -1)[:, :n_loc] for s in range(t_n)], axis=1)
        off, state, over = got[0], got[1], got[2].view(bool)
        return off[:n], state[:n], over[:n]

    def lookup(self, values: np.ndarray, cnt_id, pos: np.ndarray,
               compute_kmers_found: bool = True) -> LookupHits:
        """The routed probe, then ``HostWindow``'s verification: an
        overflowed (or padded) query gets state 0, the exact pass, as do
        the candidates that fail verification. ``kmers_found`` is counted
        by default and is -1 for an empty batch, as the JAX module
        answers."""
        values = np.ascontiguousarray(values, dtype=np.int64)
        if len(values) == 0:
            z = np.zeros(0)
            return LookupHits.from_lists(z, z, z, z, z, z, -1)
        off, state, over = self.probe(values)
        state[over] = 0
        homes = (values % np.int64(self.num_sigs)).astype(np.int32)
        (c, p, otu, avg, fi, wt), mv = self._verify_emit(
            values, homes, off, state, cnt_id, pos, compute_kmers_found)
        return LookupHits(c, p, otu, avg, fi, wt,
                          int(np.unique(mv).size) if compute_kmers_found
                          else -1)
