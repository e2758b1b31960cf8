"""Pure data-parallel lookup: the plane replicated, the query stream split
(the counterpart of the JAX package's ``parallel/replicated_lookup.py``).

The simplest multi-device mode: when the fingerprint plane fits on every
device, each of the mesh's ``D`` data devices holds a copy, and each
dispatch of queries is split ``D`` ways; each slice is probed on its device
by the sparse probe (B1, ``lookup/tilejoin.py``) at the first-pass window,
with no collective at all, and the answers are joined on the host. The
verification and the exact full-window pass of the unresolved queries are
``SparseLookup``'s own, as the JAX module reuses its single-device
lookup's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..formats.kmer_table import KmerTable
from ..lookup import tilejoin
from ..lookup.parity import LookupHits
from ..lookup.sparse import (FIRST_PASS_WINDOW, FP_EMPTY, HostWindow,
                             SparseLookup, _check_int32_homes, _device_fault,
                             adaptive_w1, fingerprint_plane, on_stream,
                             probe_answer_sorted)
from .mesh import DATA_AXIS, Mesh, upload
from .sharded_lookup import split_rows


class ReplicatedLookup(SparseLookup):
    """The sparse lookup over an ``n x 1`` mesh: the plane on every data
    device, each dispatch's queries split over them. ``chunk`` is a data
    device's share of a dispatch (default: one device's dispatch). A mesh
    over processes is refused (ValueError): the JAX lookup does not run on
    one either, its ``jax.device_get`` of an answer that spans other
    processes' devices raises."""

    def __init__(self, table: KmerTable, mesh: Mesh,
                 chunk: Optional[int] = None):
        _check_int32_homes(table.num_sigs)
        mesh.one_process("the replicated lookup")
        HostWindow.__init__(self, table)
        self.mesh = mesh
        self.n_dev = mesh.shape[DATA_AXIS]
        self.w1 = min(adaptive_w1(table, FIRST_PASS_WINDOW), self.full_window)
        self.chunk = self.n_dev * (chunk or self.DEFAULT_CHUNK)
        # w1 slots of FP_EMPTY past the end: every home's window is in range
        plane = fingerprint_plane(table, table.num_sigs + self.w1)
        self.planes = []
        with _device_fault("plane upload"):
            for d in range(self.n_dev):
                dev, stream = mesh.at(d, 0)
                with on_stream(stream):
                    self.planes.append(torch.from_numpy(plane).to(dev))
            mesh.synchronize()

    def dispatch_probe(self, q_fp: np.ndarray, homes: np.ndarray,
                       device_sort: bool = False):
        """Start B1 on one dispatch: padded to a multiple of the data axis
        (fingerprint FP_EMPTY, home 0) and split ``D`` ways, one launch a
        data device (each slice in home order with ``device_sort``);
        returns the pending (answers, spans, query count)."""
        n = len(homes)
        n_pad = -(-max(n, 1) // self.n_dev) * self.n_dev
        qfp = np.full(n_pad, FP_EMPTY, np.uint16)
        qfp[:n] = q_fp
        h_pad = np.zeros(n_pad, np.int32)
        h_pad[:n] = homes
        spans = split_rows(n_pad, self.n_dev)
        probe = probe_answer_sorted if device_sort else tilejoin.probe_answer
        answers = []
        with _device_fault("dispatch"):
            for d, (a, b) in enumerate(spans):
                dev, stream = self.mesh.at(d, 0)
                with on_stream(stream):
                    h, q = upload(dev, h_pad[a:b], qfp[a:b])
                    answers.append(probe(self.planes[d], q, h, self.w1))
        return answers, spans, n

    def resolve_probe(self, pending):
        """Copy each data device's answer back and join them in query
        order -> (off, state) numpy u8 arrays."""
        answers, spans, n = pending
        off = np.empty(spans[-1][1], np.uint8)
        state = np.empty(spans[-1][1], np.uint8)
        with _device_fault("read-back"):
            for d, ((a, b), ans) in enumerate(zip(spans, answers)):
                with on_stream(self.mesh.at(d, 0)[1]):
                    off[a:b], state[a:b] = tilejoin.answer_views(
                        ans.cpu().numpy(), b - a)
        return off[:n], state[:n]

    def lookup(self, values: np.ndarray, cnt_id, pos: np.ndarray,
               progress=None, compute_kmers_found: bool = True
               ) -> LookupHits:
        """``SparseLookup.lookup``, ``kmers_found`` counted by default and
        -1 for an empty batch, as the JAX module answers."""
        if len(values) == 0:
            z = np.zeros(0)
            return LookupHits.from_lists(z, z, z, z, z, z, -1)
        return super().lookup(values, cnt_id, pos, progress,
                              compute_kmers_found)
