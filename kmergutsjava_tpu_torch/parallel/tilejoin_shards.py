"""Multi-device sparse lookup: the plane sharded by slot range over a 1-D
``table`` mesh (the counterpart of the JAX package's
``parallel/tilejoin_shards.py``, which the ``xla`` backend takes with
``--mesh`` over more than one device).

Each dispatch's queries are routed on the host to the shard that owns
their home (``home // s_loc``), each shard runs the sparse probe (B1,
``lookup/tilejoin.py``) on its slice of the plane plus a halo of the
first-pass window, at homes local to the slice, and the answers are
scattered back to the queries' order. No collective is needed: a window
never leaves its owner's slice and halo. Verification and the exact pass
are ``SparseLookup``'s own, so ``StreamingLookup`` drives this lookup
unchanged. The JAX module's super-tiles, bins and caps are forms of its TPU
tile join and are not carried.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..formats.kmer_table import KmerTable
from ..lookup import tilejoin
from ..lookup.sparse import (FIRST_PASS_WINDOW, HostWindow, SparseLookup,
                             _check_int32_homes, _device_fault, adaptive_w1,
                             on_stream, probe_answer_sorted)
from .mesh import TABLE_AXIS, Mesh, gather_host, upload
from .sharded_lookup import place_planes, shard_table_planes


class TileJoinShardedLookup(SparseLookup):
    """The sparse lookup with its plane split into the slot ranges of a
    ``1 x T`` mesh. Same exact-result contract as ``SparseLookup``."""

    def __init__(self, table: KmerTable, mesh: Mesh,
                 probe_window: Optional[int] = None,
                 chunk: Optional[int] = None):
        _check_int32_homes(table.num_sigs)
        HostWindow.__init__(self, table, probe_window)
        self.mesh = mesh
        self.n_shards = mesh.shape[TABLE_AXIS]
        self.w1 = min(adaptive_w1(table, FIRST_PASS_WINDOW),
                      self.full_window)
        self.chunk = chunk if chunk is not None else self.DEFAULT_CHUNK
        mine = [t for t in range(self.n_shards) if mesh.local(0, t)]
        self.device, self._stream = (mesh.at(0, mine[0]) if mine
                                     else (None, None))
        planes = shard_table_planes(table, self.n_shards, self.w1)
        self.s_loc = planes["s_loc"]
        with _device_fault("plane upload"):
            self.planes = place_planes(mesh, planes["fp"])[0]

    def dispatch_probe(self, q_fp: np.ndarray, homes: np.ndarray,
                       device_sort: bool = False):
        """Route one chunk's queries to their owner shards (a stable sort by
        owner), upload each of this process's shards' homes, local to its
        slice, and fingerprints in one copy, and start its probe; returns
        the pending (those shards' answer buffers, the sort order, each
        shard's bounds in it) for resolve_probe. With ``device_sort`` each
        shard's queries are probed in home order."""
        homes = np.asarray(homes, np.int32)
        # int16 owners: numpy's stable sort of them is a radix sort
        owner = np.clip(homes // self.s_loc, 0,
                        self.n_shards - 1).astype(np.int16)
        order = np.argsort(owner, kind="stable")
        bounds = np.searchsorted(owner[order], np.arange(self.n_shards + 1))
        probe = probe_answer_sorted if device_sort else tilejoin.probe_answer
        answers = {}  # this process's shards
        with _device_fault("dispatch"):
            for t in range(self.n_shards):
                if not self.mesh.local(0, t):
                    continue
                sel = order[bounds[t]:bounds[t + 1]]
                dev, stream = self.mesh.at(0, t)
                with on_stream(stream):
                    h, q = upload(dev, homes[sel] - np.int32(t * self.s_loc),
                                  np.asarray(q_fp, np.uint16)[sel])
                    answers[t] = probe(self.planes[t], q, h, self.w1)
        return answers, order, bounds

    def resolve_probe(self, pending):
        """Copy each shard's answer back (every shard's, all-gathered, on a
        mesh over processes) and scatter it to the chunk's query order ->
        (off, state) numpy u8 arrays."""
        answers, order, bounds = pending
        n = len(order)
        off = np.empty(n, np.uint8)
        state = np.empty(n, np.uint8)
        got = {}
        with _device_fault("read-back"):
            for t, answer in answers.items():
                with on_stream(self.mesh.at(0, t)[1]):
                    got[t] = answer.cpu().numpy()
            if self.mesh.distributed:
                got = gather_host(self.mesh, got, range(self.n_shards),
                                  np.uint8)
        for t in range(self.n_shards):
            a, b = bounds[t], bounds[t + 1]
            sel = order[a:b]
            off[sel], state[sel] = tilejoin.answer_views(got[t], b - a)
        return off, state
