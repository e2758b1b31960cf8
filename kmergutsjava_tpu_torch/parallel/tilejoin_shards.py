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
from .mesh import TABLE_AXIS, Mesh, upload
from .sharded_lookup import place_planes, shard_table_planes


class TileJoinShardedLookup(SparseLookup):
    """The sparse lookup with its plane split into the slot ranges of a
    ``1 x T`` mesh. Same exact-result contract as ``SparseLookup``."""

    def __init__(self, table: KmerTable, mesh: Mesh,
                 probe_window: Optional[int] = None,
                 chunk: Optional[int] = None):
        _check_int32_homes(table.num_sigs)
        mesh.one_process("the sharded sparse probe")
        HostWindow.__init__(self, table, probe_window)
        self.mesh = mesh
        self.n_shards = mesh.shape[TABLE_AXIS]
        self.w1 = min(adaptive_w1(table, FIRST_PASS_WINDOW),
                      self.full_window)
        self.chunk = chunk if chunk is not None else self.DEFAULT_CHUNK
        self.device, self._stream = mesh.at(0, 0)
        planes = shard_table_planes(table, self.n_shards, self.w1)
        self.s_loc = planes["s_loc"]
        with _device_fault("plane upload"):
            self.planes = place_planes(mesh, planes["fp"])[0]

    def dispatch_probe(self, q_fp: np.ndarray, homes: np.ndarray,
                       device_sort: bool = False):
        """Route one chunk's queries to their owner shards (a stable sort by
        owner), upload each shard's homes, local to its slice, and
        fingerprints in one copy, and start its probe; returns the pending
        (per shard: answer buffer and query count, the sort order, the
        query count) for resolve_probe. With ``device_sort`` each shard's
        queries are probed in home order."""
        homes = np.asarray(homes, np.int32)
        # int16 owners: numpy's stable sort of them is a radix sort
        owner = np.clip(homes // self.s_loc, 0,
                        self.n_shards - 1).astype(np.int16)
        order = np.argsort(owner, kind="stable")
        bounds = np.searchsorted(owner[order], np.arange(self.n_shards + 1))
        probe = probe_answer_sorted if device_sort else tilejoin.probe_answer
        answers = []
        with _device_fault("dispatch"):
            for t in range(self.n_shards):
                sel = order[bounds[t]:bounds[t + 1]]
                dev, stream = self.mesh.at(0, t)
                with on_stream(stream):
                    h, q = upload(dev, homes[sel] - np.int32(t * self.s_loc),
                                  np.asarray(q_fp, np.uint16)[sel])
                    answers.append((probe(self.planes[t], q, h, self.w1),
                                    len(sel)))
        return answers, order, len(homes)

    def resolve_probe(self, pending):
        """Copy each shard's answer back and scatter it to the chunk's
        query order -> (off, state) numpy u8 arrays."""
        answers, order, n = pending
        off = np.empty(n, np.uint8)
        state = np.empty(n, np.uint8)
        at = 0
        with _device_fault("read-back"):
            for t, (answer, k) in enumerate(answers):
                with on_stream(self.mesh.at(0, t)[1]):
                    o, s = tilejoin.answer_views(answer.cpu().numpy(), k)
                sel = order[at:at + k]
                off[sel], state[sel] = o, s
                at += k
        return off, state
