"""Multi-device dense stream lookup: the plane and the query tiles split
into slot ranges over a 1-D ``table`` mesh (the counterpart of the JAX
package's ``parallel/stream_shards.py``, which the ``stream`` backend takes
with ``--mesh``).

The host scatter already routes every query to its home slot, so splitting
the plane ``[S + w]`` by slot range splits the tiles ``[C, S]`` the same
way: shard t holds its slots and a halo of ``w``, probes its columns of the
tiles with the stream probe (B2, ``lookup/stream.py``), and needs no
collective. The packed answers are joined in slot order on the host, and
the native scatter, the decode and the empty-distance plane of
``StreamLookup`` stay as they are.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..formats.kmer_table import KmerTable
from ..lookup.sparse import _device_fault, on_stream
from ..lookup.stream import SLOT_ALIGN, PassSet, StreamLookup, stream_probe
from .mesh import TABLE_AXIS, Mesh, gather_host, make_mesh


def make_stream_mesh(n_shards: int, devices: List[torch.device],
                     distributed: bool = False) -> Mesh:
    """A ``1 x T`` mesh of the first ``n_shards`` of ``devices`` (of every
    rank's, with ``distributed``: ``make_mesh``): like the JAX package's,
    it takes fewer shards, silently, when there are fewer devices (the
    result is exact either way)."""
    have = len(devices)
    if distributed:
        import torch.distributed as dist

        have *= dist.get_world_size()
    return make_mesh(1, min(n_shards, have), devices, distributed)


class StreamShardedLookup(StreamLookup):
    """Stream-kernel lookup with the plane and tiles split over a ``1 x T``
    mesh. Same exact-result contract as ``StreamLookup`` (host
    verification and the exact fallback are inherited unchanged). Its
    pass sets hold host buffers only: ``_probe`` places each shard's
    columns itself."""

    _probe_on_device = False

    def __init__(self, table: KmerTable, mesh: Mesh,
                 probe_window: Optional[int] = None):
        self.mesh = mesh
        self.n_shards = mesh.shape[TABLE_AXIS]
        self.mine = [t for t in range(self.n_shards) if mesh.local(0, t)]
        first = mesh.at(0, self.mine[0])[0] if self.mine else "cpu"
        super().__init__(table, probe_window, device=str(first))

    def _place_plane(self, fp: np.ndarray, device: str) -> None:
        """Shard t's slots [a, b) (a multiple of SLOT_ALIGN apart) and their
        halo of w slots, on position (0, t) (this process's shards)."""
        self.device = torch.device(device)
        self._stream = (self.mesh.at(0, self.mine[0])[1] if self.mine
                        else None)
        per = -(-self.slots // (self.n_shards * SLOT_ALIGN)) * SLOT_ALIGN
        self.ranges = [(min(t * per, self.slots),
                        min((t + 1) * per, self.slots))
                       for t in range(self.n_shards)]
        self.planes = [None] * self.n_shards
        with _device_fault("upload", "stream probe"):
            for t in self.mine:
                a, b = self.ranges[t]
                dev, stream = self.mesh.at(0, t)
                with on_stream(stream):
                    self.planes[t] = torch.from_numpy(
                        fp[a:b + self.w]).to(dev)
            self.mesh.synchronize()

    def _probe(self, s: PassSet) -> np.ndarray:
        """Each shard's columns of the set's tiles up (one copy a channel,
        from page-locked memory where the set is), one plane pass a shard,
        the packed answers back and joined in slot order: int32
        ``[channels/4, S]``. On a mesh over processes each
        rank passes its own shards (every rank holds the same tiles) and
        the answers are all-gathered, so every rank decodes all of them."""
        tiles = s.tiles
        outs = {}
        with _device_fault("pass", "stream probe"):
            for t in self.mine:
                a, b = self.ranges[t]
                dev, stream = self.mesh.at(0, t)
                with on_stream(stream):
                    part = torch.empty((self.channels, b - a),
                                       dtype=torch.uint16, device=dev)
                    for c in range(self.channels):
                        part[c].copy_(torch.from_numpy(tiles[c, a:b]))
                    outs[t] = stream_probe(self.planes[t], part, self.w,
                                           self.channels)
            got = {}
            for t, o in outs.items():
                with on_stream(self.mesh.at(0, t)[1]):
                    got[t] = o.cpu().numpy().reshape(-1)
            if self.mesh.distributed:
                got = gather_host(self.mesh, got, range(self.n_shards),
                                  np.int32)
            rows = self.channels // 4
            return np.concatenate([got[t].reshape(rows, -1)
                                   for t in range(self.n_shards)], axis=1)
