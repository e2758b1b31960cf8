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
from ..lookup.stream import SLOT_ALIGN, StreamLookup, stream_probe
from .mesh import TABLE_AXIS, Mesh, make_mesh


def make_stream_mesh(n_shards: int, devices: List[torch.device]) -> Mesh:
    """A ``1 x T`` mesh of the first ``n_shards`` of ``devices``: like the
    JAX package's, it takes fewer shards, silently, when there are fewer
    devices (the result is exact either way)."""
    return make_mesh(1, min(n_shards, len(devices)), devices)


class StreamShardedLookup(StreamLookup):
    """Stream-kernel lookup with the plane and tiles split over a ``1 x T``
    mesh. Same exact-result contract as ``StreamLookup`` (host
    verification and the exact fallback are inherited unchanged)."""

    def __init__(self, table: KmerTable, mesh: Mesh,
                 probe_window: Optional[int] = None):
        self.mesh = mesh
        self.n_shards = mesh.shape[TABLE_AXIS]
        super().__init__(table, probe_window, device=str(mesh.at(0, 0)[0]))

    def _place_plane(self, fp: np.ndarray, device: str) -> None:
        """Shard t's slots [a, b) (a multiple of SLOT_ALIGN apart) and their
        halo of w slots, on position (0, t)."""
        self.device, self._stream = self.mesh.at(0, 0)
        per = -(-self.slots // (self.n_shards * SLOT_ALIGN)) * SLOT_ALIGN
        self.ranges = [(min(t * per, self.slots),
                        min((t + 1) * per, self.slots))
                       for t in range(self.n_shards)]
        self.planes = []
        with _device_fault("upload", "stream probe"):
            for t, (a, b) in enumerate(self.ranges):
                dev, stream = self.mesh.at(0, t)
                with on_stream(stream):
                    self.planes.append(
                        torch.from_numpy(fp[a:b + self.w]).to(dev))
            self.mesh.synchronize()

    def _probe(self, tiles: np.ndarray) -> np.ndarray:
        """Each shard's columns of the tiles up (one copy a channel), one
        plane pass a shard, the packed answers back and joined in slot
        order: int32 ``[channels/4, S]``."""
        outs = []
        with _device_fault("pass", "stream probe"):
            for t, (a, b) in enumerate(self.ranges):
                dev, stream = self.mesh.at(0, t)
                with on_stream(stream):
                    part = torch.empty((self.channels, b - a),
                                       dtype=torch.uint16, device=dev)
                    for c in range(self.channels):
                        part[c].copy_(torch.from_numpy(tiles[c, a:b]))
                    outs.append(stream_probe(self.planes[t], part, self.w,
                                             self.channels))
            got = []
            for t, o in enumerate(outs):
                with on_stream(self.mesh.at(0, t)[1]):
                    got.append(o.cpu().numpy())
            return np.concatenate(got, axis=1)
