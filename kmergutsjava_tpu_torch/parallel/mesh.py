"""Device meshes of the multi-device modes, and their collectives (the
counterpart of the JAX package's ``parallel/mesh.py`` and of the
``psum``/``all_to_all``/``fetch_global`` its modes use).

A mesh is a ``data x table`` grid of torch devices:

- ``data``: the query stream (k-mers, or sequences on the fused path) is
  split along this axis;
- ``table``: the fingerprint plane is split into slot ranges along this
  axis.

Each position of the grid owns a CUDA stream (``lookup/sparse.py``
``owned_stream``), and all of its device work is issued there. A device
may stand at several positions (``EngineConfig.mesh_devices`` lists it more
than once), and then several shards share one card, each on its own
stream. No code may assume that two positions hold different devices: the
collectives below order their copies by events between the two positions'
streams, whether the devices are the same or not.

The collectives are explicit copies, in one process, with no
``torch.distributed``:

- ``psum``: a table row's answers summed on the row's first position;
- ``all_to_all``: one copy for each (source, destination) pair;
- ``fetch_global``: each data row's answer read back to the host, in row
  order.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..lookup.sparse import on_stream, owned_stream, torch_device

DATA_AXIS = "data"
TABLE_AXIS = "table"


class Mesh:
    """A ``data x table`` grid of torch devices, each position with its own
    stream (None on the CPU). ``shape`` maps each axis to its size, as a
    JAX mesh's does."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.devices = [list(row) for row in grid]
        self.shape = {DATA_AXIS: len(self.devices),
                      TABLE_AXIS: len(self.devices[0])}
        self.streams = [[owned_stream(dev) for dev in row]
                        for row in self.devices]

    def at(self, d: int, t: int) -> Tuple[torch.device, object]:
        """(device, stream) of position (d, t)."""
        return self.devices[d][t], self.streams[d][t]

    def positions(self):
        """Every (d, t) in row order."""
        return [(d, t) for d in range(self.shape[DATA_AXIS])
                for t in range(self.shape[TABLE_AXIS])]

    def synchronize(self) -> None:
        """Wait for every position's stream (set-up work: plane uploads)."""
        for row in self.streams:
            for s in row:
                if s is not None:
                    s.synchronize()


def mesh_devices(device: str, names: Optional[Sequence[str]] = None
                 ) -> List[torch.device]:
    """The devices a mesh of a config may take, in order: ``names`` (the
    config's ``mesh_devices``) when given; else, on "cuda", the config's
    card first and then the machine's other cards; on "cpu", the one CPU
    (as JAX has one CPU device unless host devices are forced). A CUDA name
    without CUDA raises. A name of another kind than ``device``'s is a
    ValueError (a cuda mesh never places a shard on the CPU)."""
    kind = torch.device(device).type
    bad = [str(n) for n in names or () if torch.device(n).type != kind]
    if bad:
        raise ValueError(f"mesh devices {bad} are not {kind} devices (the "
                         f"config's device is {device!r})")
    first = torch_device(device)
    if names:
        return [torch_device(str(n)) for n in names]
    if first.type != "cuda":
        return [first]
    if first.index is None:
        first = torch.device("cuda", torch.cuda.current_device())
    return [first] + [torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())
                      if i != first.index]


def make_mesh(data: int, table: int = 1,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """The first ``data * table`` of ``devices`` (default: the CUDA cards,
    ``mesh_devices("cuda")``) as a ``data x table`` grid, row by row.
    Raises ValueError when there are too few."""
    devices = list(devices if devices is not None
                   else mesh_devices("cuda"))
    need = data * table
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh([devices[d * table:(d + 1) * table] for d in range(data)])


def default_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Prefer a 2-way table shard when the device count allows it."""
    if n_devices % 2 == 0 and n_devices >= 2:
        return n_devices // 2, 2
    return n_devices, 1


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


def move(x: torch.Tensor, src, dst, out: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """``x``, made on position ``src`` = (device, stream), available to the
    work of position ``dst``: copied into ``out`` (on dst's device) when
    given, else to dst's device (``x`` itself when the device is the
    same). Work issued on dst's stream afterwards sees ``x``'s contents.

    Across devices torch copies on the source's current stream with a
    barrier between the two current streams, which are set to the two
    positions' here. On one device the destination's stream waits for the
    source's, and ``x`` is recorded as in use on it, so the allocator keeps
    its memory until that stream is done with it."""
    (_, s_stream), (d_dev, d_stream) = src, dst
    if d_stream is not None and x.device == d_dev \
            and s_stream is not d_stream:
        d_stream.wait_stream(s_stream)
        x.record_stream(d_stream)
    with on_stream(s_stream), on_stream(d_stream):
        if out is None:
            return x.to(d_dev, non_blocking=True)
        out.copy_(x, non_blocking=True)
        return out


def psum(mesh: Mesh, d: int, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum over the table axis of data row ``d``'s answers (``parts[t]``
    made on position (d, t)), on position (d, 0). Sums into ``parts[0]``."""
    acc = parts[0]
    dst = mesh.at(d, 0)
    for t in range(1, len(parts)):
        got = move(parts[t], mesh.at(d, t), dst)
        with on_stream(dst[1]):
            acc += got
    return acc


def all_to_all(mesh: Mesh, sends: Sequence[Sequence[torch.Tensor]],
               outs: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Over a ``1 x T`` mesh: ``sends[s][t]`` (made on shard s) is copied
    into row s of ``outs[t]`` (on shard t): one copy for each (s, t)."""
    for s, row in enumerate(sends):
        for t, x in enumerate(row):
            move(x, mesh.at(0, s), mesh.at(0, t), outs[t][s])
    return outs


def fetch_global(mesh: Mesh, rows: Sequence[torch.Tensor],
                 column: int = 0) -> np.ndarray:
    """Each data row's answer (``rows[d]`` on position (d, ``column``))
    read back to the host and joined in row order."""
    got = []
    for d, x in enumerate(rows):
        with on_stream(mesh.at(d, column)[1]):
            got.append(x.cpu().numpy())
    return np.concatenate(got)
