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

A mesh may also span the processes of a ``torch.distributed`` run
(``make_mesh(..., distributed=True)``, the counterpart of a JAX mesh over
``jax.devices()`` after ``jax.distributed.initialize``): each position
belongs to one rank, the positions going to the ranks in global order (rank
r's devices are the positions ``r * k .. r * k + k - 1`` of the row-major
grid, k devices a rank), and each rank runs the work of its own positions
(``positions()``). A remote position has no device here (``at`` gives
``(None, None)``).

The collectives are explicit copies between the positions of one process;
across processes they take the process-group form:

- ``psum``: a table row's answers summed on the row's first position, with
  an ``all_reduce`` over the row's ranks where the row spans several;
- ``all_to_all``: one copy for each (source, destination) pair of one
  process, an ``all_to_all_single`` (split sizes a pair of ranks) for the
  pairs across processes;
- ``fetch_global``: each data row's answer read back to the host, in row
  order; across processes the rows are all-gathered (``gather_host``,
  padded to one length), so every rank gets the whole answer.

Under gloo the collectives stage CUDA tensors through host memory (gloo's
``all_to_all_single`` takes CPU tensors only; NCCL refuses two ranks on
one card, so ranks that share a card run gloo); under NCCL they run on the
card. That is the transport the caller chose, not a fallback: a failed
collective raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..lookup.sparse import on_stream, owned_stream, torch_device

DATA_AXIS = "data"
TABLE_AXIS = "table"


class Mesh:
    """A ``data x table`` grid of torch devices, each position with its own
    stream (None on the CPU). ``shape`` maps each axis to its size, as a
    JAX mesh's does. ``ranks`` (a grid of the same shape) gives the rank
    of each position of a mesh over processes (None: one process); a
    position of another rank has device None. Every rank must build the
    mesh, in the same order as its other meshes: the process groups of the
    rows that span ranks are made here, on every rank."""

    def __init__(self, grid: Sequence[Sequence[Optional[torch.device]]],
                 ranks: Optional[Sequence[Sequence[int]]] = None):
        self.devices = [list(row) for row in grid]
        self.shape = {DATA_AXIS: len(self.devices),
                      TABLE_AXIS: len(self.devices[0])}
        self.streams = [[None if dev is None else owned_stream(dev)
                         for dev in row] for row in self.devices]
        self.ranks = None if ranks is None else [list(r) for r in ranks]
        self.rank = None
        # per data row: None (its positions are on one rank) or the group
        # of its ranks (the default group, None, when that is all of them)
        self.row_groups = [None] * self.shape[DATA_AXIS]
        self.row_spans = [False] * self.shape[DATA_AXIS]
        if self.ranks is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank()
            world = dist.get_world_size()
            for d, row in enumerate(self.ranks):
                members = sorted(set(row))
                if len(members) > 1:
                    self.row_spans[d] = True
                    self.row_groups[d] = (None if len(members) == world
                                          else dist.new_group(members))

    @property
    def distributed(self) -> bool:
        """True for a mesh over the processes of a distributed run."""
        return self.ranks is not None

    def local(self, d: int, t: int) -> bool:
        """Whether position (d, t) belongs to this process."""
        return self.ranks is None or self.ranks[d][t] == self.rank

    def at(self, d: int, t: int) -> Tuple[torch.device, object]:
        """(device, stream) of position (d, t); (None, None) for a position
        of another process."""
        return self.devices[d][t], self.streams[d][t]

    def positions(self):
        """This process's (d, t) in row order (every one, in one process):
        the positions whose work it runs."""
        return [(d, t) for d in range(self.shape[DATA_AXIS])
                for t in range(self.shape[TABLE_AXIS]) if self.local(d, t)]

    def one_process(self, what: str) -> None:
        """Refuse a mesh over processes for a mode that has no
        process-group form (ValueError)."""
        if self.distributed:
            raise ValueError(f"{what} runs on a mesh of one process only "
                             "(see ROADMAP.md)")

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
              devices: Optional[Sequence[torch.device]] = None,
              distributed: bool = False) -> Mesh:
    """The first ``data * table`` of ``devices`` (default: the CUDA cards,
    ``mesh_devices("cuda")``) as a ``data x table`` grid, row by row.
    Raises ValueError when there are too few.

    With ``distributed`` the grid spans every process of the default
    ``torch.distributed`` group: ``devices`` are this process's, every
    process gives as many (checked), and the positions of the first
    ``data * table`` devices of all ranks, in rank order, make the grid.
    Every rank must call it."""
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else mesh_devices("cuda"))]
    need = data * table
    if not distributed:
        if len(devices) < need:
            raise ValueError(f"need {need} devices, have {len(devices)}")
        return Mesh([devices[d * table:(d + 1) * table]
                     for d in range(data)])
    import torch.distributed as dist

    world, rank, k = dist.get_world_size(), dist.get_rank(), len(devices)
    counts = [None] * world
    dist.all_gather_object(counts, k)
    if len(set(counts)) != 1:
        raise ValueError(f"the ranks hold {counts} mesh devices: every rank "
                         "must give as many")
    if world * k < need:
        raise ValueError(f"need {need} devices, have {k} on each of "
                         f"{world} processes")
    owner = [i // k for i in range(need)]
    grid = [devices[i - rank * k] if owner[i] == rank else None
            for i in range(need)]
    return Mesh([grid[d * table:(d + 1) * table] for d in range(data)],
                ranks=[owner[d * table:(d + 1) * table]
                       for d in range(data)])


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


def _collective_device(mesh: Mesh) -> torch.device:
    """Where this rank's collectives run: the host under gloo, this rank's
    first card under NCCL."""
    import torch.distributed as dist

    if dist.get_backend() != "nccl":
        return torch.device("cpu")
    for d, t in mesh.positions():
        return mesh.at(d, t)[0]
    return torch.device("cuda", torch.cuda.current_device())


def _to_collective(mesh: Mesh, x: torch.Tensor, pos) -> torch.Tensor:
    """``x``'s bytes (made on position ``pos`` = (device, stream)) on the
    collective device, ready for a collective issued on that device's
    current stream: copied to the host under gloo, else ordered after
    ``pos``'s stream."""
    dev, stream = pos
    cdev = _collective_device(mesh)
    if cdev.type == "cpu":
        with on_stream(stream):
            return x.contiguous().reshape(-1).view(torch.uint8).cpu()
    current = torch.cuda.current_stream(cdev)
    if stream is not None and stream is not current:
        current.wait_stream(stream)
        x.record_stream(current)
    return x.contiguous().reshape(-1).view(torch.uint8).to(cdev)


def _from_collective(data: torch.Tensor, out: torch.Tensor, pos) -> None:
    """Bytes a collective delivered, into ``out`` on position ``pos``."""
    dev, stream = pos
    if stream is not None and data.device.type == "cuda":
        stream.wait_stream(torch.cuda.current_stream(data.device))
        data.record_stream(stream)
    with on_stream(stream):
        out.reshape(-1).view(torch.uint8).copy_(data, non_blocking=True)


def psum(mesh: Mesh, d: int, parts: Sequence[Optional[torch.Tensor]]
         ) -> Optional[torch.Tensor]:
    """The sum over the table axis of data row ``d``'s answers (``parts[t]``
    made on position (d, t); None at the positions of other processes), on
    the row's first position of this process. Sums into that part. Where
    the row spans processes, its ranks then ``all_reduce`` the sum over the
    row's group, so each holds the whole sum; a process with no position in
    the row returns None."""
    mine = [t for t in range(len(parts)) if mesh.local(d, t)]
    if not mine:
        return None
    acc = parts[mine[0]]
    dst = mesh.at(d, mine[0])
    for t in mine[1:]:
        got = move(parts[t], mesh.at(d, t), dst)
        with on_stream(dst[1]):
            acc += got
    if mesh.row_spans[d]:
        import torch.distributed as dist

        staged = _to_collective(mesh, acc, dst).view(acc.dtype)
        dist.all_reduce(staged, group=mesh.row_groups[d])
        _from_collective(staged.view(torch.uint8), acc, dst)
    return acc


def all_to_all(mesh: Mesh, sends: Sequence[Optional[Sequence[torch.Tensor]]],
               outs: Sequence[Optional[torch.Tensor]]
               ) -> Sequence[Optional[torch.Tensor]]:
    """Over a ``1 x T`` mesh: ``sends[s][t]`` (made on shard s) is copied
    into row s of ``outs[t]`` (on shard t): one copy for each (s, t) of
    this process. On a mesh over processes ``sends[s]`` and ``outs[t]`` are
    None for the shards of other ranks, and the pairs across processes go
    in one ``all_to_all_single`` of their bytes (the input split a
    destination rank, the output split a source rank, each in (s, t)
    order). Every rank of the mesh must call it."""
    n = mesh.shape[TABLE_AXIS]
    mine = [t for t in range(n) if mesh.local(0, t)]
    for s in mine:
        for t in mine:
            move(sends[s][t], mesh.at(0, s), mesh.at(0, t), outs[t][s])
    if not mesh.distributed:
        return outs
    import torch.distributed as dist

    owner = mesh.ranks[0]
    world = dist.get_world_size()
    cdev = _collective_device(mesh)
    pieces, in_split = [], [0] * world
    for r in range(world):
        if r == mesh.rank:
            continue
        for s in mine:
            for t in range(n):
                if owner[t] == r:
                    x = _to_collective(mesh, sends[s][t], mesh.at(0, s))
                    pieces.append(x)
                    in_split[r] += x.numel()
    out_split, targets = [0] * world, []
    for s in range(n):
        if owner[s] == mesh.rank:
            continue
        for t in mine:
            nbytes = outs[t][s].numel() * outs[t][s].element_size()
            out_split[owner[s]] += nbytes
            targets.append((outs[t][s], nbytes, mesh.at(0, t)))
    send = (torch.cat(pieces) if pieces
            else torch.empty(0, dtype=torch.uint8, device=cdev))
    recv = torch.empty(sum(out_split), dtype=torch.uint8, device=cdev)
    dist.all_to_all_single(recv, send, out_split, in_split)
    at = 0
    for out, nbytes, pos in targets:
        _from_collective(recv[at:at + nbytes], out, pos)
        at += nbytes
    return outs


def gather_host(mesh: Mesh, pieces: Dict[object, np.ndarray],
                keys: Sequence[object], dtype) -> Dict[object, np.ndarray]:
    """Every process's host arrays, on every process: ``pieces`` maps some
    of ``keys`` (the same list on every rank, each key held by one rank)
    to this process's 1-D arrays of ``dtype``; returns all of them. The
    sizes and holders go round in an ``all_reduce``, the bytes in an
    ``all_gather`` of each rank's pieces, padded to one length. Every rank
    must call it."""
    import torch.distributed as dist

    world, cdev = dist.get_world_size(), _collective_device(mesh)
    meta = torch.zeros((2, len(keys)), dtype=torch.int64)
    for i, k in enumerate(keys):
        if k in pieces:
            meta[0, i] = pieces[k].nbytes
            meta[1, i] = mesh.rank + 1
    meta = meta.to(cdev)
    dist.all_reduce(meta)
    sizes, holder = (meta.cpu().numpy() + np.array([[0], [-1]]))
    if (holder < 0).any():
        raise ValueError("gather_host: a key that no rank holds")
    per_rank = [int(sizes[holder == r].sum()) for r in range(world)]
    width = max(per_rank + [1])
    mine = np.zeros(width, np.uint8)
    at = 0
    for k in keys:
        if k in pieces:
            b = np.ascontiguousarray(pieces[k]).view(np.uint8).reshape(-1)
            mine[at:at + b.size] = b
            at += b.size
    got = [torch.empty(width, dtype=torch.uint8, device=cdev)
           for _ in range(world)]
    dist.all_gather(got, torch.from_numpy(mine).to(cdev))
    host = [g.cpu().numpy() for g in got]
    out, cursor = {}, [0] * world
    for i, k in enumerate(keys):
        r, nb = int(holder[i]), int(sizes[i])
        out[k] = host[r][cursor[r]:cursor[r] + nb].copy().view(dtype)
        cursor[r] += nb
    return out


def fetch_global(mesh: Mesh, rows: Sequence[Optional[torch.Tensor]],
                 column: int = 0) -> np.ndarray:
    """Each data row's answer (``rows[d]`` on position (d, ``column``))
    read back to the host and joined in row order. On a mesh over
    processes each rank reads back the rows whose (d, ``column``) it holds
    (others may be None) and the rows are all-gathered, so every rank gets
    the whole answer, as the JAX package's ``fetch_global``."""
    got = {}
    for d, x in enumerate(rows):
        if mesh.local(d, column):
            with on_stream(mesh.at(d, column)[1]):
                got[d] = x.cpu().numpy()
    if mesh.distributed:
        # a rank that holds no row takes the step's int32 answers' type
        dtype = next((g.dtype for g in got.values()), np.dtype(np.int32))
        got = gather_host(mesh, {d: g.reshape(-1) for d, g in got.items()},
                          range(len(rows)), dtype)
    return np.concatenate([got[d] for d in range(len(rows))])
