"""The fused device path: the "spmd" engine backend on one card or over a
``data x table`` mesh (the counterpart of the JAX package's
``models/spmd.py``).

Every other backend splits the reference's phases (ref
KmerGutsJava.java:776-803) between a host prepare and a device probe over a
stream of query k-mers. This backend sends raw ASCII sequence bytes to the
device, where a step (``parallel/annotate_step.py``) runs one launch of the
fused kernel a batch of a power-of-two length bucket (encode, six-frame
translation, 8-mer packing, homes and fingerprints, and the probe;
``parallel/fused_probe.py``); only the probe's answer comes back, and the
host verifies its candidates. Records longer than LONG_AA / LONG_NT go through windows
(``parallel/seq_windows.py``).

Which step a mesh shape takes: the mesh is ``cfg.mesh_shape`` or
``default_mesh_shape`` of the devices (``parallel/mesh.py``; one CPU, or
every CUDA card, or ``cfg.mesh_devices``). A (1, 1) mesh, the default on
one card or the CPU, runs the one-device step: the fused kernel in the
sparse probe B1's form (``lookup/tilejoin.py``) at the full window. Any
other shape runs the JAX step's body: each batch's rows split over the
data axis, the fused kernel in the shard probe B12's form
(``parallel/shard_probe.py``) on every position's rows against its table
shard, the answers summed over the table axis; that answer is the JAX
step's, bit for bit. A caller may give ``SpmdProgram`` a mesh over the
processes of a distributed run (as the JAX program's mesh spans them after
``jax.distributed.initialize``): every rank consumes the same records in
the same batches, runs its own positions, and reads every answer back in
the same order (``MeshAnswer.read``, an all-gather), so every rank's hits
are the same. The engine's own meshes stay in one process.

Hits come back as (container, position, metadata) columns that feed the
standard grouping machine, so reports are byte-identical to every other
backend's. In debug mode the matched values are recomputed on the host at
the hit coordinates for the reference's "Kmers found" count.

On a (1, 1) mesh, B1's contract is not the JAX step's ``_local_probe``,
and the two give the same verified hits. ``_local_probe`` answers the first
slot of the ``pw``-slot window that holds the query's fingerprint and
ignores empty slots; B1 answers the first event, a fingerprint (state 1) or an empty slot
(state 2), and state 0 when there is neither. The host verifies a
candidate against the query's value and, on a fingerprint collision,
re-probes the whole window for the value (``verify_candidates``). A table
places a value at the first free slot from its home (no wrap), so a value
never lies past an empty slot of its probe run, and ``pw >= max_probe``
holds it within the window. Hence: where B1 finds an empty slot first, the
value is absent, and a candidate ``_local_probe`` might name past that
empty slot fails verification and its re-probe finds nothing; where B1
finds a fingerprint first, it is the same slot ``_local_probe`` names
(both are the first fingerprint, and no empty slot precedes it); state 0
means no fingerprint within the window, so no value either, and the home
goes to no host pass. The raw device answers can differ; the verified hits
cannot. The tests compare verified hits and reports.

The batching constants are the JAX package's, chosen on a TPU, and are
kept until they are measured on the card (ROADMAP.md).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np

from ..constants import (AA_OFF_LUT, CODON_AA_OFF, COMPL_DNA_CODE_LUT,
                         DNA_CODE_LUT, INVALID_AA, K, POW20)
from ..formats.kmer_table import KmerTable
from ..lookup.parity import LookupHits
from ..lookup.sparse import _device_fault, on_stream
from .prepare import MAX_CELLS, BucketQueue, Prepared, _seq_to_ascii

LONG_AA = 8192    # proteins longer than this go through 7-aa-overlap windows
LONG_NT = 24576   # contigs longer than this go through 24-nt-overlap windows
WIN_AA = 4096
WIN_NT = 12288    # multiple of 3
MAX_IN_FLIGHT = 4


def _host_frames(a: np.ndarray) -> np.ndarray:
    """Numpy 6-frame translation of one contig (reference row order
    +0+1+2-0-1-2), used only for debug-mode hit-value recompute."""
    L = len(a)
    m0 = L // 3
    rows = np.full((6, m0 + K), INVALID_AA, np.uint8)
    for strand, codes in ((0, DNA_CODE_LUT[a].astype(np.int32)),
                          (1, COMPL_DNA_CODE_LUT[a][::-1].astype(np.int32))):
        for f in range(3):
            p = (L - f) // 3
            if p <= 0:
                continue
            c1 = codes[f: f + 3 * p: 3]
            c2 = codes[f + 1: f + 1 + 3 * p: 3]
            c3 = codes[f + 2: f + 2 + 3 * p: 3]
            ok = (c1 < 4) & (c2 < 4) & (c3 < 4)
            rows[strand * 3 + f, :p] = np.where(
                ok, CODON_AA_OFF[np.where(ok, c1 * 16 + c2 * 4 + c3, 0)],
                INVALID_AA)
    return rows


def _values_at(offs_rows: np.ndarray, cc: np.ndarray) -> np.ndarray:
    """Packed k-mer values at window starts ``cc`` of per-hit offset rows
    (offs_rows[i] is the aa-offset row the i-th hit indexes into)."""
    vals = np.zeros(len(cc), np.int64)
    for k in range(K):
        vals += offs_rows[np.arange(len(cc)), cc + k].astype(np.int64) \
            * int(POW20[k])
    return vals


class SpmdProgram:
    """Cacheable device state of the fused path: the mesh, the table's
    fingerprint plane on its devices, and the step of the run's mode; on a
    (1, 1) mesh, the CUDA stream all of the program's device work is issued
    on (a larger mesh's positions each issue on their own). Shared across
    engine runs (a server reuses it per table, as the other backends'
    lookups); per-run bookkeeping lives in SpmdAnnotator. Too few devices
    for the mesh, or a window past 128, is a ValueError.

    ``mesh`` (default: one made from ``cfg``, in this process) may be a
    caller's, a mesh over the processes of a distributed run among them
    (``make_mesh(..., distributed=True)``): then every rank builds the
    program, consumes the same records in the same batches, runs its own
    positions and decodes the whole answer, so every rank's hits are the
    same. The engine's own meshes stay in one process."""

    def __init__(self, table: KmerTable, cfg, mesh=None):
        from ..parallel import annotate_step as st
        from ..parallel.mesh import (DATA_AXIS, TABLE_AXIS,
                                     default_mesh_shape, make_mesh,
                                     mesh_devices)

        if table.max_probe is None:
            table.compute_max_probe()
        pw = cfg.probe_window or max(8, table.max_probe)
        if pw > 128:
            raise ValueError("spmd backend requires probe_window <= 128; "
                             "rebuild the table at a lower load factor")
        if table.num_sigs + pw >= 2**31 - 1:
            # homes travel as int32, as in the JAX package's step
            raise ValueError("spmd backend encodes slots as int32; "
                             f"num_sigs={table.num_sigs} would overflow")
        self.table = table
        self.aa = bool(cfg.aa)
        self.pw = pw
        if mesh is None:
            devices = mesh_devices(cfg.device, cfg.mesh_devices)
            mesh = make_mesh(*(cfg.mesh_shape
                               or default_mesh_shape(len(devices))),
                             devices=devices)
        self.mesh = mesh
        self.mesh_shape = (mesh.shape[DATA_AXIS], mesh.shape[TABLE_AXIS])
        # a (1, 1) mesh over processes takes the mesh step: the ranks
        # without its position still read every answer
        self.one_device = self.mesh_shape == (1, 1) and not mesh.distributed
        if self.one_device:
            self.device, self.stream = self.mesh.at(0, 0)
            with self.device_work("plane upload"):
                make = st.make_annotate_step if cfg.aa else st.make_dna_step
                self.step, self.planes = make(table, pw, self.device)
        else:
            self.stream = None
            with self.device_work("plane upload"):
                make = (st.make_sharded_annotate_step if cfg.aa
                        else st.make_sharded_dna_step)
                self.step, self.planes = make(self.mesh, table, pw)
        self._wstep = None  # windowed DNA step (built on first long contig)
        self._win_nt = None

    @contextlib.contextmanager
    def device_work(self, what: str):
        """Issue the enclosed work on the program's stream; a torch
        RuntimeError from the device becomes a KernelError."""
        with on_stream(self.stream), _device_fault(what, "fused step"):
            yield

    def windowed_dna(self, win_nt: int):
        from ..parallel import seq_windows

        if self._wstep is None or self._win_nt != win_nt:
            if self.one_device:
                self._wstep = seq_windows.make_windowed_dna_step(
                    self.table, self.pw, win_nt, self.planes)
            else:
                self._wstep = seq_windows.make_sharded_windowed_dna_step(
                    self.mesh, self.table, self.pw, win_nt, self.planes)
            self._win_nt = win_nt
        return self._wstep


class SpmdAnnotator:
    """Host driver for the fused device path (one engine run)."""

    def __init__(self, table: KmerTable, cfg,
                 program: Optional[SpmdProgram] = None,
                 batch_rows: int = 512, min_bucket: int = 256):
        self.prog = program if program is not None else SpmdProgram(table,
                                                                    cfg)
        self.table = table
        self.cfg = cfg
        self.step, self.planes = self.prog.step, self.prog.planes
        # MAX_CELLS (models/prepare.py) bounds a dispatch's batch cells
        self._queue = BucketQueue(batch_rows, min_bucket, MAX_CELLS)
        self._inflight: list = []   # (bases, lens, mats, (answer, shape))
        self._pieces: list = []     # decoded (cnt, pos, otu, avg, fi, wt)
        self._val_pieces: list = []  # debug: matched values per piece
        self.debug_values = bool(cfg.debug)

    # --- prepare phase: parse + batch + dispatch ---

    def consume(self, records) -> Prepared:
        prep = Prepared(frames=1 if self.cfg.aa else 6)
        long_limit = LONG_AA if self.cfg.aa else LONG_NT
        for rec in records:
            a = _seq_to_ascii(rec.seq)
            base = prep.add_record(rec.id, len(rec.seq))
            if len(a) > long_limit:
                self._dispatch_long(base, a)
                continue
            batch = self._queue.add(base, a)
            if batch is not None:
                self._flush(*batch)
        for batch in self._queue.drain():
            self._flush(*batch)
        return prep

    def _flush(self, bases: np.ndarray, mat: np.ndarray, lens: np.ndarray
               ) -> None:
        with self.prog.device_work("dispatch"):
            out = self.step(self.planes["fp"], mat, lens)
        self._inflight.append((bases, lens, mat, out))
        while len(self._inflight) >= MAX_IN_FLIGHT:
            self._decode(self._inflight.pop(0))

    def _decode(self, item) -> None:
        from ..ops.hostvalues import aa_values_at, dna_values_at
        from ..parallel.annotate_step import candidates
        from ..parallel.sharded_lookup import gather_hit_metadata

        bases, lens, mat, out = item
        with self.prog.device_work("read-back"):
            idx, slots = candidates(out, self.table.num_sigs)
        # the device answers are fingerprint CANDIDATES: recompute the
        # query values at the candidate coordinates (O(hits x K) gathers,
        # no host re-translation; ops/hostvalues.py), verify against the
        # table's kmer column, and resolve the rare collisions exactly
        # (parallel/sharded_lookup.verify_candidates)
        if self.cfg.aa:
            rr, cc = idx
            cnt = bases[rr]
            vals = aa_values_at(mat, rr, cc)
        else:
            rr, gg, cc = idx
            cnt = bases[rr] + gg
            vals = dna_values_at(mat, lens, rr, gg, cc)
        found, otu, avg, fi, wt = gather_hit_metadata(
            self.table, slots(vals), values=vals, probe_window=self.prog.pw)
        if not found.all():
            cnt, cc, vals = cnt[found], cc[found], vals[found]
            otu, avg, fi, wt = otu[found], avg[found], fi[found], wt[found]
        self._pieces.append((cnt, cc.astype(np.int64), otu, avg, fi, wt))
        if self.debug_values and len(cc):
            self._val_pieces.append(vals)

    def _dispatch_long(self, base: int, a: np.ndarray) -> None:
        """Windowed path for one long record (synchronous; long records are
        rare by definition of the threshold)."""
        from ..parallel.seq_windows import (windowed_contig_hits,
                                            windowed_protein_hits)

        if self.cfg.aa:
            with self.prog.device_work("windowed step"):
                pos, otu, avg, fi, wt = windowed_protein_hits(
                    self.step, self.planes, self.table, a, WIN_AA,
                    probe_window=self.prog.pw)
            cnt = np.full(len(pos), base, np.int64)
            if self.debug_values and len(pos):
                offs = AA_OFF_LUT[a]
                self._val_pieces.append(_values_at(
                    np.broadcast_to(offs, (len(pos), len(offs))), pos))
        else:
            with self.prog.device_work("windowed step"):
                wstep, wplanes = self.prog.windowed_dna(WIN_NT)
                g, pos, otu, avg, fi, wt = windowed_contig_hits(
                    wstep, wplanes, self.table, a, WIN_NT,
                    probe_window=self.prog.pw)
            cnt = base + g
            if self.debug_values and len(pos):
                frames = _host_frames(a)
                width = frames.shape[1]
                offs_rows = np.zeros((len(pos), width), np.uint8)
                for i, gi in enumerate(g):
                    offs_rows[i] = frames[gi]
                self._val_pieces.append(_values_at(offs_rows, pos))
        self._pieces.append((cnt, pos.astype(np.int64), otu, avg, fi, wt))

    # --- lookup phase: drain + assemble ---

    def finish(self) -> LookupHits:
        while self._inflight:
            self._decode(self._inflight.pop(0))
        return self._assemble()

    def partial_hits(self) -> LookupHits:
        """Hits decoded so far (reference catch-and-continue, ref :797-802)."""
        return self._assemble()

    def _assemble(self) -> LookupHits:
        if not self._pieces:
            z = np.zeros(0)
            return LookupHits.from_lists(z, z, z, z, z, z,
                                         0 if self.debug_values else -1)
        cols = [np.concatenate(c) for c in zip(*self._pieces)]
        kf = -1
        if self.debug_values:
            kf = (int(np.unique(np.concatenate(self._val_pieces)).size)
                  if self._val_pieces else 0)
        return LookupHits(cols[0].astype(np.int64), cols[1].astype(np.int64),
                          cols[2], cols[3], cols[4],
                          cols[5].astype(np.float32), kf)
