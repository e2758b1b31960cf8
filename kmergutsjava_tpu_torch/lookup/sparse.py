"""Sparse fingerprint lookup on a torch device (the counterpart of the JAX
package's ``lookup/xla.py`` ``XlaLookup``/``StreamingLookup`` in
fingerprint mode).

Every query probes a window of consecutive slots from its home slot, two
passes (the reformulation of the reference's streaming merge-join,
ref KmerGutsJava.java:944-1034):

- pass 1 (all queries, window ``w1``) runs on the device against the u16
  **fingerprint plane** (``value % 65535`` per slot, 65535 for empty), through
  the tile-join kernel (``lookup/tilejoin.py``): the first fingerprint match
  before an empty slot nominates a candidate, an empty slot first is a
  definitive miss (a true match implies a fingerprint match), and a window
  with neither is unresolved;
- on the host, candidates are verified against the full k-mer values and
  unresolved queries (and failed verifications) take the exact full-window
  pass over ``full_window >= max_probe`` slots; presence implies the value
  lies within max_probe slots of its home, so "any match in the window" is
  exact.

Only the fingerprint plane lives on the device; per query 6 bytes go up and
2 come back. Hit metadata is gathered from the host table.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..constants import EMPTY_KMER
from ..formats.kmer_table import KmerTable
from . import tilejoin
from .parity import LookupHits

FIRST_PASS_WINDOW = 16

# uint16 fingerprint plane: fp(value) = value % FP_MOD in [0, FP_MOD);
# FP_EMPTY is reserved for empty slots.
FP_MOD = 65535
FP_EMPTY = tilejoin.FP_EMPTY


def _round_up_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def torch_device(name: str) -> torch.device:
    """The torch device for a config name; a CUDA name on a machine where
    torch has no CUDA raises (there is no quiet fall back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but "
                           "torch.cuda.is_available() is false")
    return dev


def adaptive_w1(table: KmerTable, floor: int) -> int:
    """Pick the pass-1 window so that fully-occupied windows (which
    force the exact second pass) stay rare. Linear-probe clusters are
    heavy-tailed at high load factors: at 0.7 load ~20%+ of homes sit
    in runs of 16+ occupied slots, which would push a fifth of all
    queries to pass 2. Measured on (a sample of) the actual occupancy."""
    occ = table.occupied
    if len(occ) > 2_000_000:
        start = len(occ) // 3
        occ = occ[start: start + 1_000_000]
    occ = occ.astype(np.int32)
    c = np.concatenate([[0], np.cumsum(occ)])
    w = floor
    while w < 256:
        if len(c) <= w:
            break
        run = c[w:] - c[:-w]
        frac_full = float((run == w).mean())
        if frac_full <= 0.02:
            break
        w *= 2
    return w


def _check_int32_homes(num_sigs: int) -> None:
    if num_sigs >= 1 << 31:
        # homes travel as int32 (kernel and native verify ABI); past 2^31
        # slots the cast would wrap silently
        raise ValueError(
            f"table has {num_sigs} slots >= 2^31: int32 home indexing "
            f"would overflow — rebuild the table with fewer slots or use "
            f"the parity backend")


@contextlib.contextmanager
def _device_fault(step: str):
    """Turn a torch RuntimeError from the probe's device work into a
    KernelError, which the engine never reports as a lookup error."""
    try:
        yield
    except tilejoin.KernelError:
        raise
    except RuntimeError as ex:
        raise tilejoin.KernelError(
            f"tile-join probe {step} failed on the device: {ex}") from ex


class SparseLookup:
    """Owns the device-resident fingerprint plane and the host k-mer column.

    ``dispatch_probe`` starts one pass-1 probe on the device and
    ``resolve_probe`` copies its answer back; ``_verify_emit`` resolves an
    answer into hit columns on the host. All device work is issued on one
    CUDA stream the lookup owns, so the streaming front end's worker threads
    (each with its own torch current stream) stay ordered.
    """

    DEFAULT_CHUNK = 1 << 19  # queries per device dispatch

    def __init__(self, table: KmerTable, probe_window: Optional[int] = None,
                 chunk: Optional[int] = None, device: str = "cuda",
                 first_pass_window: int = FIRST_PASS_WINDOW):
        if table.max_probe is None:
            table.compute_max_probe()
        full_window = probe_window or max(8, _round_up_pow2(table.max_probe))
        if full_window > 256:
            raise ValueError("probe window > 256 unsupported (uint8 offsets); "
                             "rebuild the table at a lower load factor")
        _check_int32_homes(table.num_sigs)
        w1 = min(adaptive_w1(table, first_pass_window), full_window)
        s = table.num_sigs
        host_kmer = np.full(s + max(full_window, w1), EMPTY_KMER, np.int64)
        host_kmer[:s] = table.slots["kmer"]
        fp = np.full(s, FP_EMPTY, dtype=np.uint16)
        occ = table.occupied
        fp[occ] = (table.slots["kmer"][occ] % FP_MOD).astype(np.uint16)
        self._setup(table, fp, host_kmer, w1, full_window, chunk, device)

    @classmethod
    def from_numpy(cls, table: KmerTable, fp_flat: np.ndarray,
                   host_kmer: np.ndarray, w1: int, full_window: int,
                   device: str, chunk: Optional[int] = None
                   ) -> "SparseLookup":
        """Build from prepared arrays (e.g. a JAX XlaLookup's ``w1``,
        ``full_window``, ``host_kmer`` and its unpadded fingerprint plane
        ``fp[:num_sigs]``) instead of deriving them from the table."""
        _check_int32_homes(table.num_sigs)
        if not 1 <= w1 <= full_window <= 256:
            raise ValueError(f"windows w1={w1}, full={full_window} must "
                             "satisfy 1 <= w1 <= full <= 256")
        if len(fp_flat) != table.num_sigs:
            raise ValueError(f"fingerprint plane has {len(fp_flat)} slots, "
                             f"table {table.num_sigs}")
        if len(host_kmer) < table.num_sigs + full_window:
            raise ValueError("host_kmer needs full_window slots of padding")
        self = cls.__new__(cls)
        self._setup(table, np.asarray(fp_flat, np.uint16),
                    np.ascontiguousarray(host_kmer, np.int64), w1,
                    full_window, chunk, device)
        return self

    def _setup(self, table, fp_flat, host_kmer, w1, full_window, chunk,
               device) -> None:
        self.table = table
        self.num_sigs = table.num_sigs
        self.w1 = w1
        self.full_window = full_window
        self.host_kmer = host_kmer
        self.chunk = chunk if chunk is not None else self.DEFAULT_CHUNK
        self.device = torch_device(device)
        # w1 slots of FP_EMPTY past the end: every home's window is in range
        plane = np.concatenate([fp_flat, np.full(w1, FP_EMPTY, np.uint16)])
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        with self._on_stream():
            self.fp = torch.from_numpy(plane).to(self.device)

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def dispatch_probe(self, q_fp: np.ndarray, homes: np.ndarray):
        """Upload one chunk and start its pass-1 probe; returns the pending
        (off, state) device tensors for resolve_probe. A device fault
        surfacing here (an earlier launch's asynchronous error shows at the
        next CUDA call, such as this chunk's upload) is a KernelError."""
        q = torch.from_numpy(np.ascontiguousarray(q_fp, np.uint16))
        h = torch.from_numpy(np.ascontiguousarray(homes, np.int32))
        with self._on_stream(), _device_fault("dispatch"):
            return tilejoin.tilejoin_probe(self.fp, q.to(self.device),
                                           h.to(self.device), self.w1)

    def resolve_probe(self, pending):
        """Copy one dispatch_probe answer back -> (off, state) numpy u8
        arrays in the caller's query order (state 0 = exact host pass).
        A device fault surfacing here is a KernelError."""
        off, state = pending
        with self._on_stream(), _device_fault("read-back"):
            return off.cpu().numpy(), state.cpu().numpy()

    def _table_cols(self):
        """Contiguous copies of the table value columns (the structured
        slot array strides at 24 bytes, which the C ABI can't take)."""
        cols = getattr(self, "_cols", None)
        if cols is None:
            t = self.table.slots
            cols = (np.ascontiguousarray(t["otu"]),
                    np.ascontiguousarray(t["avg_from_end"]),
                    np.ascontiguousarray(t["fi"]),
                    np.ascontiguousarray(t["wt"]))
            self._cols = cols
        return cols

    def _verify_emit(self, values, homes, off, state, cnt, pos,
                     want_values: bool):
        """Resolve one dispatch's (off, state) answer into compacted hit
        columns: fingerprint-candidate verification against the full
        k-mer values, the exact full-window pass for the unresolved tail,
        and hit compaction (native gather_resolve_slots + emit_hits; the
        numpy twin below is bit-identical).

        Returns ((cnt, pos, otu, avg, fi, wt) compacted columns,
        matched values or None)."""
        from ..utils.native import load_scatter

        n = len(values)
        lib = load_scatter()
        if lib is not None and n:
            values = np.ascontiguousarray(values, np.int64)
            slots = np.empty(n, np.int64)
            k = int(lib.gather_resolve_slots(
                values, np.ascontiguousarray(homes, np.int32),
                np.ascontiguousarray(off, np.uint8),
                np.ascontiguousarray(state, np.uint8), n,
                self.host_kmer, len(self.host_kmer), self.full_window,
                slots))
            t_otu, t_avg, t_fi, t_wt = self._table_cols()
            o_cnt = np.empty(k, np.int64)
            o_pos = np.empty(k, np.int64)
            o_otu = np.empty(k, np.int32)
            o_avg = np.empty(k, np.int32)
            o_fi = np.empty(k, np.int32)
            o_wt = np.empty(k, np.float32)
            o_val = np.empty(k, np.int64)
            cnt = np.ascontiguousarray(
                np.broadcast_to(np.asarray(cnt, dtype=np.int64), (n,)))
            pos = np.ascontiguousarray(pos, np.int64)
            lib.emit_hits(values, cnt, pos, slots, n, t_otu, t_avg, t_fi,
                          t_wt, o_cnt, o_pos, o_otu, o_avg, o_fi, o_wt,
                          o_val)
            return ((o_cnt, o_pos, o_otu, o_avg, o_fi, o_wt),
                    o_val if want_values else None)
        off64 = off.astype(np.int64)
        has_cand = (state & 1) != 0
        empty_any = (state & 2) != 0
        found = np.zeros(n, dtype=bool)
        ci = np.nonzero(has_cand)[0]
        slots_c = homes[ci].astype(np.int64) + off64[ci]
        verified = self.host_kmer[slots_c] == values[ci]
        found[ci] = verified
        unresolved = np.zeros(n, dtype=bool)
        unresolved[ci] = ~verified
        unresolved[~has_cand & ~empty_any] = True
        todo = np.nonzero(unresolved)[0]
        if len(todo):
            f2, o2 = self._host_full_window(values, homes, todo)
            found[todo] = f2
            off64[todo] = o2
        mask = found
        slots = homes[mask].astype(np.int64) + off64[mask]
        t = self.table.slots
        cntb = np.broadcast_to(np.asarray(cnt, dtype=np.int64), (n,))
        piece = (cntb[mask].copy(), np.asarray(pos)[mask].astype(np.int64),
                 t["otu"][slots].copy(), t["avg_from_end"][slots].copy(),
                 t["fi"][slots].copy(), t["wt"][slots].copy())
        return piece, (values[mask].copy() if want_values else None)

    def _host_full_window(self, values, homes, todo):
        """Exact full-window probe on the host k-mer array (for unresolved
        queries). W flat gathers instead of one [N, W] advanced-index
        gather: the latter materializes N*W int64 temporaries."""
        idx = homes[todo].astype(np.int64)
        v = values[todo]
        found = np.zeros(len(idx), dtype=bool)
        off = np.zeros(len(idx), dtype=np.uint8)
        hk = self.host_kmer
        # reverse order + overwrite == first-match offset
        for l in range(self.full_window - 1, -1, -1):
            m = hk[idx + l] == v
            off[m] = l
            found |= m
        return found, np.where(found, off, 0)


class StreamingLookup:
    """Overlap the prepare phase with device probing.

    The reference runs prepare -> lookup strictly sequentially (ref
    :776-803). The window probe has no ordering constraint, so the feeder
    dispatches a probe chunk the moment enough query k-mers exist. Only
    resolved HITS are retained per chunk, so memory is bounded by the hit
    count. Duck-types the query store's ``add_batch`` so the prepare
    functions feed it directly.

    Threads (all queues bounded, so backpressure caps memory): the caller's
    thread parses/encodes and hands raw chunks to a *dispatch* worker
    (upload + kernel launch on the lookup's stream); a *resolve* worker
    copies answers back and verifies them on the host. A worker's error is
    raised at finish() (or at the next add_batch that finds a queue full).
    """

    MAX_IN_FLIGHT = 4

    def __init__(self, lk: SparseLookup, compute_kmers_found: bool = False):
        import queue
        import threading

        self.lk = lk
        self.compute_kmers_found = compute_kmers_found
        self._buf: list = []
        self._count = 0
        self._pieces: list = []
        self._matched_values: list = []
        self._worker_error = None
        self._queue = queue.Queue(maxsize=self.MAX_IN_FLIGHT)
        self._dq = queue.Queue(maxsize=2)

        def drain(q, work):
            while True:
                item = q.get()
                if item is None:
                    return
                try:
                    work(*item)
                except BaseException as ex:  # surfaced at finish()
                    # both workers may fail; a device fault is never masked
                    if not isinstance(self._worker_error,
                                      tilejoin.KernelError):
                        self._worker_error = ex
                    return

        self._worker = threading.Thread(
            target=drain, args=(self._queue, self._resolve_item), daemon=True)
        self._dispatcher = threading.Thread(
            target=drain, args=(self._dq, self._dispatch_chunk), daemon=True)
        self._worker.start()
        self._dispatcher.start()

    # --- store interface ---
    def add_batch(self, values: np.ndarray, cnt_id, pos: np.ndarray) -> None:
        n = len(values)
        if n == 0:
            return
        cnt = np.broadcast_to(np.asarray(cnt_id, dtype=np.int64), (n,))
        self._buf.append((np.asarray(values, dtype=np.int64), cnt,
                          np.asarray(pos, dtype=np.int64)))
        self._count += n
        while self._count >= self.lk.chunk:
            self._put_checked(self._dq, self._take(self.lk.chunk))

    def _put_checked(self, q, item) -> None:
        """Bounded put that can't deadlock on a dead consumer: re-check the
        shared worker error whenever the queue stays full."""
        import queue

        while True:
            if self._worker_error is not None:
                raise self._worker_error
            try:
                q.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    def _take(self, k: int):
        out_v, out_c, out_p = [], [], []
        got = 0
        while got < k and self._buf:
            v, c, p = self._buf[0]
            need = k - got
            if len(v) <= need:
                out_v.append(v)
                out_c.append(c)
                out_p.append(p)
                got += len(v)
                self._buf.pop(0)
            else:
                out_v.append(v[:need])
                out_c.append(c[:need])
                out_p.append(p[:need])
                self._buf[0] = (v[need:], c[need:], p[need:])
                got = k
        self._count -= got
        return (np.concatenate(out_v), np.concatenate(out_c),
                np.concatenate(out_p))

    def _dispatch_chunk(self, values, cnt, pos) -> None:
        homes = (values % np.int64(self.lk.num_sigs)).astype(np.int32)
        q_fp = (values % FP_MOD).astype(np.uint16)
        out = self.lk.dispatch_probe(q_fp, homes)
        self._put_checked(self._queue, (values, cnt, pos, homes, out))

    def _resolve_item(self, values, cnt, pos, homes, out) -> None:
        off, state = self.lk.resolve_probe(out)
        piece, mv = self.lk._verify_emit(values, homes, off, state, cnt,
                                         pos, self.compute_kmers_found)
        self._pieces.append(piece)
        if self.compute_kmers_found:
            self._matched_values.append(mv)

    def partial_hits(self) -> LookupHits:
        """Hits resolved so far (for the reference's catch-and-continue
        behavior on lookup errors, ref :797-802)."""
        return self._assemble()

    def finish(self) -> LookupHits:
        if self._count:
            self._put_checked(self._dq, self._take(self._count))
        self._put_checked(self._dq, None)
        self._dispatcher.join()
        self._put_checked(self._queue, None)
        self._worker.join()
        if self._worker_error is not None:
            raise self._worker_error
        return self._assemble()

    def _assemble(self) -> LookupHits:
        if not self._pieces:
            z = np.zeros(0)
            return LookupHits.from_lists(z, z, z, z, z, z,
                                         0 if self.compute_kmers_found else -1)
        cols = [np.concatenate(c) for c in zip(*self._pieces)]
        kf = (int(np.unique(np.concatenate(self._matched_values)).size)
              if self.compute_kmers_found else -1)
        return LookupHits(cols[0].astype(np.int64), cols[1].astype(np.int64),
                          cols[2], cols[3], cols[4], cols[5], kf)
