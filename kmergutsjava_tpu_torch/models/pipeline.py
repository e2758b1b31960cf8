"""End-to-end annotation engine (the reference's run(), in three phases).

Three phases with wall-clock info lines, mirroring
KmerGutsJava.java:742-820:

1. prepare  — FASTA -> 8-mer encode (6-frame translation in DNA mode) on
   the host, or on the device with ``--prepare jax`` -> query k-mer stream
2. lookup   — probe the signature table (sparse tile-join probe | dense
   stream probe | merge-join block probe | parity scan)
3. group    — sequential call state machine -> report text (on the host,
   or with ``grouping_impl="scan"`` the grouping kernel on the device)

The ``spmd`` backend fuses the first two on the device (models/spmd.py):
raw sequence bytes go up, one kernel makes their k-mer windows and probes
for them there, and only candidates come back for host verification.

With a mesh (``mesh_shape``, over ``mesh_devices``: ``parallel/mesh.py``)
the lookup spreads over several devices, in one process: the
``replicated``, ``sharded`` and ``routed`` backends (fed by the
bounded-RAM store, as in the JAX engine), and ``xla``, ``stream``, ``auto``
and ``spmd`` with the plane split over the mesh's table shards.

Report text is bit-identical to the reference in non-debug mode; info lines
(temp dir, phase timings, progress) follow the reference's printInfoLine
routing (ref :891-898): into the report only when debug, to stdout only when
the report goes to a file.
"""
from __future__ import annotations

import sys
import traceback
from typing import Dict, Optional, TextIO

import numpy as np

from ..calls import scan_machine
from ..calls.grouping import (GroupingParams, Report, process_aa_seq,
                              process_dna_seq)
from ..config import EngineConfig
from ..constants import ENTRY_SIZE
from ..formats.fasta import read_fasta
from ..formats.function_index import load_function_index
from ..formats.kmer_table import read_table, resolve_table_files
from ..lookup import blockprobe
from ..lookup import stream as stream_kernel
from ..lookup import tilejoin
from ..lookup.blockprobe import BlockProbeLookup
from ..lookup.parity import LookupHits, TableTruncatedError, lookup_stream
from ..lookup.sparse import SparseLookup, StreamingLookup, torch_device
from ..lookup.store import QueryKmerStore
from ..lookup.stream import StreamingStreamLookup, StreamLookup
from ..lookup.tilejoin import KernelError
from ..ops import kmer_windows
from ..parallel import fused_probe, route_bins, shard_probe
from ..parallel.mesh import default_mesh_shape, mesh_devices
from ..utils.timing import maybe_profile, record, span
from .prepare import Prepared

# Device-resident lookups are expensive to (re)build: a host->device plane
# transfer. One-slot cache keyed by table file identity + lookup-shaping
# config, so repeated runs in one process reuse the warm state.
_LOOKUP_CACHE: Dict[tuple, object] = {}
_TABLE_CACHE: Dict[tuple, object] = {}

# Backend-'auto' density crossover: the stream kernel serves the run when
# the query count exceeds num_sigs / DENSITY_CROSSOVER. The JAX package
# derived 2.5 on a TPU v5e; it is kept so that the port picks the backend
# the JAX package picks. Both paths are exact, so it only moves speed.
DENSITY_CROSSOVER = 2.5
# the backends that only the store feeds (the JAX engine's _lookup)
MESH_LOOKUPS = ("replicated", "sharded", "routed")


def _replace_backend(cfg: EngineConfig, backend: str) -> EngineConfig:
    import dataclasses

    return dataclasses.replace(cfg, backend=backend)


def _auto_candidates(cfg: EngineConfig):
    """(dense, sparse): the backends 'auto' picks from; with a mesh the
    sparse side is routed, and the dense side shards the stream kernel."""
    return ("stream", "routed") if cfg.mesh_shape else ("stream", "xla")


def _mesh_size(cfg: EngineConfig) -> int:
    """The mesh shape's device count, or (no shape) every device the
    config's mesh may take."""
    if cfg.mesh_shape:
        return cfg.mesh_shape[0] * cfg.mesh_shape[1]
    return len(mesh_devices(cfg.device, cfg.mesh_devices))


def _auto_backend(table, query: Optional[str], cfg: EngineConfig):
    """Density heuristic for backend 'auto' (both candidates are exact, so
    a wrong guess only costs speed). The stream kernel pays one plane pass
    whatever the query count; the sparse probe pays per query. The query
    count is estimated from the input size: ~1 query k-mer per FASTA byte
    in aa mode, ~2 per byte for DNA (6 frames of len/3 windows), ~3.5x for
    gzip. An unknown size (stdin) returns None: the caller defers the
    choice to _DeferredAutoFeed, which decides from the actual count. With
    a mesh the sparse side routes instead (the multi-device sparse path);
    the dense side shards the stream kernel."""
    import os

    dense, sparse = _auto_candidates(cfg)
    if query is None:
        return None
    try:
        size = os.path.getsize(query)
    except OSError:
        return None
    if query.endswith(".gz"):
        size *= 3.5
    est_queries = size * (1.0 if cfg.aa else 2.0)
    return dense if est_queries > table.num_sigs / DENSITY_CROSSOVER \
        else sparse


class _DeferredAutoFeed:
    """Backend-'auto' front end for inputs of unknown size (stdin): buffers
    prepare chunks in RAM and, the moment the query count crosses
    numSigs/DENSITY_CROSSOVER, upgrades itself in place to the stream
    backend's incremental scatter, draining the buffer. A run that stays
    below the threshold finishes on the sparse one-shot path; below the
    crossover the buffered queries are few by definition."""

    def __init__(self, engine: "Engine", table, cfg: EngineConfig):
        self.engine, self.table, self.cfg = engine, table, cfg
        self.threshold = table.num_sigs / DENSITY_CROSSOVER
        self._chunks: list = []
        self.total_fed = 0
        self._stream = None
        self._stream_failed = False

    def add_batch(self, values: np.ndarray, cnt_id, pos: np.ndarray) -> None:
        if self._stream is not None:
            self._stream.add_batch(values, cnt_id, pos)
            return
        values = np.asarray(values, dtype=np.int64)
        n = len(values)
        if n == 0:
            return
        cnt = np.broadcast_to(np.asarray(cnt_id, dtype=np.int64), (n,))
        self._chunks.append((values.copy(), cnt.copy(),
                             np.asarray(pos, dtype=np.int64).copy()))
        self.total_fed += n
        if self.total_fed > self.threshold and not self._stream_failed:
            self._upgrade()

    def _upgrade(self) -> None:
        try:
            lk = _cached_lookup("stream", self.engine._table_path,
                                self.table, self.cfg)
        except ValueError:
            # max_probe beyond the packed-offset budget: stay on the
            # buffered path and finish sparse (still exact, just slower).
            # A KernelError is no ValueError and propagates.
            self._stream_failed = True
            return
        s = StreamingStreamLookup(lk, compute_kmers_found=self.cfg.debug,
                                  flush_limit=self.cfg.input_size_limit)
        for v, c, p in self._chunks:
            s.add_batch(v, c, p)
        self._chunks = []
        self._stream = s
        self.engine.config = _replace_backend(self.cfg, "stream")

    def partial_hits(self) -> LookupHits:
        if self._stream is not None:
            return self._stream.partial_hits()
        z = np.zeros(0)
        return LookupHits.from_lists(z, z, z, z, z, z,
                                     0 if self.cfg.debug else -1)

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()

    def finish(self) -> LookupHits:
        if self._stream is not None:
            return self._stream.finish()
        from ..lookup.store import REC_DTYPE

        self.engine.config = _replace_backend(self.cfg,
                                              _auto_candidates(self.cfg)[1])
        rec = np.zeros(self.total_fed, dtype=REC_DTYPE)
        at = 0
        for v, c, p in self._chunks:
            rec["value"][at:at + len(v)] = v
            rec["cnt"][at:at + len(v)] = c
            rec["pos"][at:at + len(v)] = p
            at += len(v)
        self._chunks = []
        return self.engine._lookup(self.table, rec)


def _table_ident(table_path: str):
    import os

    try:
        return (os.path.realpath(table_path), os.path.getmtime(table_path),
                os.path.getsize(table_path))
    except OSError:
        return (table_path, None, None)


def _cached_read_table(table_path: str):
    """Single-slot host-table cache keyed by (realpath, mtime, size):
    re-reading a multi-GB file per run would dominate repeated runs."""
    with span("table.read"):
        ident = _table_ident(table_path)
        tbl = _TABLE_CACHE.get(ident)
        if tbl is None:
            tbl = read_table(table_path)
            _TABLE_CACHE.clear()
            _TABLE_CACHE[ident] = tbl
        return tbl


def _cached_lookup(backend: str, table_path: str, table, cfg: EngineConfig):
    """The lookup of this table for ``backend``: sparse ("xla"), "stream",
    block-probe ("pallas"), one of the mesh lookups, or the fused program
    ("spmd", per query alphabet); from the one-slot cache keyed also by the
    torch device, the mesh shape and the mesh's devices. Too few devices
    for a mesh is a ValueError of the mesh lookups and of "spmd"; "xla"
    then keeps one device, and "stream" takes the devices there are."""
    key = (backend, _table_ident(table_path), cfg.probe_window,
           cfg.aa if backend == "spmd" else cfg.lookup_chunk,
           cfg.mesh_shape, tuple(cfg.mesh_devices or ()),
           str(torch_device(cfg.device)))
    lk = _LOOKUP_CACHE.get(key)
    if lk is None:
        with span("lookup.build"):
            lk = _build_lookup(backend, table, cfg)
        _LOOKUP_CACHE.clear()
        _LOOKUP_CACHE[key] = lk
    return lk


def _build_lookup(backend: str, table, cfg: EngineConfig):
    from ..parallel import (replicated_lookup, routed_lookup, sharded_lookup,
                            stream_shards, tilejoin_shards)
    from ..parallel.mesh import make_mesh

    devices = (mesh_devices(cfg.device, cfg.mesh_devices)
               if cfg.mesh_shape or backend in MESH_LOOKUPS else None)
    if backend == "spmd":
        from .spmd import SpmdProgram

        return SpmdProgram(table, cfg)
    if backend == "xla":
        if cfg.mesh_shape and _mesh_size(cfg) > 1:
            # --mesh on the xla backend: the sparse probe over the table
            # axis; too few devices keeps the single-device lookup
            try:
                return tilejoin_shards.TileJoinShardedLookup(
                    table, make_mesh(1, _mesh_size(cfg), devices),
                    probe_window=cfg.probe_window, chunk=cfg.lookup_chunk)
            except ValueError:
                pass
        return SparseLookup(table, probe_window=cfg.probe_window,
                            chunk=cfg.lookup_chunk, device=cfg.device)
    if backend == "pallas":
        return BlockProbeLookup(table, probe_window=cfg.probe_window,
                                chunk=cfg.lookup_chunk, device=cfg.device)
    if backend == "stream":
        if cfg.mesh_shape:
            return stream_shards.StreamShardedLookup(
                table, stream_shards.make_stream_mesh(_mesh_size(cfg),
                                                      devices),
                probe_window=cfg.probe_window)
        return StreamLookup(table, probe_window=cfg.probe_window,
                            device=cfg.device)
    if backend == "sharded":
        shape = cfg.mesh_shape or default_mesh_shape(len(devices))
        return sharded_lookup.ShardedLookup(
            table, make_mesh(*shape, devices=devices),
            cfg.probe_window or max(8, table.max_probe))
    if backend == "replicated":
        return replicated_lookup.ReplicatedLookup(
            table, make_mesh(_mesh_size(cfg), 1, devices))
    if backend == "routed":
        return routed_lookup.RoutedLookup(
            table, make_mesh(1, _mesh_size(cfg), devices),
            probe_window=max(16, table.max_probe or 16))
    raise ValueError(f"unknown lookup backend: {backend}")


class Engine:
    def __init__(self, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig()
        self._report: Optional[Report] = None
        self._stdout = True
        self._table_path: Optional[str] = None
        self._front = None  # the run's streaming front end, closed after it

    def _info(self, message: str, report: Report, stdout: bool) -> None:
        # ref printInfoLine :891-898
        if self.config.debug:
            report.println(message)
        if not stdout:
            print(message)

    def _progress(self, total: int):
        from ..utils.timing import ProgressReporter

        report, stdout = self._report, self._stdout
        if report is None or (not self.config.debug and stdout):
            return None
        return ProgressReporter(total,
                                lambda msg: self._info(msg, report, stdout))

    def _parity_fallback(self, name: str, ex: Exception, cfg: EngineConfig):
        """Degrade path when a device backend can't serve this table (a
        probe window over 256 for xla, max_probe over 64 for stream): warn,
        rebind the run to the exact parity scan, and hand back a
        bounded-RAM store as the prepare feed."""
        import warnings

        warnings.warn(f"{name} backend unavailable ({ex}); "
                      "falling back to the parity scan")
        store = QueryKmerStore(self._table.num_sigs, cfg.input_size_limit,
                               cfg.resolved_temp_dir())
        self.config = cfg = _replace_backend(cfg, "parity")
        return store, store, cfg

    def run(self, data_dir: str, query: Optional[str], out_stream: TextIO,
            stdout: bool = False, query_stream: Optional[TextIO] = None) -> None:
        # _run may resolve backend "auto" (or degrade to "parity") by
        # rebinding self.config; restore so a reused Engine re-resolves
        orig_config = self.config
        try:
            # the caller's run record (the CLI's, a request's), else one
            # of this run's own
            with record("engine.run"), \
                    maybe_profile(self.config.profile_dir):
                try:
                    self._run(data_dir, query, out_stream, stdout,
                              query_stream)
                finally:
                    self._close_front_end()
        finally:
            self.config = orig_config

    def _close_front_end(self) -> None:
        """Close the streaming front end, inside the run's record: one that
        finished has already stopped its threads and given its sets back;
        one whose prepare failed stops them and gives them back here."""
        front, self._front = self._front, None
        close = getattr(front, "close", None)
        if close is not None:
            close()

    def _run(self, data_dir: str, query: Optional[str], out_stream: TextIO,
             stdout: bool = False, query_stream: Optional[TextIO] = None) -> None:
        cfg = self.config
        on_cuda = torch_device(cfg.device).type == "cuda"  # raises w/o CUDA
        report = Report(out_stream)
        self._report, self._stdout = report, stdout
        import os
        self._info("Temp. directory: " + os.path.realpath(cfg.resolved_temp_dir()),
                   report, stdout)
        table_path, func_path = resolve_table_files(data_dir)
        self._table_path = table_path
        functions = load_function_index(func_path)
        table = _cached_read_table(table_path)
        self._table = table
        deferred = None
        if cfg.backend == "auto":
            choice = _auto_backend(table, query, cfg)
            if choice is None and not table.truncated:
                # unknown input size: decide from the real query count
                # mid-prepare (upgrades itself to the stream scatter at
                # the density crossover)
                deferred = _DeferredAutoFeed(self, table, cfg)
            else:
                self.config = cfg = _replace_backend(
                    cfg, choice or _auto_candidates(cfg)[1])
        if on_cuda:
            self._cuda_init(cfg)
            with span("kernel.load"):
                self._load_kernels(cfg, table, deferred)

        # --- phase 1: prepare (ref :776-795) ---
        # xla backend: the feeder streams k-mer batches straight into the
        # device probe (parse/transfer/probe/verify pipeline; only hits
        # are retained, so no spill is needed). stream backend: each chunk
        # scatters into the persistent query tiles; finish() runs the
        # plane pass(es). Parity and pallas buffer through the bounded-RAM
        # store, as in the JAX engine.
        with span("engine.prepare") as phase:
            streaming, store, spmd, feed, cfg = self._front_end(
                cfg, table, deferred)
            self._front = streaming
            try:
                with span("prepare.feed"):
                    prep = self._prepare(query, query_stream, feed, spmd)
                rec = None
                if store is not None:
                    rec = store.finalize(
                        require_sorted=(cfg.backend == "parity"))
            except Exception:
                if store is not None:
                    store.close()
                raise
        self._info("Preparation time: %d ms." % phase.ms, report, stdout)

        # --- phase 2: lookup (ref :796-803) ---
        with span("engine.lookup") as phase:
            if cfg.debug:
                report.println(
                    "Kmer-table info: numSigs=%d, entrySize=%d, version=%d"
                    % (table.num_sigs, ENTRY_SIZE, table.version))
            hits: LookupHits
            try:
                if streaming is not None:
                    hits = streaming.finish()
                elif spmd is not None:
                    hits = spmd.finish()
                else:
                    hits = self._lookup(table, rec)
            except TableTruncatedError as ex:
                # ref :797-802 — EOFException: partial results +
                # "Error: null"
                traceback.print_exc(file=sys.stderr)
                self._info("Error: null", report, stdout)
                hits = ex.partial
            except KernelError:
                # a kernel fault is the port's own failure, not the
                # reference's lookup error: never turn it into a report
                raise
            except Exception as ex:  # noqa: BLE001
                # the reference catches ANY lookup failure, reports it, and
                # still groups whatever hits were found (ref :797-802)
                traceback.print_exc(file=sys.stderr)
                self._info("Error: " + (str(ex) or "null"), report, stdout)
                if streaming is not None:
                    hits = streaming.partial_hits()
                elif spmd is not None:
                    hits = spmd.partial_hits()
                else:
                    hits = LookupHits.from_lists([], [], [], [], [], [], 0)
            finally:
                if store is not None:
                    store.close()
        self._info("Lookup time: %d ms." % phase.ms, report, stdout)
        if cfg.debug:
            report.println("Kmers found: %d (pos-count=%d)"
                           % (hits.kmers_found, len(hits)))

        # --- phase 3: group (ref :804-819) ---
        with span("engine.group") as phase:
            self._group(prep, hits, functions, report)
        self._info("Grouping time: %d ms." % phase.ms, report, stdout)

    def _front_end(self, cfg: EngineConfig, table, deferred):
        """The lookup's front end that phase 1 feeds: (streaming, store,
        spmd, feed, cfg), ``cfg`` rebound where a backend degrades to the
        parity scan."""
        streaming = None
        store = None
        spmd = None
        feed = None  # the fused path takes the records itself
        if deferred is not None:
            streaming = feed = deferred
        elif cfg.backend == "spmd" and not table.truncated:
            # fused device path: raw sequence bytes go to the device; the
            # k-mer windows and their sparse probe run there, one launch a
            # batch (models/spmd.py), with no host query-k-mer stream at all
            from .spmd import SpmdAnnotator

            try:
                spmd = SpmdAnnotator(table, cfg, program=_cached_lookup(
                    "spmd", self._table_path, table, cfg))
            except ValueError as ex:
                # a probe window over 128 (or slots past int32)
                store, feed, cfg = self._parity_fallback("spmd", ex, cfg)
        elif cfg.backend == "xla" and not table.truncated:
            try:
                lk = _cached_lookup("xla", self._table_path, table, cfg)
            except ValueError as ex:
                # pathologically dense table (probe window > 256): degrade
                # to the exact streaming scan instead of failing
                store, feed, cfg = self._parity_fallback("xla", ex, cfg)
            else:
                streaming = feed = StreamingLookup(
                    lk, compute_kmers_found=cfg.debug,
                    sort_chunks=cfg.sort_chunks, device_sort=cfg.device_sort)
        elif cfg.backend == "stream" and not table.truncated:
            try:
                lk = _cached_lookup("stream", self._table_path, table, cfg)
            except ValueError as ex:
                # max_probe beyond the packed-offset budget
                store, feed, cfg = self._parity_fallback("stream", ex, cfg)
            else:
                # flush_limit = the reference's inputSizeLimit (ref :108):
                # bounded RAM via one plane pass per 20M queries
                streaming = feed = StreamingStreamLookup(
                    lk, compute_kmers_found=cfg.debug,
                    flush_limit=cfg.input_size_limit)
        else:
            store = QueryKmerStore(table.num_sigs, cfg.input_size_limit,
                                   cfg.resolved_temp_dir())
            feed = store
        return streaming, store, spmd, feed, cfg

    def _prepare(self, query, query_stream, feed, spmd):
        """Phase 1's work: the FASTA parsed and encoded into ``feed`` (the
        fused path's annotator instead where ``spmd`` is set); returns the
        run's Prepared."""
        cfg = self.config
        if spmd is not None:
            return spmd.consume(read_fasta(query if query is not None
                                           else query_stream))
        prep = None
        if cfg.prepare_impl == "native":
            # fully-native fast path: bulk parse + feeder share one
            # buffer, no per-record Python (None = fall through)
            from .prepare import try_prepare_bulk

            prep = try_prepare_bulk(query, query_stream, feed, cfg.aa)
        if prep is None:
            records = read_fasta(query if query is not None
                                 else query_stream)
            from .prepare import (prepare_aa_native, prepare_aa_numpy,
                                  prepare_dna_native, prepare_dna_numpy)

            if cfg.prepare_impl == "native":
                prep = (prepare_aa_native(records, feed) if cfg.aa
                        else prepare_dna_native(records, feed))
            elif cfg.prepare_impl == "jax":
                # the window kernel's ragged entry on the device
                from .prepare import prepare_aa, prepare_dna

                prep = (prepare_aa(records, feed,
                                   min_bucket=cfg.length_bucket_base,
                                   device=cfg.device) if cfg.aa
                        else prepare_dna(records, feed, device=cfg.device))
            if prep is None:  # numpy, or no toolchain
                prep = (prepare_aa_numpy(records, feed) if cfg.aa
                        else prepare_dna_numpy(records, feed))
        return prep

    def _group(self, prep, hits, functions, report) -> None:
        """The report's text from the hits: the native grouping where it
        serves the run, else the containers through the host machine or
        (``--grouping scan``) the grouping kernel."""
        cfg = self.config
        params = GroupingParams(
            min_hits=cfg.min_hits, min_weighted_hits=cfg.min_weighted_hits,
            max_gap=cfg.max_gap, order_constraint=cfg.order_constraint,
            debug=cfg.debug)
        scan = (cfg.grouping_impl == "scan" and not cfg.debug
                and cfg.min_hits >= 2)
        if (not cfg.debug and cfg.min_hits >= 2
                and cfg.grouping_impl == "host"):
            # fully-native grouping phase: sort + state machine + report
            # text in three C calls, no per-sequence Python (falls through
            # to the general path when the library is unavailable)
            from ..calls.batch_native import try_native_report

            with span("group.native"):
                if try_native_report(prep, hits, functions, cfg.aa, report,
                                     params):
                    return
        container_hits = self._bucket_hits(prep, hits, functions, params)
        if scan:
            with span("group.scan"):
                self._group_scan(prep, container_hits, functions, report,
                                 params)
        else:
            process_seq = process_aa_seq if cfg.aa else process_dna_seq
            for query_id, seq_len in prep.id_len.items():
                process_seq(query_id, seq_len, container_hits, functions,
                            report, params)
                report.flush()

    @staticmethod
    def _cuda_init(cfg: EngineConfig) -> None:
        """The run's first CUDA touch, under its own span: CUDA and the
        device's context come up here (a no-op once they are up), not
        inside the first upload."""
        import torch

        with span("cuda.init"):
            torch.cuda.init()
            torch.cuda.synchronize(torch_device(cfg.device))

    @staticmethod
    def _load_kernels(cfg: EngineConfig, table, deferred) -> None:
        """Build (where needed) and load the CUDA kernels the run's backend
        may launch."""
        if cfg.grouping_impl == "scan":
            scan_machine.load_kernel()
        if cfg.prepare_impl == "jax":
            kmer_windows.load_kernel()
        if not table.truncated:
            # a build failure raises here, before any work, and never
            # degrades; a deferred choice may run either side, the block
            # probe's exact rest runs the tile-join kernel, and so do the
            # replicated lookup and the routed owners' probes
            sparse = _auto_candidates(cfg)[1] if deferred is not None \
                else cfg.backend
            if deferred is not None or cfg.backend in (
                    "xla", "pallas", "spmd", "replicated", "routed"):
                tilejoin.load_kernel()
            if cfg.backend == "spmd":
                fused_probe.load_kernel()
            if deferred is not None or cfg.backend == "stream":
                stream_kernel.load_kernel()
            if cfg.backend == "pallas":
                blockprobe.load_kernel()
            if sparse == "routed":
                route_bins.load_kernel()
            if cfg.backend == "sharded" or (
                    cfg.backend == "spmd"
                    and tuple(cfg.mesh_shape or default_mesh_shape(
                        _mesh_size(cfg))) != (1, 1)):
                shard_probe.load_kernel()

    # containers of more hits than this go to the host machine, as in the
    # JAX engine (there they would set its padded batch's length)
    SCAN_BIG = 4096

    def _group_scan(self, prep, container_hits, functions, report, params):
        """Device grouping: every container of at most SCAN_BIG hits
        through the grouping kernel in one launch on the config's device
        (``calls/scan_machine.py``), then the report text and each
        sequence's OTU folds on the host, in record order."""
        from ..calls.grouping import tabulate_otu_data

        cfg = self.config
        order = []  # container keys in output order
        batch = []
        big_keys = set()
        for query_id in prep.id_len:
            keys = ([(query_id, "+", 0)] if cfg.aa else
                    [(query_id, s, f) for s in ("+", "-") for f in range(3)])
            for key in keys:
                pos, otu, avg, fi, wt = container_hits[key][:5]
                if len(pos) > self.SCAN_BIG:
                    big_keys.add(key)
                    continue
                batch.append((pos, otu, avg, fi, wt))
                order.append(key)
        results = scan_machine.gather_hits_scan_batch(
            batch, functions, params, device=cfg.device)
        by_key = dict(zip(order, results))
        for query_id, seq_len in prep.id_len.items():
            oi_counts = []
            if cfg.aa:
                report.println("PROTEIN-ID\t%s\t%d" % (query_id, seq_len))
                self._emit_scan_container(
                    (query_id, "+", 0), by_key, big_keys, container_hits,
                    functions, oi_counts, report, params)
            else:
                report.println("processing %s[%d]" % (query_id, seq_len))
                for strand in ("+", "-"):
                    for frame in range(3):
                        report.println("TRANSLATION\t%s\t%d\t%s\t%d"
                                       % (query_id, seq_len, strand, frame))
                        self._emit_scan_container(
                            (query_id, strand, frame), by_key, big_keys,
                            container_hits, functions, oi_counts, report,
                            params)
            tabulate_otu_data(query_id, seq_len, oi_counts, report)
            report.flush()

    @staticmethod
    def _emit_scan_container(key, by_key, big_keys, container_hits, functions,
                             oi_counts, report, params):
        from ..calls.grouping import _gather_dispatch, _otu_add_batch

        if key in big_keys:
            _gather_dispatch(container_hits[key], functions, oi_counts,
                             report, params)
            return
        lines, updates = by_key[key]
        for ln in lines:
            report.println(ln)
        for o, inc in updates:
            _otu_add_batch(oi_counts, o, inc)

    def _lookup(self, table, rec) -> LookupHits:
        """One-shot lookup of buffered queries: the parity scan (and every
        truncated table), the block probe (pallas), or a deferred 'auto' run
        that finished below the density crossover on the sparse path."""
        cfg = self.config
        if table.truncated and cfg.backend != "parity":
            # only the streaming parity scan reproduces the reference's
            # EOF-mid-probe partial results (ref :797-802)
            import warnings

            warnings.warn("table file is truncated; using the parity backend "
                          "for reference-exact partial results")
            return lookup_stream(table, rec["value"], rec["cnt"], rec["pos"])
        if cfg.backend == "parity":
            return lookup_stream(table, rec["value"], rec["cnt"], rec["pos"])
        # the block probe ("pallas") and the mesh lookups are built here,
        # inside the lookup phase's error handling: a table past its window
        # or a mesh past the devices (a ValueError) becomes the JAX
        # engine's "Error:" line, not a parity fallback; like the JAX
        # engine's branches of these backends, they report no progress
        lk = _cached_lookup(cfg.backend, self._table_path, table, cfg)
        if cfg.backend in MESH_LOOKUPS:
            # as the JAX engine: replicated and routed count kmers_found
            # always, sharded only in debug mode
            return lk.lookup(rec["value"], rec["cnt"], rec["pos"],
                             compute_kmers_found=(cfg.debug or
                                                  cfg.backend != "sharded"))
        progress = None if cfg.backend == "pallas" else self._progress(
            len(rec))
        return lk.lookup(rec["value"], rec["cnt"], rec["pos"],
                         progress=progress, compute_kmers_found=cfg.debug)

    def _bucket_hits(self, prep: Prepared, hits: LookupHits, functions,
                     params) -> Dict[tuple, object]:
        """Distribute flat hit records into per-container lists.

        Mirrors the reference's container map semantics (ref :805-809): for
        duplicate (id, strand, frame) keys the LAST container wins, dropping
        hits of earlier same-key containers.
        """
        key_to_cnt = {}
        for cid, key in enumerate(prep.containers):
            key_to_cnt[key] = cid  # last wins
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int32),
                 np.zeros(0, np.int32), np.zeros(0, np.int32),
                 np.zeros(0, np.float32), True, True)
        by_container: Dict[tuple, tuple] = {k: empty for k in key_to_cnt}
        cnt_to_key = {cid: key for key, cid in key_to_cnt.items()}
        # one global (container, position) sort + segmented reductions: the
        # per-container sort and one-function check become O(1) lookups.
        # Hits that already arrive in (container, position) order skip the
        # sort.
        c, p_ = hits.cnt_id, hits.pos
        presorted = len(c) == 0 or bool(np.all(
            (c[1:] > c[:-1]) | ((c[1:] == c[:-1]) & (p_[1:] >= p_[:-1]))))
        if presorted:
            cnt_s, pos_s, otu_s = hits.cnt_id, hits.pos, hits.otu
            avg_s, fi_s = hits.avg_from_end, hits.fi
            wt_s = hits.wt.astype(np.float32)
        else:
            order = np.lexsort((hits.pos, hits.cnt_id))
            cnt_s = hits.cnt_id[order]
            pos_s = hits.pos[order]
            otu_s = hits.otu[order]
            avg_s = hits.avg_from_end[order]
            fi_s = hits.fi[order]
            wt_s = hits.wt[order].astype(np.float32)
        from ..calls.batch_native import _sorted_unique
        uniq, starts = _sorted_unique(cnt_s)
        if len(starts):
            fi_min = np.minimum.reduceat(fi_s, starts)
            fi_max = np.maximum.reduceat(fi_s, starts)
            same_fi = fi_min == fi_max
        else:
            same_fi = np.zeros(0, dtype=bool)
        bounds = np.append(starts, len(cnt_s))
        counts = np.diff(bounds)

        batch_ok = (not params.debug and params.min_hits >= 2
                    and self.config.grouping_impl == "host")
        from ..calls.batch_native import native_available
        use_native = batch_ok and native_available()
        pre = {}
        elig = np.zeros(len(prep.containers), dtype=bool)
        if use_native:
            # EVERY container becomes a precomputed ("pre", ...) result:
            # hitless ones are trivially empty, the rest run through the
            # native machine below in one ctypes call
            empty_pre = ("pre", [], [])
            by_container = {k: empty_pre for k in key_to_cnt}
        elif batch_ok and not params.order_constraint and len(uniq):
            # no toolchain: batch-evaluate the single-function fast path
            # globally (the single-fi reduction proof needs no collinearity
            # filter, ref :490 can reject hits)
            from ..calls.batch_host import batch_single_fi_calls

            from ..constants import MAX_HITS_PER_SEQ as _CAP
            elig[uniq] = same_fi & (counts < _CAP - 2)
            pre = batch_single_fi_calls(cnt_s, pos_s, otu_s, fi_s, wt_s,
                                        elig, functions, params)
            empty_pre = ("pre", [], [])
            for key, cid in key_to_cnt.items():
                if elig[cid]:
                    by_container[key] = empty_pre

        native_pre = {}
        if use_native and len(uniq):
            from ..calls.batch_native import batch_group_calls

            todo = np.array([k for k, cid in enumerate(uniq.tolist())
                             if cnt_to_key.get(cid) is not None],
                            dtype=np.int64)
            native_pre = batch_group_calls(
                cnt_s, pos_s, otu_s, avg_s, fi_s, wt_s, todo, bounds,
                functions, params)

        bounds_l = bounds.tolist()
        for k, cid in enumerate(uniq.tolist()):
            key = cnt_to_key.get(cid)
            if key is None:
                continue  # superseded duplicate container
            if elig[cid]:
                lines, updates = pre.get(cid, ([], []))
                by_container[key] = ("pre", lines, updates)
                continue
            if cid in native_pre:
                by_container[key] = native_pre[cid]
                continue
            a, b = bounds_l[k], bounds_l[k + 1]
            by_container[key] = (pos_s[a:b], otu_s[a:b], avg_s[a:b],
                                 fi_s[a:b], wt_s[a:b], True, bool(same_fi[k]))
        return by_container
