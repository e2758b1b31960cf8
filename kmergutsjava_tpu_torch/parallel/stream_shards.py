"""Multi-device dense stream lookup: the plane and the query tiles split
into slot ranges over a 1-D ``table`` mesh (the counterpart of the JAX
package's ``parallel/stream_shards.py``, which the ``stream`` backend takes
with ``--mesh``).

The host scatter already routes every query to its home slot, so splitting
the plane ``[S + w]`` by slot range splits the tiles ``[C, S]`` the same
way: shard t holds its slots and a halo of ``w``, probes its columns of the
tiles with the stream probe (B2, ``lookup/stream.py``), and needs no
collective. The packed answers are joined in slot order on the host. The
per-query stages are the JAX package's, on the host: the native scatter
into host tiles (``scatter_chunk``, or its numpy twin) and the decode
(``resolve_slots`` + ``emit_hits``, or numpy) against the empty-distance
plane and k-mer column that ``StreamLookup`` builds.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..formats.kmer_table import KmerTable
from ..lookup.parity import LookupHits
from ..lookup.sparse import FP_MOD, _device_fault, on_stream
from ..lookup.stream import SLOT_ALIGN, StreamLookup, stream_probe
from ..utils.timing import span
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


class HostPassSet:
    """The sharded lookup's pass set: numpy tiles u16 ``[C, S]`` and
    occupancy u8 ``[num_sigs]`` for the host scatter, the tiles page-locked
    where ``pinned`` (a pooled set on CUDA), so each shard's columns go up
    at the link's speed. Tiles and occupancy are all zero whenever a set is
    free; ``dirty`` marks a set scattered into since its last reset."""

    def __init__(self, channels: int, slots: int, num_sigs: int,
                 pinned: bool, pooled: bool):
        self.pooled = pooled
        self.dirty = False
        if pinned:
            host = torch.empty(channels * slots * 2, dtype=torch.uint8,
                               pin_memory=True).numpy()
            host.fill(0)
            self.tiles = host.view(np.uint16).reshape(channels, slots)
        else:
            self.tiles = np.zeros((channels, slots), dtype=np.uint16)
        self.occ = np.zeros(num_sigs, dtype=np.uint8)

    def zero(self) -> None:
        with span("stream.reset"):
            self.tiles.fill(0)
            self.occ.fill(0)
        self.dirty = False


def scatter_host(values: np.ndarray, tiles: np.ndarray, occ: np.ndarray,
                 num_sigs: int):
    """Bucket one chunk's queries into the host's ``[C, S]`` tiles,
    advancing the per-slot channel occupancy ``occ`` (so the ranks and the
    dedup carry across the chunks of a pass).

    Returns (homes, flat, shift), the columns full query length: ``flat``
    is the element index into the flattened kernel output ``[C/4, S]`` and
    ``shift`` the bit shift of the query's packed byte, or -1 where the
    query found its home slot's C channels taken (the decode routes those
    to the exact fallback)."""
    from ..utils.native import load_scatter

    lib = load_scatter()
    with span("stream.scatter"):
        if lib is not None:
            return scatter_native(lib, values, tiles, occ, num_sigs)
        return scatter_numpy(values, tiles, occ, num_sigs)


def scatter_numpy(values, tiles, occ, num_sigs: int):
    """numpy twin of ``scatter_chunk``: duplicate values share one tile
    cell (equal values have equal homes and fingerprints), and a home's
    distinct values take channels in value order."""
    channels, slots = tiles.shape
    values = np.asarray(values, dtype=np.int64)
    homes = values % np.int64(num_sigs)
    uniq, inv = np.unique(values, return_inverse=True)
    nu = len(uniq)
    h_u = uniq % np.int64(num_sigs)
    order = np.argsort(h_u, kind="stable")
    h_s = h_u[order]
    rank = np.arange(nu) - np.searchsorted(h_s, h_s) + occ[h_s]
    uh, counts = np.unique(h_s, return_counts=True)
    occ[uh] = np.minimum(occ[uh].astype(np.int64) + counts,
                         255).astype(occ.dtype)
    ok = rank < channels
    h_ok = h_s[ok]
    rk = rank[ok]
    tiles[rk, h_ok] = (uniq[order[ok]] % FP_MOD).astype(np.uint16)
    flat_u = np.zeros(nu, dtype=np.int64)
    shift_u = np.full(nu, -1, dtype=np.int32)
    flat_u[order[ok]] = (rk >> 2) * slots + h_ok
    shift_u[order[ok]] = 8 * (rk & 3)
    return homes, flat_u[inv], shift_u[inv]


def scatter_native(lib, values, tiles, occ, num_sigs: int):
    """C++ scatter (``native/scatter.cpp``) in the ``rows=1, block=S``
    layout: cell (c, h) at ``c*S + h``, output element ``(c//4)*S + h``.
    Dedup is by (home, fingerprint) against the tile itself, so it holds
    across streaming chunks; channel ranks follow encounter order (another
    valid overflow split than the numpy twin's, with identical hits)."""
    channels, slots = tiles.shape
    values = np.ascontiguousarray(values, dtype=np.int64)
    n = len(values)
    homes = np.empty(n, dtype=np.int64)
    flat = np.empty(n, dtype=np.int64)
    shift = np.empty(n, dtype=np.int32)
    lib.scatter_chunk(values, n, num_sigs, channels, slots, 1, FP_MOD,
                      tiles.reshape(-1), occ, homes, flat, shift)
    return homes, flat, shift


class StreamShardedLookup(StreamLookup):
    """Stream-kernel lookup with the plane and tiles split over a ``1 x T``
    mesh. Same exact-result contract as ``StreamLookup``, with the host's
    per-query stages in place of its device ones (``_new_set``,
    ``_scatter_into``, ``_pass``, ``_decode``): its pass sets are host
    tiles, and ``_probe`` places each shard's columns itself."""

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

    def _new_set(self, pooled: bool) -> HostPassSet:
        """A zeroed host pass set, page-locked in a pooled set on CUDA."""
        return HostPassSet(self.channels, self.slots, self.num_sigs,
                           pinned=pooled and self.device.type == "cuda",
                           pooled=pooled)

    def _scatter_into(self, s: HostPassSet, values: np.ndarray) -> tuple:
        """The native scatter into the set's host tiles: (homes, flat,
        shift)."""
        s.dirty = True
        return scatter_host(values, s.tiles, s.occ, self.num_sigs)

    def _pass(self, s: HostPassSet, chunks, n: int) -> np.ndarray:
        """The shards' plane passes over the set's tiles, counted, and the
        set reset: the packed answers int32 ``[channels/4, S]``."""
        out = self._probe(s)
        s.zero()
        self._count_pass(n, s.tiles.nbytes, out.nbytes)
        return out

    def _decode(self, out, chunks, n_total: int, progress,
                compute_kmers_found: bool, want_values: bool = False):
        """Resolve the packed answers into hits on the host: stop-at-empty
        gating, verification of fingerprint candidates against the full
        k-mer values, the exact full-window pass for unresolved and
        overflowed queries, and hit compaction. ``chunks`` is a list of
        full-length query column tuples (v, cnt, pos, homes, flat, shift).
        With ``want_values`` returns (hits, hit values)."""
        from ..utils.native import load_scatter

        lib = load_scatter()
        with span("stream.decode"):
            if lib is not None:
                hits, vals = self._decode_native(lib, out, chunks)
            else:
                hits, vals = self._decode_numpy(out, chunks)
            if progress is not None:
                progress.update(n_total, len(hits))
            if compute_kmers_found:
                hits.kmers_found = int(np.unique(vals).size)
        return (hits, vals) if want_values else hits

    def _decode_native(self, lib, out, chunks):
        """Two native passes (``resolve_slots`` + ``emit_hits``, both
        thread-parallel): the first returns the exact hit count, so the hit
        columns are allocated at their final size. Returns (hits, hit
        values)."""
        t_otu, t_avg, t_fi, t_wt = self._exact._table_cols()
        hk = self._exact.host_kmer
        out_flat = np.ascontiguousarray(out.reshape(-1))
        slots = []
        k_total = 0
        for v, c, p, h, fl, sh in chunks:
            s = np.empty(len(v), dtype=np.int64)
            k_total += lib.resolve_slots(
                v, h, fl, sh, len(v), out_flat, self.fe_plane, hk, len(hk),
                self.w, self._exact.full_window, s)
            slots.append(s)
        o_cnt = np.empty(k_total, dtype=np.int64)
        o_pos = np.empty(k_total, dtype=np.int64)
        o_otu = np.empty(k_total, dtype=np.int32)
        o_avg = np.empty(k_total, dtype=np.int32)
        o_fi = np.empty(k_total, dtype=np.int32)
        o_wt = np.empty(k_total, dtype=np.float32)
        o_val = np.empty(k_total, dtype=np.int64)
        k = 0
        for (v, c, p, _, _, _), s in zip(chunks, slots):
            k += lib.emit_hits(
                v, c, p, s, len(v), t_otu, t_avg, t_fi, t_wt,
                o_cnt[k:], o_pos[k:], o_otu[k:], o_avg[k:], o_fi[k:],
                o_wt[k:], o_val[k:])
        return LookupHits(cnt_id=o_cnt, pos=o_pos, otu=o_otu,
                          avg_from_end=o_avg, fi=o_fi, wt=o_wt,
                          kmers_found=-1), o_val

    def _decode_numpy(self, out, chunks):
        """numpy twin of ``_decode_native``: (hits, hit values)."""
        def cat(k):
            if not chunks:
                return np.zeros(0, dtype=np.int64)
            return np.concatenate([ch[k] for ch in chunks])

        av, ac, ap, ah, aflat, ashift = (cat(k) for k in range(6))
        sel = ashift >= 0
        pv, pc, pp, ph = av[sel], ac[sel], ap[sel], ah[sel]
        packed = out.reshape(-1)[aflat[sel]] >> ashift[sel]
        off = (packed & 0xFF).astype(np.int64)  # first fp match, w if none
        fe = self.fe_plane[ph].astype(np.int64)
        # a candidate counts only strictly before the first empty slot;
        # off == w (no match) can't pass, since fe <= w
        has_cand = off < fe
        empty_any = fe < self.w
        host_kmer = self._exact.host_kmer
        cand_slot = np.minimum(ph + off, len(host_kmer) - 1)
        verified = has_cand & (host_kmer[cand_slot] == pv)
        unresolved = (~verified & has_cand) | (~has_cand & ~empty_any)
        over = ~sel
        tv = np.concatenate([pv[unresolved], av[over]])
        tc = np.concatenate([pc[unresolved], ac[over]])
        tp = np.concatenate([pp[unresolved], ap[over]])
        th = np.concatenate([ph[unresolved], ah[over]])
        if len(tv):
            # the fallback outcome depends only on the value: probe each
            # distinct value once
            uv, inv = np.unique(tv, return_inverse=True)
            fu, ou = self._exact._host_full_window(
                uv, (uv % np.int64(self.num_sigs)).astype(np.int32),
                np.arange(len(uv), dtype=np.int64))
            f2, o2 = fu[inv], ou[inv]
        else:
            f2 = np.zeros(0, dtype=bool)
            o2 = np.zeros(0, dtype=np.int64)
        slots = np.concatenate([
            cand_slot[verified],
            np.minimum(th[f2] + o2[f2], self.num_sigs - 1)])
        hit_v = np.concatenate([pv[verified], tv[f2]])
        t = self.table.slots
        return LookupHits(
            cnt_id=np.concatenate([pc[verified], tc[f2]]).astype(np.int64),
            pos=np.concatenate([pp[verified], tp[f2]]).astype(np.int64),
            otu=t["otu"][slots].copy(),
            avg_from_end=t["avg_from_end"][slots].copy(),
            fi=t["fi"][slots].copy(), wt=t["wt"][slots].copy(),
            kmers_found=-1), hit_v
