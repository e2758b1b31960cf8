"""The host half of the fingerprint-candidate protocol (numpy; a copy of
``verify_candidates`` and ``gather_hit_metadata`` from the JAX package's
``parallel/sharded_lookup.py``).

The device answers each query with a candidate slot: the first slot of its
window that holds its u16 fingerprint (``value % 65535``). A true match
always fingerprint-matches at or before itself, so candidates are a
superset of matches; the host verifies each against the full k-mer value
and re-probes the rare fingerprint collision over the exact window, then
gathers the hit metadata from the table's host arrays.

The JAX package's slot-range sharding (``shard_table_planes``,
``_local_probe``) is not here: on one card the sparse probe
(``lookup/tilejoin.py``) answers over the whole plane, and sharding over
several cards is later work (ROADMAP.md, queue A3).
"""
from __future__ import annotations

import numpy as np

from ..formats.kmer_table import KmerTable


def verify_candidates(table: KmerTable, slotp: np.ndarray,
                      values: np.ndarray, probe_window: int):
    """Resolve fingerprint-candidate answers into exact matches.

    ``slotp``: the device's candidate slot+1 per query (0 = no candidate);
    ``values``: the queries' full k-mer values, aligned. Returns
    (found, slots): the exact first-value-match slot per query.

    A true match fingerprints equal, so the device candidate offset is
    <= the true offset; three cases per candidate:
    - stored kmer == value: the candidate IS the first value match
      (any earlier value match would have been an earlier fp match);
    - mismatch (fp collision, ~probe_window/65535 of queries): exact
      full-window host re-probe; the true match, if any, is later in
      the window;
    - no candidate: a true miss (a match implies a candidate).
    Slots past num_sigs (padded tail, reachable only by corrupted-input
    values equal to the empty sentinel) count as misses. The window scan
    treats beyond-end slots as empty."""
    slots = slotp.astype(np.int64) - 1
    cand = (slotp > 0) & (slots < table.num_sigs)
    tk = table.slots["kmer"]
    found = np.zeros(len(slots), dtype=bool)
    sel = np.nonzero(cand)[0]
    v = np.asarray(values, dtype=np.int64)
    found[sel] = tk[slots[sel]] == v[sel]
    bad = sel[~found[sel]]
    if len(bad):
        homes = (v[bad] % np.int64(table.num_sigs)).astype(np.int64)
        f2 = np.zeros(len(bad), dtype=bool)
        off2 = np.zeros(len(bad), dtype=np.int64)
        ns = table.num_sigs
        # reverse order + overwrite == first-match offset; beyond-end
        # reads clamp to a masked miss (treated as empty)
        for l in range(probe_window - 1, -1, -1):
            idx = homes + l
            ok = idx < ns
            m = ok & (tk[np.minimum(idx, ns - 1)] == v[bad])
            off2[m] = l
            f2 |= m
        found[bad] = f2
        slots[bad] = np.where(f2, homes + off2, 0)
    slots = np.where(found, slots, 0)
    return found, slots


def gather_hit_metadata(table: KmerTable, slotp: np.ndarray,
                        values: np.ndarray = None,
                        probe_window: int = None):
    """Host-side metadata gather at slot+1 answers (0 = miss). Returns
    (found_bool, otu, avg_from_end, fi, wt) aligned with the queries.
    With ``values`` given (the fingerprint-candidate protocol), answers
    are first verified and collision-resolved by `verify_candidates`;
    callers MUST drop rows where found is False. Without values the
    answers are trusted exact; a slot in the padded tail past num_sigs
    still counts as a miss rather than indexing out of bounds."""
    if values is not None:
        if probe_window is None:
            if table.max_probe is None:
                table.compute_max_probe()
            probe_window = max(8, table.max_probe)
        found, slots = verify_candidates(table, slotp, values, probe_window)
    else:
        slots = slotp.astype(np.int64) - 1
        found = (slotp > 0) & (slots < table.num_sigs)
        slots = np.where(found, slots, 0)
    t = table.slots
    z32 = np.int32(0)
    return (found,
            np.where(found, t["otu"][slots], z32),
            np.where(found, t["avg_from_end"][slots], z32),
            np.where(found, t["fi"][slots], z32),
            np.where(found, t["wt"][slots], np.float32(0)))
