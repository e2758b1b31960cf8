"""Signature k-mer table: binary format reader, writer, and builder.

Binary layout (consumed by the reference at
KmerGutsJava.java:924-942 header and
:995-999 slots):

    header: int64le numSigs | int64le entrySize(=24) | int64le version
    slots : numSigs entries of 24 bytes each:
            int64le whichKmer | int32le otuIndex | int32le avgFromEnd
            | int32le functionIndex | float32le functionWt
    empty : whichKmer > MAX_ENCODED (ref :1000)
    home  : whichKmer % numSigs, linear probing upward (ref :969, :991-1018)

The reference repo ships no table and no builder; the builder here is new
capability required to create fixtures and production tables. Two builder
guarantees make the table safe for every backend:

- no probe chain ever wraps past the last slot (the reference's streaming
  reader is forward-only and cannot wrap, ref :991-994);
- the final slot is always empty, so the reference reader never hits EOF
  mid-probe.

Insertion order is deterministic: ascending (home, value). Under that order
linear probing admits a closed-form vectorized placement:
``pos[i] = max(home[i], pos[i-1] + 1)`` over the sorted sequence, which we
compute with a running maximum instead of a per-item Python loop.
"""
from __future__ import annotations

import gzip
import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..constants import EMPTY_KMER, ENTRY_SIZE, MAX_ENCODED, TABLE_VERSION
from ..utils.timing import span

SLOT_DTYPE = np.dtype(
    [
        ("kmer", "<i8"),
        ("otu", "<i4"),
        ("avg_from_end", "<i4"),
        ("fi", "<i4"),
        ("wt", "<f4"),
    ]
)
assert SLOT_DTYPE.itemsize == ENTRY_SIZE

HEADER_DTYPE = np.dtype([("num_sigs", "<i8"), ("entry_size", "<i8"), ("version", "<i8")])

TABLE_FILE = "kmer.table.mem_map"
FUNCTION_INDEX_FILE = "function.index"
META_FILE = "kmer.table.meta.json"


class TableError(ValueError):
    pass


@dataclass
class KmerTable:
    """In-memory signature table as a structure-of-arrays over all slots."""

    slots: np.ndarray  # structured SLOT_DTYPE array of length num_sigs
    num_sigs: int
    version: int = TABLE_VERSION
    max_probe: Optional[int] = None  # longest probe chain (slots touched)
    # True when the file held fewer slots than the header promised; the
    # reference's reader hits EOF mid-scan in that case and produces a
    # partial report (ref run() :797-802) — the parity backend reproduces
    # that exactly, so truncated tables are routed there.
    truncated: bool = False

    @property
    def occupied(self) -> np.ndarray:
        return self.slots["kmer"] <= MAX_ENCODED

    def compute_max_probe(self) -> int:
        occ = self.occupied
        if not occ.any():
            self.max_probe = 1
            return 1
        pos = np.nonzero(occ)[0]
        home = self.slots["kmer"][pos] % np.int64(self.num_sigs)
        probe = pos - home + 1
        if (probe < 1).any():
            raise TableError("table contains an entry placed before its home slot")
        self.max_probe = int(probe.max())
        return self.max_probe


def _next_odd_prime(n: int) -> int:
    if n <= 2:
        return 2
    if n % 2 == 0:
        n += 1
    while True:
        for p in range(3, int(n ** 0.5) + 1, 2):
            if n % p == 0:
                break
        else:
            return n
        n += 2


def build_table(
    kmers: np.ndarray,
    otu: np.ndarray,
    avg_from_end: np.ndarray,
    fi: np.ndarray,
    wt: np.ndarray,
    num_sigs: Optional[int] = None,
    load_factor: float = 0.6,
) -> KmerTable:
    """Build an open-addressed table from parallel arrays of signatures."""
    kmers = np.asarray(kmers, dtype=np.int64)
    n = len(kmers)
    if n and (kmers.min() < 0 or kmers.max() > MAX_ENCODED):
        raise TableError("k-mer value out of range")
    if num_sigs is None:
        num_sigs = _next_odd_prime(max(int(n / load_factor) + 1, n + 2, 11))

    lib = _builder_native()
    kmers = np.ascontiguousarray(kmers)
    checked_dups = lib is not None  # native table_place checks inline
    while True:
        home = kmers % np.int64(num_sigs)
        # (home, kmer) order via ONE composite-key sort when it fits in 63
        # bits (kmer <= 20^8 < 2^35; any table below 2^28 slots, i.e. every
        # realistic one): ~3x np.lexsort at production sizes. Keys are
        # unique (duplicate k-mers are rejected), so stability is
        # irrelevant.
        if num_sigs <= (1 << 28):
            order = np.argsort((home << np.int64(35)) | kmers)
        else:
            order = np.lexsort((kmers, home))
        # pos[i] = max(home, pos[i-1] + 1): first-free-slot placement.
        # Grow until no chain reaches the final slot (keeps last slot empty
        # and rules out wraparound). A kmer homing to the last slot is
        # common for large n (p ~ 1 - e^{-n/S}), so growth must be gentle:
        # a small prime step re-rolls all homes without inflating the table.
        if lib is not None:
            # fused native pass: homes on the fly, placement recurrence,
            # duplicate detection, max probe — no home_s/kmer gathers
            pos = np.empty(n, dtype=np.int64)
            max_probe = int(lib.table_place(kmers, order, n, num_sigs, pos))
            if max_probe == -2:
                raise TableError("duplicate k-mer values in signature set")
        else:
            home_s = home[order]
            if not checked_dups:
                # duplicates share a home, so they are adjacent in this
                # order — an O(n) vector check (the former Python-set check
                # measured ~40% of the whole build at 50M signatures)
                sk = kmers[order]
                if n > 1 and bool((sk[1:] == sk[:-1]).any()):
                    raise TableError(
                        "duplicate k-mer values in signature set")
                checked_dups = True
            shifted = home_s - np.arange(n, dtype=np.int64)
            pos = np.maximum.accumulate(shifted) + np.arange(n,
                                                             dtype=np.int64)
            if n and pos[-1] >= num_sigs - 1:
                max_probe = -1
            else:
                max_probe = int((pos - home_s).max()) + 1 if n else 1
        if n == 0 or max_probe >= 0:
            break
        num_sigs = _next_odd_prime(num_sigs + max(17, num_sigs >> 12))

    # np.zeros = calloc (lazy zero pages): only the kmer column needs a
    # real pass for its empty sentinel; the former five full-plane strided
    # fills measured ~25% of a production-size build
    slots = np.zeros(num_sigs, dtype=SLOT_DTYPE)
    slots["kmer"] = EMPTY_KMER
    otu = np.ascontiguousarray(otu, dtype=np.int32)
    avg_from_end = np.ascontiguousarray(avg_from_end, dtype=np.int32)
    fi = np.ascontiguousarray(fi, dtype=np.int32)
    wt = np.ascontiguousarray(wt, dtype=np.float32)
    if lib is not None and n:
        # one slice-parallel pass writes whole 24-byte records in sort
        # order (replaces five full-size random gathers + scatters)
        lib.table_fill(order, pos, n, kmers, otu, avg_from_end, fi, wt,
                       slots.view(np.uint8))
    elif n:
        slots["kmer"][pos] = kmers[order]
        slots["otu"][pos] = otu[order]
        slots["avg_from_end"][pos] = avg_from_end[order]
        slots["fi"][pos] = fi[order]
        slots["wt"][pos] = wt[order]

    table = KmerTable(slots=slots, num_sigs=int(num_sigs))
    table.max_probe = int(max_probe) if n else 1
    return table


def _builder_native():
    """Native builder helpers (table_place/table_fill), or None — the
    numpy fallback below is semantically identical."""
    try:
        from ..utils.native import load_scatter

        lib = load_scatter()
    except Exception:  # pragma: no cover - defensive
        return None
    return lib if lib is not None and hasattr(lib, "table_place") else None


def write_table(path: str, table: KmerTable, write_meta: bool = True) -> None:
    header = np.zeros(1, dtype=HEADER_DTYPE)
    header["num_sigs"] = table.num_sigs
    header["entry_size"] = ENTRY_SIZE
    header["version"] = table.version
    raw = header.tobytes() + table.slots.tobytes()
    if path.endswith(".gz"):
        with gzip.open(path, "wb") as fh:
            fh.write(raw)
    else:
        with open(path, "wb") as fh:
            fh.write(raw)
    if write_meta:
        if table.max_probe is None:
            table.compute_max_probe()
        meta_path = os.path.join(os.path.dirname(path) or ".", META_FILE)
        with open(meta_path, "w") as fh:
            json.dump(
                {"num_sigs": table.num_sigs, "max_probe": table.max_probe,
                 "version": table.version},
                fh,
            )


def read_table(path: str, mmap: bool = True) -> KmerTable:
    """Read a table file. Uncompressed files are memory-mapped by default
    (multi-GB production tables shouldn't be copied into RAM; the device
    planes are built from slices on demand)."""
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as fh:
            raw = fh.read()
        header = np.frombuffer(raw[: HEADER_DTYPE.itemsize], dtype=HEADER_DTYPE)[0]
        avail = (len(raw) - HEADER_DTYPE.itemsize) // ENTRY_SIZE
        loader = lambda count: np.frombuffer(
            raw, dtype=SLOT_DTYPE, count=count, offset=HEADER_DTYPE.itemsize
        ).copy()
    else:
        header = np.fromfile(path, dtype=HEADER_DTYPE, count=1)[0]
        avail = (os.path.getsize(path) - HEADER_DTYPE.itemsize) // ENTRY_SIZE
        if mmap:
            loader = lambda count: np.memmap(
                path, dtype=SLOT_DTYPE, mode="r",
                offset=HEADER_DTYPE.itemsize, shape=(count,))
        else:
            loader = lambda count: np.fromfile(
                path, dtype=SLOT_DTYPE, count=count,
                offset=HEADER_DTYPE.itemsize)
    num_sigs = int(header["num_sigs"])
    entry_size = int(header["entry_size"])
    if entry_size != ENTRY_SIZE:
        raise TableError(f"unsupported entrySize {entry_size} (expected {ENTRY_SIZE})")
    count = min(num_sigs, avail)
    slots = loader(count)
    table = KmerTable(slots=slots, num_sigs=num_sigs,
                      version=int(header["version"]),
                      truncated=count < num_sigs)
    meta_path = os.path.join(os.path.dirname(path) or ".", META_FILE)
    if os.path.exists(meta_path):
        try:
            with open(meta_path) as fh:
                meta = json.load(fh)
            if meta.get("num_sigs") == num_sigs:
                table.max_probe = int(meta["max_probe"])
        except (OSError, ValueError, KeyError):
            pass
    if table.max_probe is None:
        with span("table.max_probe"):
            table.compute_max_probe()
    return table


def resolve_table_files(data_dir: str) -> Tuple[str, str]:
    """Resolve table/function files with .gz fallback (ref run() :749-758)."""
    table = os.path.join(data_dir, TABLE_FILE)
    if os.path.exists(table + ".gz"):
        table = table + ".gz"
    func = os.path.join(data_dir, FUNCTION_INDEX_FILE)
    if os.path.exists(func + ".gz"):
        func = func + ".gz"
    return table, func
