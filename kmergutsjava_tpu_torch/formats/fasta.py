"""Streaming FASTA reader with reference-identical semantics.

Replicates readFasta (KmerGutsJava.java
:1132-1192) exactly, including its quirks:

- while seeking a caption, any line whose *trimmed* length is <= 1 is silently
  skipped (including a bare ">" line);
- a trimmed line of length > 1 that is not a valid caption raises
  "Wrong caption line: <line>";
- a caption must have a non-empty id after ">"; id is the first token split on
  space/tab, the description is the remaining tokens joined by single spaces;
- the first sequence line must exist and not start with ">" (after trimming)
  or we raise "No sequence for caption: <id>"; blank lines before it are
  skipped;
- subsequent sequence lines are appended RAW (untrimmed, so interior spaces
  survive into the sequence, as in the reference) until EOF or a line whose
  trimmed form starts with ">".

Java's String.trim() strips every char <= ' ' from both ends; we mirror that
rather than using Python's whitespace-only strip.
"""
from __future__ import annotations

import gzip
import io
from typing import Iterator, NamedTuple, TextIO, Union


class FastaRecord(NamedTuple):
    id: str
    seq: str
    descr: str


class FastaError(ValueError):
    pass


def _java_trim(s: str) -> str:
    start, end = 0, len(s)
    while start < end and s[start] <= " ":
        start += 1
    while end > start and s[end - 1] <= " ":
        end -= 1
    return s[start:end]


def open_text_maybe_gz(path: str) -> TextIO:
    """Open a text file, transparently decompressing *.gz (ref run() :764-769)."""
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="latin-1")
    return open(path, "r", encoding="latin-1")


_BULK_CAP = 1 << 31  # bulk-parse inputs up to 2 GB of text


def read_fasta(source: Union[str, TextIO]) -> Iterator[FastaRecord]:
    """Yield FastaRecord from a path (optionally .gz) or an open text stream.

    Paths and in-memory streams go through the native bulk parser
    (native/fasta.cpp, one pass over the whole buffer) when the toolchain
    is available and the input is under 2 GB; other streams (e.g. stdin)
    keep the line-by-line Python parser. Both are differentially pinned
    to the scalar Java oracle by tests/test_fasta_fuzz.py. The bulk
    gating (size cap, stream-consumption contract) lives in ONE place:
    read_fasta_bulk_arrays."""
    bulk = read_fasta_bulk_arrays(source)
    if bulk is not None:
        yield from _records_from_bulk(bulk)
    elif isinstance(source, str):
        with open_text_maybe_gz(source) as fh:
            yield from _read_fasta_stream(fh)
    else:
        yield from _read_fasta_stream(source)


def _bulk_available() -> bool:
    from ..utils.native import load_fasta

    return load_fasta() is not None


class BulkFasta(NamedTuple):
    """Raw native-parse result: all record bytes live in one buffer.

    ``rec`` is the int64 [nrec, 6] offset table (id off/len, descr off/len,
    seq off/len into ``buf``). Consumers that only need byte slices (the
    native feeder) index ``buf`` directly with zero per-record Python."""

    buf: "np.ndarray"   # uint8, cleaned record bytes
    rec: "np.ndarray"   # int64 [nrec, 6]
    nrec: int


def _bulk_parse(text: str):
    """One native pass over the whole text -> BulkFasta, or None when the
    input defeats the bulk path (non-latin-1, capacity miscount). Raises
    FastaError with the reference's messages on malformed input."""
    import numpy as np

    from ..utils.native import load_fasta

    lib = load_fasta()
    try:
        data = np.frombuffer(text.encode("latin-1"), dtype=np.uint8)
    except UnicodeEncodeError:
        # non-latin-1 input (only reachable via in-memory streams; file
        # sources are decoded latin-1): use the python parser
        return None
    n = len(data)
    max_rec = int(np.count_nonzero(data == ord(">"))) + 1
    rec = np.empty(6 * max_rec, dtype=np.int64)
    out = np.empty(max(n, 1), dtype=np.uint8)
    err = np.empty(2, dtype=np.int64)
    nrec = lib.parse_fasta(np.ascontiguousarray(data), n, rec, max_rec,
                           out, err)
    payload = lambda: out[err[0]:err[0] + err[1]].tobytes().decode("latin-1")
    if nrec == -1:
        raise FastaError("Wrong caption line: " + payload())
    if nrec == -2:
        raise FastaError("No sequence for caption: " + payload())
    if nrec < 0:  # -3: capacity miscount; cannot happen, but stay safe
        return None
    return BulkFasta(out, rec[:6 * int(nrec)].reshape(-1, 6), int(nrec))


def read_fasta_bulk_arrays(source: Union[str, TextIO, None]):
    """BulkFasta for a path or in-memory stream, or None when the bulk
    path doesn't apply (no toolchain, pipe/stdin stream, >2 GB file,
    non-latin-1 text). Never consumes ``source`` when returning None, so
    the caller can fall back to the record iterator."""
    if not _bulk_available():
        return None
    if isinstance(source, str):
        import os

        try:
            if os.path.getsize(source) >= _BULK_CAP:
                return None
        except OSError:
            return None
        with open_text_maybe_gz(source) as fh:
            return _bulk_parse(fh.read())
    if isinstance(source, io.StringIO):
        pos = source.tell()
        bulk = _bulk_parse(source.getvalue()[pos:])
        if bulk is not None:
            source.seek(0, io.SEEK_END)
        return bulk
    return None


def _records_from_bulk(bulk: "BulkFasta") -> Iterator[FastaRecord]:
    s = bulk.buf.tobytes().decode("latin-1")
    for b in bulk.rec.tolist():
        yield FastaRecord(s[b[0]:b[0] + b[1]],
                          s[b[4]:b[4] + b[5]],
                          s[b[2]:b[2] + b[3]])


def _read_fasta_stream(fh: TextIO) -> Iterator[FastaRecord]:
    def readline():
        line = fh.readline()
        if line == "":
            return None
        return line.rstrip("\r\n")

    str1 = readline()
    while True:
        # --- caption seek (ref :1141-1162) ---
        prot_name = None
        prot_descr = ""
        while str1 is not None:
            str2 = _java_trim(str1)
            if len(str2) > 1:
                if str2[0] == ">" and len(_java_trim(str2[1:])) > 0:
                    tokens = [t for t in str2[1:].replace("\t", " ").split(" ") if t]
                    prot_name = tokens[0]
                    prot_descr = " ".join(tokens[1:])
                    break
                raise FastaError("Wrong caption line: " + str2)
            str1 = readline()
        if prot_name is None:
            return
        # --- first sequence line (ref :1167-1174) ---
        while True:
            str1 = readline()
            if str1 is None or _java_trim(str1).startswith(">"):
                raise FastaError("No sequence for caption: " + prot_name)
            if len(_java_trim(str1)) > 0:
                break
        # --- sequence accumulation, raw lines (ref :1175-1180) ---
        parts = []
        while True:
            parts.append(str1)
            str1 = readline()
            if str1 is None or _java_trim(str1).startswith(">"):
                break
        seq = "".join(parts)
        if len(seq) == 0:
            raise FastaError("No sequence for caption: " + prot_name)
        yield FastaRecord(prot_name, seq, prot_descr)
