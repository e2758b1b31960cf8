"""The reference's FASTA reader (readFasta, KmerGutsJava.java:1132-1192).

- While seeking a caption, a line whose trimmed length is at most 1 is
  skipped; a longer one that is no caption raises.
- The id is the first token after ``>`` (split on space and tab).
- Blank lines before the first sequence line are skipped; sequence lines
  are appended as they are (only the line break removed) until the next
  caption or the end.

Java's ``String.trim()`` strips every character up to ``' '``.
"""
from __future__ import annotations

import gzip
from typing import Iterator, List, NamedTuple


class Record(NamedTuple):
    id: str
    seq: str


_AT_MOST_SPACE = "".join(chr(c) for c in range(33))


def _trim(s: str) -> str:
    return s.strip(_AT_MOST_SPACE)


def parse(text: str) -> Iterator[Record]:
    lines: List[str] = [ln.rstrip("\r") for ln in text.split("\n")]
    if lines and lines[-1] == "":
        lines.pop()
    i, n = 0, len(lines)
    while True:
        name = None
        while i < n:
            t = _trim(lines[i])
            i += 1
            if len(t) > 1:
                if t[0] == ">" and _trim(t[1:]):
                    name = [x for x in t[1:].replace("\t", " ").split(" ")
                            if x][0]
                    break
                raise ValueError("Wrong caption line: " + t)
        if name is None:
            return
        while True:
            if i >= n or _trim(lines[i]).startswith(">"):
                raise ValueError("No sequence for caption: " + name)
            if _trim(lines[i]):
                break
            i += 1
        parts = []
        while i < n and not _trim(lines[i]).startswith(">"):
            parts.append(lines[i])
            i += 1
        yield Record(name, "".join(parts))


def read_text(path: str) -> str:
    """A FASTA file's text (gzip when the name ends in ``.gz``)."""
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as fh:
            return fh.read().decode("latin-1")
    with open(path, "rb") as fh:
        return fh.read().decode("latin-1")
