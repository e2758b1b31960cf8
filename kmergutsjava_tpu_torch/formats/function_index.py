"""function.index reader/writer.

Format (ref KmerGutsJava.java:345-373):
one line per function, ``<index>\t<name>``, indices dense and in order from 0.
The name is everything after the FIRST tab (may itself contain tabs).
Transparent .gz handled via the shared opener.
"""
from __future__ import annotations

import gzip
from typing import List, Sequence

from .fasta import open_text_maybe_gz


class FunctionIndexError(ValueError):
    pass


def load_function_index(path: str) -> List[str]:
    names: List[str] = []
    with open_text_maybe_gz(path) as fh:
        for line_pos, line in enumerate(fh):
            line = line.rstrip("\r\n")
            tab = line.index("\t")
            index = int(line[:tab])
            if line_pos != index:
                raise FunctionIndexError(
                    "Your index must be dense and in order (see line %d)" % line_pos
                )
            names.append(line[tab + 1:])
    return names


def write_function_index(path: str, names: Sequence[str]) -> None:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as fh:
        for i, name in enumerate(names):
            fh.write(f"{i}\t{name}\n")
