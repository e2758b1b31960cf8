"""The reference engine end to end: FASTA text in, report text out (the
report alone, as ``-o`` writes it and the service returns it; no info
lines), in the reference's format (SURVEY 2.1):

    protein:  PROTEIN-ID <id> <len>, its CALLs, OTU-COUNTS <id>[<len>] ...
    DNA:      processing <id>[<len>], then for +0 +1 +2 -0 -1 -2
              TRANSLATION <id> <len> <strand> <frame> and its CALLs,
              then OTU-COUNTS over the six frames
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import fasta, grouping, lookup, prepare
from .table import Table, functions, open_table


def annotate(text: str, data_dir: str, aa: bool,
             params: grouping.Params = grouping.Params(),
             precision: str = "float32", table: Optional[Table] = None,
             names: Optional[List[str]] = None) -> str:
    table = table if table is not None else open_table(data_dir)
    names = names if names is not None else functions(data_dir)
    q = prepare.queries(list(fasta.parse(text)), aa)
    slot = lookup.probe(table, q.values)
    hit = slot >= 0
    rows = table.slots[slot[hit]]
    cont = q.container[hit]
    order = np.argsort(cont, kind="stable")
    cont = cont[order]
    cols = (q.pos[hit][order], rows["otu"][order], rows["avg"][order],
            rows["fi"][order], rows["wt"][order])
    cut = np.searchsorted(cont, np.arange(len(q.containers) + 1))

    def container_calls(c: int, counts, out: list) -> None:
        a, b = cut[c], cut[c + 1]
        grouping.calls(*(x[a:b] for x in cols), names, counts, out, params,
                       precision)

    out: List[str] = []
    c = 0
    for qid, length in q.lengths.items():
        counts: list = []
        if aa:
            out.append("PROTEIN-ID\t%s\t%d" % (qid, length))
            container_calls(c, counts, out)
            c += 1
        else:
            out.append("processing %s[%d]" % (qid, length))
            for strand in ("+", "-"):
                for frame in range(3):
                    out.append("TRANSLATION\t%s\t%d\t%s\t%d"
                               % (qid, length, strand, frame))
                    container_calls(c, counts, out)
                    c += 1
        out.append(grouping.otu_line(qid, length, counts))
    return "".join(line + "\n" for line in out)
