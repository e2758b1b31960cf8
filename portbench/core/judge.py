"""Whether the timed path's answers are right: the reports that the
program produced in the window, as the client received them or as the
job wrote them, against the plain reference's reports of the same FASTA
on the same table file.

Once the window has closed, a sample drawn from the seed is judged: the
job with the most query 8-mers and ``check.sample - 1`` others. The
numbers compared, each with its limit (an exact comparison: 0):

- ``differing_reports``: sampled reports that differ from the reference's;
- ``differing_lines``: their lines that differ (position by position, and
  the difference in line count);
- ``failed``: jobs of the window that failed or never answered;
- ``judged``: sampled reports compared, at least 1.

With ``precision`` set (``"bfloat16"``), the reference's own reports at
that precision stand in the program's place: the control
(``portbench/control.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..reference import grouping
from ..reference.annotate import annotate
from ..reference.table import functions, open_table


def sample(run) -> List:
    done = run.done
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: done[i].job.kmers)
    rest = [i for i in range(len(done)) if i != longest]
    k = min(run.workload["check"]["sample"] - 1, len(rest))
    others = run.rng(7).choice(len(rest), k, replace=False) if k else []
    return [done[longest], *(done[rest[int(i)]] for i in sorted(others))]


def line_difference(a: str, b: str) -> int:
    x, y = a.split("\n"), b.split("\n")
    return sum(p != q for p, q in zip(x, y)) + abs(len(x) - len(y))


def params(config: dict) -> grouping.Params:
    e = config["engine"]
    return grouping.Params(min_hits=e["min_hits"],
                           min_weighted_hits=e["min_weighted_hits"],
                           max_gap=e["max_gap"],
                           order_constraint=e["order_constraint"])


def judge(run, precision: Optional[str] = None
          ) -> Tuple[Dict[str, dict], bool]:
    """(checks, correct) of the run's window: the program's reports, or
    with ``precision`` the reference's at that precision."""
    table = open_table(run.data_dir)
    names = functions(run.data_dir)
    p = params(run.config)
    want: Dict[str, str] = {}
    control: Dict[str, str] = {}
    judged = diff_reports = diff_lines = 0
    for d in sample(run):
        if not d.ok:
            continue  # counted under failed
        if d.job.name not in want:
            want[d.job.name] = annotate(d.job.fasta(), run.data_dir, run.aa,
                                        p, table=table, names=names)
        got = d.report
        if precision is not None:
            if d.job.name not in control:
                control[d.job.name] = annotate(
                    d.job.fasta(), run.data_dir, run.aa, p,
                    precision=precision, table=table, names=names)
            got = control[d.job.name]
        judged += 1
        if got != want[d.job.name]:
            diff_reports += 1
            diff_lines += line_difference(got, want[d.job.name])
    checks = {
        "judged": {"value": judged, "at_least": 1},
        "failed": {"value": run.failed(), "at_most": 0},
        "differing_lines": {"value": diff_lines, "at_most": 0},
        "differing_reports": {"value": diff_reports, "at_most": 0},
    }
    return checks, passes(checks)


def passes(checks: Dict[str, dict]) -> bool:
    return all(c["value"] >= c["at_least"] if "at_least" in c
               else c["value"] <= c["at_most"] for c in checks.values())


def check_lines(checks: Dict[str, dict]) -> List[str]:
    out = []
    for name, c in checks.items():
        rule = ("at least", c["at_least"]) if "at_least" in c else \
            ("at most", c["at_most"])
        out.append(f"check {name} {c['value']} limit {rule[0]} {rule[1]}")
    return out
