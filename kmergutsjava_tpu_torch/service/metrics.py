"""Operational metrics for the RPC service (Prometheus text exposition).

The reference deploys as a KBase service behind Jetty and relies on the
NCSA request log as its only operational signal (scripts/jetty.xml:75-87).
For production serving we add what a modern deployment scrapes instead: a
thread-safe in-process registry rendered in the Prometheus text format
(version 0.0.4 — the stable plain-text contract every collector speaks),
served by the HTTP front-end at ``GET /metrics`` (server.py).

Design: counters and gauges are plain dicts keyed by a (name, labels)
tuple under one lock — request rates here are tiny (hundreds/s at most;
the engine does the heavy lifting per request), so a single lock is
simpler and plenty. Latency is a fixed-bucket cumulative histogram, the
Prometheus-native shape (le-labelled cumulative counts + _sum + _count).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

# Request-latency buckets (seconds). Annotate calls span ~ms (tiny FASTA,
# warm table) to minutes (whole-genome uploads on a cold backend), so the
# grid is log-spaced across that range.
LATENCY_BUCKETS = (0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0, 300.0)

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Optional[Dict[str, str]]) -> _Key:
    return (name, tuple(sorted((labels or {}).items())))


def _esc_label(v: str) -> str:
    # Prometheus text format: label values escape backslash, quote, newline.
    # Values can carry client-controlled strings (e.g. RPC method names), so
    # unescaped output would let a request corrupt the whole exposition.
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc_label(str(v))}"' for k, v in labels)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    # Prometheus accepts integers and floats; keep integers exact.
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class MetricsRegistry:
    """Thread-safe counters + gauges + one histogram family, rendered as
    Prometheus text. All mutation methods are safe from any request
    thread; ``render()`` takes a consistent snapshot under the lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[_Key, float] = {}
        self._gauges: Dict[_Key, float] = {}
        # histogram: key -> (bucket_counts list, sum, count)
        self._hists: Dict[_Key, list] = {}
        self._help: Dict[str, Tuple[str, str]] = {}  # name -> (type, help)
        self.started_at = time.time()
        self.describe("process_start_time_seconds", "gauge",
                      "Unix time the service started")

    def describe(self, name: str, mtype: str, help_text: str) -> None:
        self._help[name] = (mtype, help_text)

    def inc(self, name: str, labels: Optional[Dict[str, str]] = None,
            by: float = 1.0) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + by

    def set_gauge(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = float(value)

    def add_gauge(self, name: str, delta: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        k = _key(name, labels)
        with self._lock:
            self._gauges[k] = self._gauges.get(k, 0.0) + delta

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        k = _key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = [[0] * len(LATENCY_BUCKETS), 0.0, 0]
                self._hists[k] = h
            for i, edge in enumerate(LATENCY_BUCKETS):
                if value <= edge:
                    h[0][i] += 1
            h[1] += value
            h[2] += 1

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: ([*v[0]], v[1], v[2]) for k, v in self._hists.items()}
        gauges[_key("process_start_time_seconds", None)] = self.started_at
        lines = []
        emitted_help = set()

        def head(name: str, default_type: str):
            if name in emitted_help:
                return
            emitted_help.add(name)
            mtype, help_text = self._help.get(name, (default_type, name))
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {mtype}")

        for (name, labels), v in sorted(counters.items()):
            head(name, "counter")
            lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(v)}")
        for (name, labels), v in sorted(gauges.items()):
            head(name, "gauge")
            lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(v)}")
        for (name, labels), (buckets, total, count) in sorted(hists.items()):
            head(name, "histogram")
            # observe() increments every bucket whose edge >= value, so the
            # stored counts are already cumulative (the le-label contract)
            for edge, n in zip(LATENCY_BUCKETS, buckets):
                lab = dict(labels)
                lab["le"] = repr(float(edge))
                lines.append(f"{name}_bucket{_fmt_labels(tuple(sorted(lab.items())))} {n}")
            lab = dict(labels)
            lab["le"] = "+Inf"
            lines.append(f"{name}_bucket{_fmt_labels(tuple(sorted(lab.items())))} {count}")
            lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_value(total)}")
            lines.append(f"{name}_count{_fmt_labels(labels)} {count}")
        return "\n".join(lines) + "\n"
