# Ported from distributed_matvec_tpu/obs/metrics.py.
"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

One pillar of the telemetry subsystem (see ``obs/__init__``).  A *series* is
an instrument name plus a set of string labels, e.g.::

    counter("artifact_cache", kind="structure", event="hit").inc()
    histogram("matvec_apply_ms", engine="local").observe(dt_ms)
    gauge("ell_table_bytes", engine="distributed").set(eng.ell_nbytes)

Instruments are created on first use and live for the process (the same
lifetime as the warm engines they often describe); :func:`snapshot`
returns the whole registry as plain JSON-able data, which the harnesses emit
as a ``metrics_snapshot`` event so one JSONL stream carries both timelines
and totals.

Disabled-path contract (the zero-overhead guarantee): with the layer off
every accessor returns the shared :data:`NULL` no-op instrument — no
allocation, no registry mutation, no device work.  All updates are host-side
Python on numbers already resident on the host; instrumentation never
synchronizes the card or reads a device tensor, so recording can never add a
host↔device sync to a hot path.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, Optional, Sequence, Tuple

from .events import obs_enabled

__all__ = [
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "series_name",
    "reset_metrics",
    "Counter",
    "Gauge",
    "Histogram",
    "NULL",
    "DEFAULT_BUCKETS",
]

# Default histogram upper bounds (ms-oriented: apply latencies span ~0.1 ms
# CPU smoke configs to ~10 s cold distributed applies); a final +inf bucket
# is implicit.
DEFAULT_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                   250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class _Null:
    """Shared no-op instrument returned by every accessor when the layer is
    disabled — callers never branch on enablement themselves."""

    __slots__ = ()

    def inc(self, amount=1):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass

    @property
    def value(self):
        return 0


NULL = _Null()


class Counter:
    """Monotonically increasing count (events, bytes)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, amount=1):
        self.value += amount


class Gauge:
    """Last-write-wins scalar (sizes, capacities)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value):
        self.value = float(value)


class Histogram:
    """Fixed-bucket histogram with sum/count (latency distributions).

    ``buckets`` are inclusive upper bounds; one overflow bucket is
    appended.  Bucket geometry is fixed at series creation — a later call
    with different ``buckets`` reuses the existing series unchanged (the
    registry is process-wide; silent re-bucketing would corrupt it).
    """

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        if any(b2 <= b1 for b1, b2 in zip(self.buckets, self.buckets[1:])):
            raise ValueError(f"histogram buckets must be strictly "
                             f"increasing, got {self.buckets}")
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value):
        v = float(value)
        self.counts[bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_dict(self) -> dict:
        return {"buckets": list(self.buckets), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}


_Key = Tuple[str, str, Tuple[Tuple[str, str], ...]]
_lock = threading.Lock()
_registry: Dict[_Key, object] = {}


def _labels_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def series_name(name: str, labels: dict) -> str:
    """Canonical flat series id: ``name{k=v,...}`` (labels sorted)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in _labels_key(labels))
    return f"{name}{{{inner}}}"


def _series(kind: str, cls, name: str, labels: dict, *args):
    if not obs_enabled():
        return NULL
    key = (kind, name, _labels_key(labels))
    inst = _registry.get(key)
    if inst is None:
        with _lock:
            inst = _registry.get(key)
            if inst is None:
                inst = cls(*args)
                _registry[key] = inst
    return inst


def counter(name: str, **labels) -> Counter:
    return _series("counter", Counter, name, labels)


def gauge(name: str, **labels) -> Gauge:
    return _series("gauge", Gauge, name, labels)


def histogram(name: str, buckets: Optional[Sequence[float]] = None,
              **labels) -> Histogram:
    return _series("histogram", Histogram, name, labels,
                   buckets if buckets is not None else DEFAULT_BUCKETS)


def snapshot() -> dict:
    """The whole registry as plain data:
    ``{"counters": {series: value}, "gauges": {...},
    "histograms": {series: {buckets, counts, sum, count}}}``."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    with _lock:
        items = list(_registry.items())
    for (kind, name, lk), inst in items:
        sname = series_name(name, dict(lk))
        if kind == "counter":
            out["counters"][sname] = inst.value
        elif kind == "gauge":
            out["gauges"][sname] = inst.value
        else:
            out["histograms"][sname] = inst.to_dict()
    return out


def reset_metrics() -> None:
    """Drop every series (tests)."""
    with _lock:
        _registry.clear()
