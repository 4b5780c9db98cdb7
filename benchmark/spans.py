"""The device's idle time in the traced segment, put down to the program
span the host was in while the device idled.

The program stamps its spans on the clock ``torch.profiler`` stamps its
events with (``obs/trace.py::clock``).  The metrics read its regular spans
(solve, iteration, apply), from their ``span`` events; the breakdown by
innermost span printed on standard error adds the detail spans below
``apply`` and inside a solver's step that the program recorded in the
window (``obs/trace.py::detail_spans``), where it has them.

Each idle interval of the segment (the complement of the merged device
intervals inside the segment's wall-clock bounds) is cut at every span
boundary, and each piece goes to the innermost span open over it, or to
``outside`` where none is.  The pieces of one segment sum to its idle
time.  ``metrics/idle_apply_ms.py`` and ``metrics/idle_solver_ms.py``
read the result, which is computed once a run; the traced run prints it
on standard error as ``idle_by_span``, beside the medians of the host's
``apply`` spans before and after the segment.
"""

from __future__ import annotations

import importlib
import json
import statistics
import sys
from collections import defaultdict
from typing import List, Optional, Tuple

import harness
import tracing

#: where no program span is open
OUTSIDE = "outside"


def program_spans(t0: float, t1: float) -> List[tuple]:
    """The program's spans that overlap ``[t0, t1]`` (seconds on the
    span clock) as (name, kind, start µs, end µs, attrs): its regular
    spans' ``span`` events, and its detail spans (kind ``detail``) where
    it records them."""
    spans = [(e["name"], e.get("cat"), e["t0"],
              e["t0"] + e["dur_ms"] * 1e-3, e)
             for e in harness.program_events("span")]
    try:
        detail = importlib.import_module(
            harness.PORT + ".obs.trace").detail_spans
    except (ImportError, AttributeError):
        detail = None
    if detail is not None:
        spans += [(s["name"], "detail", s["t0"], s["t1"], {})
                  for s in detail(t0, t1)]
    return [(n, k, a * 1e6, b * 1e6, attrs) for n, k, a, b, attrs in spans
            if b >= t0 and a <= t1]


def idle_intervals(dev, w0: float, w1: float) -> List[Tuple[float, float]]:
    """The complement inside ``[w0, w1]`` of the merged device intervals
    ``dev`` ((start, end, ...) in µs)."""
    busy = tracing._merge((max(d[0], w0), min(d[1], w1)) for d in dev
                          if d[1] > w0 and d[0] < w1)
    out, cur = [], w0
    for a, b in busy:
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < w1:
        out.append((cur, w1))
    return out


def attribute(dev, spans, w0: float, w1: float) -> dict:
    """Cuts the segment's idle time (``dev`` and ``[w0, w1]`` in µs) at
    the boundaries of ``spans`` ((name, kind, start µs, end µs, attrs),
    host spans of one thread, so nested) and gives each piece to the
    innermost span open over it.  Returns ``idle_us``, ``by_span`` (µs by
    innermost name, ``OUTSIDE`` where none), ``apply_us`` (pieces inside
    an ``apply`` span or any descendant), ``solver_us`` (inside a span of
    kind ``solve`` but no ``apply``), ``n_apply`` and ``n_solve`` (the
    spans seen) and ``columns`` (summed over the ``apply`` spans)."""
    idle = idle_intervals(dev, w0, w1)
    # at one instant: ends before starts, an outer start before an inner
    # one, an inner end before an outer one
    points = []
    for a, b in idle:
        points.append((a, 1, 0.0, -1))
        points.append((b, 0, 0.0, -1))
    n_apply = n_solve = columns = 0
    for i, (name, kind, a, b, attrs) in enumerate(spans):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if name == "apply":
            n_apply += 1
            columns += int(attrs.get("columns", 0))
        n_solve += kind == "solve"
        points.append((a, 1, -b, i))
        points.append((b, 0, -a, i))
    points.sort()
    by_span = defaultdict(float)
    apply_us = solver_us = 0.0
    stack: List[int] = []
    idle_depth = in_apply = in_solve = 0
    prev = w0
    for t, starts, _, i in points:
        if t > prev and idle_depth > 0:
            dt = t - prev
            by_span[spans[stack[-1]][0] if stack else OUTSIDE] += dt
            if in_apply:
                apply_us += dt
            elif in_solve:
                solver_us += dt
        prev = t
        step = 1 if starts else -1
        if i < 0:
            idle_depth += step
            continue
        if starts:
            stack.append(i)
        else:
            del stack[len(stack) - 1 - stack[::-1].index(i)]
        in_apply += step * (spans[i][0] == "apply")
        in_solve += step * (spans[i][1] == "solve")
    return {"idle_us": sum(b - a for a, b in idle), "by_span": dict(by_span),
            "apply_us": apply_us, "solver_us": solver_us,
            "n_apply": n_apply, "n_solve": n_solve, "columns": columns}


def segment_idle(ctx) -> Optional[dict]:
    """:func:`attribute` over the run's traced segment, once a run (None
    without a device trace)."""
    got = getattr(ctx, "idle_by_span", None)
    if got is not None:
        return got
    seg = getattr(ctx.loop, "segment", None)
    if ctx.profile is None or seg is None or seg.prof is None:
        return None
    dev, _ = tracing._events(seg.prof)
    t0, t1 = seg.wall
    got = attribute(dev, program_spans(t0, t1), t0 * 1e6, t1 * 1e6)
    ctx.idle_by_span = got
    applies = [e for e in harness.program_events("span")
               if e.get("name") == "apply"]
    print("idle_by_span " + json.dumps({
        "idle_ms": got["idle_us"] * 1e-3,
        "by_span_ms": {k: v * 1e-3 for k, v in got["by_span"].items()},
        "apply_ms": got["apply_us"] * 1e-3,
        "solver_ms": got["solver_us"] * 1e-3,
        "span_columns": got["columns"], "columns": ctx.profile["columns"],
        "apply_host_ms_before": _median(e["dur_ms"] for e in applies
                                        if e["t0"] < t0),
        "apply_host_ms_after": _median(e["dur_ms"] for e in applies
                                       if e["t0"] > t1)}), file=sys.stderr)
    return got


def per_column_ms(ctx, key: str, present: str) -> Optional[float]:
    """``segment_idle(ctx)[key]`` in ms per column of the segment; None
    where the segment saw no span counted by ``present``."""
    got = segment_idle(ctx)
    if got is None or not got[present] or not ctx.profile["columns"]:
        return None
    return got[key] * 1e-3 / ctx.profile["columns"]


def _median(values) -> Optional[float]:
    values = list(values)
    return statistics.median(values) if values else None
