"""The traced part of a ``--trace 1`` run: one ``torch.profiler`` window
over a steady segment of the measured window, reduced to device time by
kernel, the device's busy seconds, and the longest idle gaps by what the
host was doing in them.  The reduction runs once the window has closed.

On the card the profiler records CUDA activity alone (kernels, copies and
the CUDA runtime's calls): recording every operator on the host as well
slowed a streamed apply of some 2 000 launches by about a quarter, so that
the idle share measured the profiler.  The loops time the same work
untraced (``Loop.untraced_s``) beside the segment, so each traced run
shows what the profiler still costs; ``metrics/idle_share.py`` divides
the device's busy seconds by those untraced seconds for that reason."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional

import yardstick

TOP = 10


class Segment:
    """Profiles the requests run inside it.  ``columns`` counts the
    columns of H·X the segment applied (the loop adds them)."""

    def __init__(self, sync):
        self.sync = sync
        self.prof = None
        self.wall_s = 0.0
        self.columns = 0
        self.open = False
        self.wall = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        self.prof = profile(activities=[
            ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU])
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        self.wall = [time.time(), None]
        self.open = True

    def stop(self) -> None:
        self.sync()
        self.wall_s = time.perf_counter() - self._t0
        self.wall[1] = time.time()
        t = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.stop_s = time.perf_counter() - t
        self.open = False

    def summary(self) -> Optional[dict]:
        """``kernels``: [name, seconds, phase] of every device operation;
        ``busy_s``: the union of their intervals; ``window_s``: the
        segment's length; ``device_ops`` and ``idle_gaps``: the breakdown's
        two lists."""
        if self.prof is None:
            return None
        dev, host = _events(self.prof)
        if not dev:
            return None
        kernels = [[name, (b - a) * 1e-6, yardstick.classify_kernel(name)]
                   for a, b, name in dev]
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, _ in kernels:
            by_name[name] += s
        device_ops = sorted(([n[:120], s] for n, s in by_name.items()),
                            key=lambda r: -r[1])[:TOP]
        merged = _merge((a, b) for a, b, _ in dev)
        busy_us = sum(b - a for a, b in merged)
        gaps = [(merged[i][1], merged[i + 1][0])
                for i in range(len(merged) - 1)
                if merged[i + 1][0] > merged[i][1]]
        return {"kernels": kernels, "busy_s": busy_us * 1e-6,
                "window_s": self.wall_s, "columns": self.columns,
                "device_ops": device_ops,
                "idle_gaps": _label_gaps(gaps, host)}


def _events(prof):
    """(device, host) operations of a finished profile as (start µs, end
    µs, name), read from the raw kineto records (building the profiler's
    event tree for a streamed solve takes minutes)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() * 1e-3
        b = a + e.duration_ns() * 1e-3
        if e.device_type() == DeviceType.CUDA:
            dev.append((a, b, e.name()))
        elif b > a:
            host.append((a, b, e.name()))
    return dev, host


def warm_up(sync) -> None:
    """One profiler window over nothing, so that the profiler's own start
    (CUPTI's, seconds on the card) is paid in set-up."""
    seg = Segment(sync)
    seg.start()
    seg.stop()


def _merge(intervals) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def _label_gaps(gaps, host) -> List[list]:
    """Idle seconds summed by the host operation in flight at each gap's
    midpoint, the latest started of those that span it ("host idle" where
    none does), the longest ``TOP``."""
    host.sort()
    starts = [h[0] for h in host]
    total: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        label = "host idle"
        for h in reversed(host[max(0, i - 400):i]):
            if h[1] >= mid:
                label = h[2][:120]
                break
        total[label] += (b - a) * 1e-6
    return sorted(([k, v] for k, v in total.items()),
                  key=lambda r: -r[1])[:TOP]
