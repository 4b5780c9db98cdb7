# Ported from distributed_matvec_tpu/utils/timers.py.
"""Hierarchical wall-clock timers with tree-formatted reports.

Parity with the reference's pervasive ``Timer`` instrumentation and its
tree-shaped breakdowns gated by ``--kDisplayTimings``
(``src/DistributedMatrixVector.chpl:1028-1052``,
``StatesEnumeration.chpl:561-566``), including mean ± stderr summaries over
repeated phases (``meanAndErrString``, DistributedMatrixVector.chpl:24-32).
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .config import get_config
from .logging import log_info

__all__ = ["TreeTimer", "timed"]


@dataclass
class _Node:
    name: str
    total: float = 0.0
    count: int = 0
    samples: List[float] = field(default_factory=list)
    children: Dict[str, "_Node"] = field(default_factory=dict)

    def child(self, name: str) -> "_Node":
        if name not in self.children:
            self.children[name] = _Node(name)
        return self.children[name]

    def mean_and_err(self) -> str:
        n = len(self.samples)
        if n <= 1:
            return f"{self.total:.6f}"
        mean = sum(self.samples) / n
        var = sum((s - mean) ** 2 for s in self.samples) / (n - 1)
        return f"{self.total:.6f} (mean {mean:.6f} ± {math.sqrt(var / n):.6f}, n={n})"


class TreeTimer:
    """Nested scope timer::

        t = TreeTimer("matvec")
        with t.scope("off-diagonal"):
            with t.scope("kernel"): ...
            with t.scope("all_to_all"): ...
        t.report()   # prints only when display_timings is on
    """

    def __init__(self, name: str = "total"):
        self.root = _Node(name)
        self._stack: List[_Node] = [self.root]
        self._t0 = time.perf_counter()

    @contextmanager
    def scope(self, name: str):
        node = self._stack[-1].child(name)
        self._stack.append(node)
        t0 = time.perf_counter()
        try:
            yield node
        finally:
            dt = time.perf_counter() - t0
            node.total += dt
            node.count += 1
            node.samples.append(dt)
            self._stack.pop()

    def stop(self) -> float:
        self.root.total = time.perf_counter() - self._t0
        self.root.count = 1
        return self.root.total

    def to_dict(self) -> dict:
        """Nested ``{name: {total, count, children}}`` snapshot of the tree
        — machine-readable counterpart of :meth:`report` (the engines'
        ``engine_init`` event reads its build/transfer split)."""
        def walk(node: _Node) -> dict:
            return {"total": node.total, "count": node.count,
                    "children": {k: walk(c)
                                 for k, c in node.children.items()}}
        return walk(self.root)

    def _node(self, path) -> Optional[_Node]:
        node = self.root
        for name in path:
            node = node.children.get(name)
            if node is None:
                return None
        return node

    def last(self, *path: str) -> float:
        """The latest run's seconds of the scope at ``path`` under the root
        (0.0 when the scope never ran)."""
        node = self._node(path)
        return node.samples[-1] if node is not None and node.samples \
            else 0.0

    def scope_total(self, *path: str) -> float:
        """Sum of one scope's total seconds at ``path`` under the root
        (0.0 when the scope never ran)."""
        node = self._node(path)
        return 0.0 if node is None else node.total

    def emit(self, kind: str = "timer_tree", **fields) -> Optional[dict]:
        """Bridge into the telemetry event sink: record the whole timing
        tree (:meth:`to_dict`) as ONE structured event, so existing timer
        instrumentation lands in the same JSONL stream the metrics and
        solver traces use.  Extra ``fields`` ride along (e.g.
        ``config="chain_16"``).  Returns the event dict, or None when the
        obs layer is disabled."""
        from ..obs.events import emit as _emit

        return _emit(kind, timer=self.root.name, tree=self.to_dict(),
                     **fields)

    def report(self, force: bool = False) -> Optional[str]:
        if not (force or get_config().display_timings):
            return None
        if self.root.count == 0:
            self.stop()
        lines: List[str] = []

        def walk(node: _Node, prefix: str, is_last: bool, is_root: bool):
            if is_root:
                lines.append(f"{node.name}: {node.total:.6f}")
                kids = list(node.children.values())
                for i, k in enumerate(kids):
                    walk(k, "", i == len(kids) - 1, False)
                return
            tee = "└─ " if is_last else "├─ "
            lines.append(f"{prefix}{tee}{node.name}: {node.mean_and_err()}")
            kids = list(node.children.values())
            ext = "   " if is_last else "│  "
            for i, k in enumerate(kids):
                walk(k, prefix + ext, i == len(kids) - 1, False)

        walk(self.root, "", True, True)
        text = "\n".join(lines)
        log_info(text)
        return text


@contextmanager
def timed(label: str):
    """One-off timing context, logged through log_info when timings are on."""
    t0 = time.perf_counter()
    yield
    if get_config().display_timings:
        log_info(f"{label}: {time.perf_counter() - t0:.6f}")
