# Ported from distributed_matvec_tpu/obs/slo.py.
"""Declarative SLOs with multi-window burn-rate alerting.

An SLO here is a :class:`SloSpec`: a sampled signal (events of one
``kind``, optionally filtered by payload ``where`` and sampled at one
``field``), an objective, and **burn-rate windows**.  Evaluation follows
the multi-window discipline of SRE practice: an alert fires only when
EVERY window's burn rate exceeds its threshold — the long window proves
the budget is really burning, the short window proves it is burning
*now* (so a stale incident auto-clears instead of paging forever).  The
default pair ``((300 s, 14.4), (3600 s, 6))`` is the classic fast-burn
page: 14.4× burn over 5 minutes AND 6× over the hour.

Three spec modes:

* ``threshold`` — samples are field values; a sample violates when it
  crosses ``target`` (direction from ``higher_is_better``).  Burn rate =
  (violating fraction in window) / (1 − objective).  ``target=None``
  self-baselines from the run's earliest quartile of samples times
  ``baseline_slack`` — the early steady state is the baseline, and an
  explicit priced estimate can always be pinned via ``targets=``.
* ``count`` — samples are occurrences (stalls, faults, OOMs); ``target``
  is the allowed events/hour (0 ⇒ any occurrence in every window is an
  infinite burn).
* ``rate_min`` — a throughput floor (solves/min); burn = target/actual,
  so falling throughput burns hotter.  ``target=None`` self-baselines
  at a quarter of the run's average rate.

Inside the package :func:`check_slos` emits ``slo_alert`` events and bumps
the ``slo_alert_count`` counter on firing↔clear transitions; :func:`evaluate`
is the pure evaluation, equal to the JAX package's on the same events.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .directions import is_higher_better
from .events import emit as _emit
from .events import events as _ring_events
from .events import obs_enabled as _obs_enabled
from .metrics import counter as _counter

__all__ = [
    "SloSpec",
    "DEFAULT_WINDOWS",
    "default_slos",
    "evaluate",
    "check_slos",
    "reset_slo",
]

#: (window seconds, burn-rate threshold) — fast-burn page: the alert
#: fires when BOTH the 5-minute and the 1-hour burn exceed their bound.
DEFAULT_WINDOWS: Tuple[Tuple[float, float], ...] = ((300.0, 14.4),
                                                    (3600.0, 6.0))


@dataclass
class SloSpec:
    """One service-level objective over the event stream."""

    name: str                          # metric-style id (direction rules)
    kind: str                          # event kind sampled
    field: str = ""                    # payload field (threshold mode)
    where: dict = None                 # payload equality filter
    mode: str = "threshold"            # threshold | count | rate_min
    target: Optional[float] = None     # None => self-baseline
    objective: float = 0.99            # promised good-sample fraction
    higher_is_better: Optional[bool] = None   # None => directions table
    windows: Sequence[Tuple[float, float]] = DEFAULT_WINDOWS
    baseline_slack: float = 4.0        # auto-target = baseline * slack
    description: str = ""

    def __post_init__(self):
        if self.where is None:
            self.where = {}
        if self.higher_is_better is None:
            self.higher_is_better = is_higher_better(self.name)


def default_slos(targets: Optional[Dict[str, float]] = None
                 ) -> List[SloSpec]:
    """The stock SLO set: serve latency + throughput, solver
    steady-state walls, compression drift, and the incident counters.
    ``targets`` pins explicit objectives (e.g. the tuner's priced
    steady-apply estimate) by SLO name."""
    t = dict(targets or {})
    return [
        SloSpec("serve_p99_latency_ms", kind="job_event",
                where={"status": "done"}, field="latency_ms",
                target=t.get("serve_p99_latency_ms"),
                description="terminal job latency vs objective"),
        SloSpec("serve_solves_per_min", kind="job_event",
                where={"status": "done"}, mode="rate_min",
                target=t.get("serve_solves_per_min"),
                description="solve throughput floor"),
        SloSpec("steady_apply_ms", kind="matvec_apply", field="wall_ms",
                target=t.get("steady_apply_ms"),
                description="eager apply wall vs tuned/priced estimate"),
        SloSpec("solver_iteration_ms", kind="span",
                where={"cat": "iteration"}, field="dur_ms",
                target=t.get("solver_iteration_ms"),
                description="solver iteration wall vs steady baseline"),
        SloSpec("compress_rel_err", kind="compress_drift", field="rel_err",
                target=t.get("compress_rel_err", 1e-3),
                description="streamed-plan decode drift bound"),
        SloSpec("stall_reports", kind="stall_report", mode="count",
                target=t.get("stall_reports", 0.0),
                description="heartbeat stall reports (allowed/h)"),
        SloSpec("faults_injected", kind="fault_injected", mode="count",
                target=t.get("faults_injected", 0.0),
                description="injected faults fired (allowed/h)"),
        SloSpec("oom_reports", kind="memory_report", mode="count",
                target=t.get("oom_reports", 0.0),
                description="OOM diagnoses (allowed/h)"),
    ]


def _matches(ev: dict, spec: SloSpec) -> bool:
    if ev.get("kind") != spec.kind:
        return False
    for k, v in spec.where.items():
        if ev.get(k) != v:
            return False
    return True


def _samples(events: List[dict], spec: SloSpec) -> List[Tuple[float, float]]:
    out = []
    for ev in events:
        if not _matches(ev, spec):
            continue
        ts = ev.get("ts")
        if ts is None:
            continue
        if spec.field:
            v = ev.get(spec.field)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            out.append((float(ts), float(v)))
        else:
            out.append((float(ts), 1.0))
    out.sort(key=lambda s: s[0])
    return out


def _auto_target(spec: SloSpec,
                 samples: List[Tuple[float, float]]) -> Optional[float]:
    """Self-baseline: the earliest quartile (≥5 samples) of the run sets
    the steady state; the target is its median scaled by the slack (or
    its rate scaled DOWN for throughput floors)."""
    if spec.mode == "rate_min":
        if len(samples) < 2:
            return None
        dt = samples[-1][0] - samples[0][0]
        if dt <= 0:
            return None
        return (len(samples) / dt) * 60.0 * 0.25
    n = len(samples)
    if n < 2:
        return None
    head = sorted(v for _, v in samples[: max(5, n // 4)])
    median = head[len(head) // 2]
    if spec.higher_is_better:
        return median / spec.baseline_slack
    return median * spec.baseline_slack


def _violates(spec: SloSpec, value: float, target: float) -> bool:
    return value < target if spec.higher_is_better else value > target


def evaluate(events: List[dict], specs: Optional[List[SloSpec]] = None,
             now: Optional[float] = None) -> List[dict]:
    """Pure evaluation of ``specs`` over ``events`` (any rank mix; the
    envelope ``ts`` orders them).  ``now`` anchors the windows — defaults
    to the newest event timestamp, which makes post-hoc reads
    deterministic.  Returns one status dict per spec::

        {"name", "mode", "state": "ok"|"firing"|"no-data", "target",
         "samples", "worst_burn",
         "windows": [{"window_s", "max_burn", "burn", "samples", "bad"}]}
    """
    if specs is None:
        specs = default_slos()
    if now is None:
        now = max((e.get("ts", 0.0) for e in events), default=0.0)
    out = []
    for spec in specs:
        samples = _samples(events, spec)
        target = spec.target
        if target is None:
            target = _auto_target(spec, samples)
        budget = max(1.0 - float(spec.objective), 1e-9)
        windows = []
        firing = bool(spec.windows) and (target is not None
                                         or spec.mode == "count")
        for window_s, max_burn in spec.windows:
            sub = [s for s in samples if s[0] > now - window_s]
            if spec.mode == "count":
                n = len(sub)
                allowed = float(target or 0.0)
                if allowed <= 0.0:
                    burn = float("inf") if n else 0.0
                else:
                    burn = (n / window_s * 3600.0) / allowed
                bad = n
            elif spec.mode == "rate_min":
                # a window larger than the observed run must not dilute
                # the rate: a 5-min window over a 2-s CI drain would
                # grade any throughput as near-zero, so the denominator
                # is clamped to the data span actually covered
                eff_s = min(window_s, max(now - samples[0][0], 1e-3)) \
                    if samples else window_s
                rate = len(sub) / eff_s * 60.0
                tgt = float(target) if target is not None else 0.0
                burn = (float("inf") if rate <= 0.0 else tgt / rate) \
                    if tgt > 0.0 else 0.0
                bad = 0
            else:
                bad = sum(1 for _, v in sub
                          if target is not None
                          and _violates(spec, v, float(target)))
                frac = bad / len(sub) if sub else 0.0
                burn = frac / budget
                if spec.mode == "threshold" and not sub:
                    firing = False
            windows.append({"window_s": window_s, "max_burn": max_burn,
                            "burn": burn, "samples": len(sub), "bad": bad})
            if not (burn > max_burn):
                firing = False
        if spec.mode == "rate_min" and not samples:
            firing = False              # a run with no serve plane at all
        state = "firing" if firing else (
            "no-data" if not samples and spec.mode != "count" else "ok")
        worst = max((w["burn"] for w in windows), default=0.0)
        out.append({"name": spec.name, "mode": spec.mode, "state": state,
                    "target": target, "samples": len(samples),
                    "worst_burn": worst, "windows": windows,
                    "description": spec.description})
    return out


_state_lock = threading.Lock()
_fired: Dict[str, bool] = {}


def check_slos(specs: Optional[List[SloSpec]] = None,
               now: Optional[float] = None,
               events: Optional[List[dict]] = None) -> List[dict]:
    """Evaluate in-process (over the live event ring by default) and emit
    ``slo_alert`` events on state TRANSITIONS: ``state="firing"`` (also
    bumping the ``slo_alert_count`` counter) when an ok SLO starts
    burning, ``state="clear"`` when a firing one recovers.  Steady states
    emit nothing, so a healthy service's stream stays alert-free.  Inert
    when the layer is off.  A newly firing SLO also takes a triggered
    profile capture (``obs/profile.trigger_capture``) when profiling is
    on."""
    if not _obs_enabled():
        return []
    statuses = evaluate(events if events is not None else _ring_events(),
                        specs, now=now)
    fired_now = []
    with _state_lock:
        for st in statuses:
            prev = _fired.get(st["name"], False)
            if st["state"] == "firing" and not prev:
                _fired[st["name"]] = True
                _counter("slo_alert_count").inc()
                _emit("slo_alert", level="critical", slo=st["name"],
                      state="firing", burn=round(st["worst_burn"], 4)
                      if st["worst_burn"] != float("inf") else "inf",
                      target=st["target"], mode=st["mode"],
                      samples=st["samples"])
                fired_now.append(st)
            elif st["state"] == "ok" and prev:
                _fired[st["name"]] = False
                _emit("slo_alert", slo=st["name"], state="clear",
                      target=st["target"], mode=st["mode"])
    # triggered deep capture (obs/profile.py): a burning SLO snapshots
    # the hottest kernels + newest sampled trace into one flight bundle
    # so the incident carries its own profile.  Lazy + soft-fail: the
    # alert must land even when the capture path cannot.
    for st in fired_now:
        try:
            from . import profile as _profile
            _profile.trigger_capture(f"slo_burn_{st['name']}",
                                     slo=st["name"],
                                     burn=st["worst_burn"]
                                     if st["worst_burn"] != float("inf")
                                     else "inf")
        except Exception:
            pass
    return statuses


def reset_slo() -> None:
    """Forget firing state (tests)."""
    with _state_lock:
        _fired.clear()
