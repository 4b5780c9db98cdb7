# Ported from distributed_matvec_tpu/obs/health.py.
"""Numerical-health probes and the solver watchdog.

A pillar of the telemetry subsystem (see ``obs/__init__``): the signals
that catch *silent* numerical decay — NaN/Inf amplitudes, exchange-buffer
overflow, Lanczos orthogonality loss and breakdown — before they surface as
a wrong eigenvalue.

Two kinds of producer report through here:

* **Engine apply probes** (:func:`probe_due` + :func:`probe_apply`): every
  ``health_every``-th apply computes the nonfinite count and the output
  norm of the result as device scalars (two reductions queued right behind
  the apply on the same stream), copies them ``non_blocking`` into a
  pinned host buffer and records a CUDA event behind the copy.  The fused
  engines' overflow/invalid exchange counters ride the same queue via
  :func:`defer_exchange_counters`, and the lossy tiers' drift samples via
  :func:`defer_compress_drift`.  Nothing is fetched inline: :func:`drain`
  (called from the next apply, ``obs.snapshot()``, and harness exit
  points) resolves only the items whose event ``query()`` is true — their
  host buffer is filled — and defers the rest, so the default path adds
  **zero host↔device syncs**: no ``synchronize()`` and no ``.item()``.
  On the CPU the copy lands at once and the same code path reads it.
* **Solver watchdogs** (:func:`record` + :func:`omega_estimate`): Lanczos
  emits orthogonality-loss estimates, β-breakdown and Ritz-stagnation
  detectors as structured ``solver_health`` events with ``warn`` /
  ``critical`` levels; LOBPCG reports nonfinite eigenvalues.

Modes (``DMT_HEALTH`` env var > ``config.health``): ``on`` (default)
logs-and-continues — events + counters, one ``[Warn]`` line per critical
condition; ``strict`` turns critical conditions into a loud
:class:`HealthError` (probe fetches become synchronous there — strictness
buys immediacy at the price of the sync); ``off`` disables the probes.
``DMT_OBS=off`` implies off: the probes are part of the telemetry layer,
and with it off the apply launches nothing for them.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Optional

import numpy as np

from ..utils.config import get_config
from ..utils.logging import log_warn
from .events import emit, obs_enabled
from .metrics import counter, gauge

__all__ = [
    "HealthError",
    "health_mode",
    "probes_enabled",
    "probe_due",
    "probe_apply",
    "defer_exchange_counters",
    "defer_compress_drift",
    "drain",
    "pending_count",
    "record",
    "health_event_count",
    "omega_estimate",
    "reset_health",
    "OMEGA_WARN",
    "OMEGA_CRITICAL",
]

#: ω-recurrence thresholds: √ε is the classical "semi-orthogonality lost"
#: line (Simon '84); 1e-4 marks an estimate so large the recurrence output
#: can no longer be trusted at all.
OMEGA_WARN = 1e-8
OMEGA_CRITICAL = 1e-4


class HealthError(RuntimeError):
    """A critical numerical-health condition under ``DMT_HEALTH=strict``."""


_warned_modes: set = set()


def health_mode() -> str:
    """``"on"`` (log-and-continue, default), ``"strict"``, or ``"off"``.
    The env var is consulted directly (not just the config snapshot) so a
    harness can flip it per subprocess — same contract as
    :func:`~.events.obs_enabled`.  An unrecognized value warns ONCE and
    falls back to ``on``: a typo'd ``strict`` must not silently demote the
    loud failure mode the operator asked for."""
    env = os.environ.get("DMT_HEALTH")
    knob = env if env is not None else get_config().health
    knob = str(knob).strip().lower()
    if knob in ("off", "0", "false", "no"):
        return "off"
    if knob in ("strict",):
        return "strict"
    if knob not in ("on", "1", "true", "yes", "") \
            and knob not in _warned_modes:
        _warned_modes.add(knob)
        log_warn(f"unknown DMT_HEALTH value {knob!r} "
                 "(use on | strict | off); treating as 'on'")
    return "on"


def probes_enabled() -> bool:
    """Whether the health layer is active (requires obs on as well)."""
    return obs_enabled() and health_mode() != "off"


_lock = threading.Lock()
#: pending probe fetches: (kind, fields, names, host buffer, event | None)
_pending: deque = deque(maxlen=4096)
#: resolved (pinned host buffer, event) pairs, reused by later probes: a
#: fresh pinned allocation or event per probe would cost the apply a
#: cudaHostAlloc / cudaEventCreate
_slots: list = []


def probe_due(apply_index: int) -> bool:
    """Whether apply number ``apply_index`` (the engine's own 0-based
    counter) should dispatch the health reduction: the first and every
    ``health_every``-th apply.  Always False when the layer is off, so
    callers never branch on enablement themselves."""
    if not probes_enabled():
        return False
    every = max(int(get_config().health_every), 1)
    return apply_index % every == 0


def _stats(y):
    """The apply result's (nonfinite count, ‖y‖) as one f64 device
    tensor: two reductions queued behind the apply on its stream."""
    import torch

    flat = y.reshape(-1)
    bad = (~torch.isfinite(flat)).sum().to(torch.float64)
    return torch.stack([bad, torch.linalg.vector_norm(flat).to(
        torch.float64)])


def _defer(kind: str, fields: dict, names, vals) -> None:
    """Copy the f64 device tensor ``vals`` (one entry per name) into a
    pinned host buffer behind an event, and queue it (strict mode
    resolves at once — the loud-and-synchronous contract)."""
    import torch

    vals = vals.detach()
    if vals.device.type == "cuda":
        with _lock:
            host, ev = _slots.pop() if _slots else (None, None)
        if host is None:
            host = torch.empty(2, dtype=torch.float64, pin_memory=True)
            ev = torch.cuda.Event()
        host.copy_(vals, non_blocking=True)
        ev.record(torch.cuda.current_stream(vals.device))
    else:
        host, ev = vals.clone(), None
    item = (kind, fields, tuple(names), host, ev)
    if health_mode() == "strict":
        if ev is not None:
            ev.synchronize()
        _resolve(item)
        return
    with _lock:
        _pending.append(item)


def probe_apply(engine: str, y, apply_index: int) -> None:
    """Dispatch the health reduction for one apply result and queue the
    scalars for a deferred fetch."""
    _defer("probe", {"engine": engine, "apply": int(apply_index)},
           ("nonfinite", "norm"), _stats(y))


def defer_exchange_counters(engine: str, apply_index: int,
                            overflow, invalid) -> None:
    """Queue the overflow/invalid exchange counters of one apply (device
    scalars of the fused apply, or the streamed plan's build-time totals)
    for a deferred fetch into obs counters."""
    if not probes_enabled():
        return
    import torch

    vals = torch.stack([torch.as_tensor(overflow).to(torch.float64),
                        torch.as_tensor(invalid).to(torch.float64)
                        .to(torch.as_tensor(overflow).device)])
    _defer("exchange", {"engine": engine, "apply": int(apply_index)},
           ("overflow", "invalid"), vals)


def defer_compress_drift(engine: str, apply_index: int, tier: str,
                         chunk: int, num, den) -> None:
    """Queue one lossy-tier numerical-drift sample (streamed engines with
    ``stream_compress=f32|bf16``, probe-cadence applies only): ``num`` /
    ``den`` are device scalars ‖Δc·x[rows]‖ / ‖c·x[rows]‖ over the probe
    chunk's live plan entries — the *input-weighted* relative coefficient
    error of this exact apply, against the lossless path's exact
    coefficients.  Resolved deferred like every probe into a
    ``compress_rel_err`` gauge + ``compress_drift`` event."""
    if not probes_enabled():
        return
    import torch

    _defer("drift", {"engine": engine, "apply": int(apply_index),
                     "tier": str(tier), "chunk": int(chunk)},
           ("num", "den"), torch.stack([num, den]).to(torch.float64))


def _resolve(item) -> None:
    kind, fields, names, host, ev = item
    vals = dict(zip(names, host.numpy().tolist()))
    if ev is not None:
        with _lock:
            _slots.append((host, ev))
    engine = fields.get("engine", "")
    if kind == "drift":
        num, den = float(vals["num"]), float(vals["den"])
        rel = num / max(den, 1e-300)
        gauge("compress_rel_err", engine=engine,
              tier=fields.get("tier", "")).set(rel)
        emit("compress_drift", rel_err=rel, **fields)
        return
    if kind == "probe":
        bad = int(vals["nonfinite"])
        norm = float(vals["norm"])
        gauge("matvec_output_norm", engine=engine).set(norm)
        counter("matvec_nonfinite", engine=engine).inc(bad)
        if bad:
            record("nonfinite_output", "critical", source="matvec_probe",
                   count=bad, norm=norm, **fields)
    else:
        ov, iv = int(vals["overflow"]), int(vals["invalid"])
        # inc(0) still CREATES the series: the counters are visible in
        # every summarize, zero being the healthy reading
        counter("exchange_overflow", engine=engine).inc(ov)
        counter("exchange_invalid", engine=engine).inc(iv)
        if ov or iv:
            record("exchange_counters", "critical", source="exchange",
                   overflow=ov, invalid=iv, **fields)


def pending_count() -> int:
    """Probe fetches queued and not yet resolved."""
    with _lock:
        return len(_pending)


def drain(block: bool = False) -> None:
    """Fold every queued probe whose host copy has landed (its event's
    ``query()`` is true; always on the CPU) into events and counters; the
    others stay queued.  ``block=True`` waits for each copy first (harness
    exit points, :func:`health_event_count`).  Called from the engines'
    next apply and ``obs.snapshot()`` — by then the device work behind the
    scalars has usually long finished, so nothing waits.  In strict mode
    a critical condition raises :class:`HealthError`."""
    while True:
        with _lock:     # concurrent drains (solver thread + monitor
            ready = None                # thread's snapshot) must not race
            for i, item in enumerate(_pending):
                ev = item[4]
                if ev is None or block or ev.query():
                    ready = item
                    del _pending[i]
                    break
            if ready is None:
                return
        if block and ready[4] is not None:
            ready[4].synchronize()
        _resolve(ready)


def record(check: str, level: str, **fields) -> Optional[dict]:
    """One structured ``health`` event (``solver_health`` for solver
    watchdogs — pass ``solver=...``): ``level`` is ``warn`` or
    ``critical``; critical logs one ``[Warn]`` line and, under
    ``DMT_HEALTH=strict``, raises :class:`HealthError`."""
    if not probes_enabled():
        return None
    kind = "solver_health" if "solver" in fields else "health"
    ev = emit(kind, check=str(check), level=str(level), **fields)
    counter("health_events", level=str(level)).inc()
    if level == "critical":
        detail = " ".join(f"{k}={v}" for k, v in fields.items())
        log_warn(f"health: {check} critical ({detail})")
        if health_mode() == "strict":
            raise HealthError(f"{check}: {detail} (DMT_HEALTH=strict)")
    return ev


def omega_estimate(alph: np.ndarray, bet: np.ndarray, lo: int, m: int,
                   eps: float = 2.0 ** -52) -> float:
    """Orthogonality-loss estimate for the last Lanczos block via the
    ω-recurrence (Paige/Simon)::

        ω_{j+1,i} = (β_i ω_{j,i+1} + (α_i−α_j) ω_{j,i}
                     + β_{i−1} ω_{j,i−1} − β_{j−1} ω_{j−1,i}) / β_j

    The recurrence is evaluated with the post-reorthogonalization baseline
    ω_{j,·} = ε (the solver here always runs ≥1 full MGS pass per step,
    which resets the ω table to roundoff), so what survives is the ONE-STEP
    amplification ε·(β_i + |α_i−α_j| + β_{i−1} + β_{j−1})/β_j — ~ε for a
    healthy recurrence, exploding exactly when β_j collapses relative to
    the spectrum scale (the precursor of breakdown and of genuine
    orthogonality loss).  Returns the max estimate over steps
    ``[lo, m)``; compare against :data:`OMEGA_WARN` / :data:`OMEGA_CRITICAL`.
    """
    a = np.asarray(alph, dtype=np.float64)[:m]
    b = np.asarray(bet, dtype=np.float64)[:m]
    if m - lo <= 0 or a.size == 0:
        return 0.0
    scale = float(np.max(np.abs(a))) + float(np.max(b)) if m else 0.0
    tiny = max(scale, 1.0) * 1e-300
    worst = 0.0
    for j in range(max(lo, 1), m):
        if float(b[j]) < 1e-14:
            # exact breakdown step: the Krylov space closed there, which is
            # the β-breakdown detector's (converged-aware) call, not an
            # orthogonality-loss signal — a HAPPY closure must not trip ω
            continue
        num = float(np.max(b[:j] + np.abs(a[:j] - a[j]))) + float(b[j - 1])
        worst = max(worst, eps * num / max(float(b[j]), tiny, eps * scale))
    return worst


def health_event_count() -> int:
    """Total warn/critical ``health`` + ``solver_health`` events in this
    process's in-memory buffer, after draining pending probe fetches —
    the one shared tally harnesses (bench, the health-check gate) diff
    before/after a run, so the kind list cannot drift between them.
    ``info``-level events (e.g. the selective-reorthogonalization
    fallback marker, which fires on perfectly healthy converging solves)
    are deliberately excluded: the gate's contract is "zero PROBLEMS",
    not "zero telemetry"."""
    drain(block=True)
    from .events import events
    return sum(1 for kind in ("health", "solver_health")
               for e in events(kind)
               if e.get("level") in ("warn", "critical"))


def reset_health() -> None:
    """Drop pending fetches (tests)."""
    with _lock:
        _pending.clear()
        _slots.clear()
