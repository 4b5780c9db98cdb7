# Ported from distributed_matvec_tpu/tune/live.py.
"""Live refinement: calibration-as-prior, telemetry-as-evidence.

Catalog rates can sit far off a real machine's rates (the orbit scan's
above all).  This module closes that loop: the calibration
(``obs/roofline.py``) seeds a :class:`RatePosterior`, and every apply
*window*'s measured phase walls update it —

* a phase the engine **measured** directly (the streamed ``plan_h2d``
  H2D stalls) yields a direct rate observation ``bytes / wall``;
* the **unmeasured** remainder yields one shared correction ratio
  ``ρ = priced_remainder / measured_remainder`` applied to every rate
  that contributed to it.  A host-side wall cannot tell a slow gather
  from a slow FLOP apart (the same identifiability caveat as
  ``attribute_phases``' proportional split — this is the honest update a
  host-only decomposition supports), but it converges the *total* price
  to the *total* wall, which is what knob selection ranks on.

Updates are a **log-space EMA** (gain :data:`POSTERIOR_ALPHA`): rates
are scale parameters, so averaging their logs makes a 10×-slow and a
10×-fast error symmetric, and the gain of 0.6 walks a 10× mis-
calibration to within 25% in three windows (10 → 2.5 → 1.44 → 1.16)
while still smoothing per-window timing noise.

:class:`LiveTuner` wraps the posterior with the re-tune policy: when a
window's measured-vs-priced ratio leaves :data:`DRIFT_BAND` — the
symmetric generalization of the roofline report's existing
"measured overlap < 50% of estimate" warning — it re-runs the static
search under the posterior and *proposes* the new config.  The engine
applies it only at a safe boundary (the top of the next apply, never
mid-apply), rebuilding the plan at the new knobs exactly as a fresh
build at those knobs would.

The posterior itself persists as a content-addressed artifact per
(backend, device kind, mode) so capacity planning and the serve
scheduler price admissions at the *learned* rates, not the catalog's.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from typing import Dict, Optional

from ..obs.roofline import RATE_FIELDS, phase_bounds_ms
from ..utils.logging import _process_index, log_debug, log_info, log_warn
from .space import TunedConfig, price_config

__all__ = [
    "POSTERIOR_ALPHA",
    "DRIFT_BAND",
    "DEFAULT_WINDOW",
    "RatePosterior",
    "LiveTuner",
    "posterior_path",
    "save_posterior",
    "load_posterior",
]

#: Log-space EMA gain.  0.6 corrects a 10× mis-calibration to within
#: 25% in three windows; 1.0 would chase single-window noise, 0.3 would
#: take seven windows.
POSTERIOR_ALPHA = 0.6

#: Measured/priced ratios inside this band are calibration noise; a
#: window outside it schedules a re-tune.  (0.5, 2.0) is the roofline
#: report's <50%-of-estimate warning made symmetric.
DRIFT_BAND = (0.5, 2.0)

#: Applies per update window (``DMT_TUNE_WINDOW`` overrides — the
#: tune-check rig shortens it to converge inside a small test budget).
DEFAULT_WINDOW = 8

#: Per-window correction clamp: one pathological wall (paging, a
#: debugger, a power-capped burst) may not move a rate more than 32×.
_RHO_CLAMP = 32.0

#: Phase → the rate fields its bound draws on (mirrors
#: ``roofline.phase_bounds_ms``); the shared remainder correction
#: touches exactly the rates that priced the unmeasured phases.
_PHASE_RATES = {
    "plan_h2d": ("h2d_bytes_per_s",),
    "compute": ("gather_rows_per_s", "flops_per_s"),
    "compute_decode": ("gather_rows_per_s", "flops_per_s"),
    "compute_recompute": ("gather_rows_per_s", "flops_per_s"),
    "exchange": ("exchange_bytes_per_s",),
    "accumulate": ("gather_rows_per_s",),
}


class RatePosterior:
    """Per-(device kind, mode) hardware-rate belief, seeded from a
    calibration and refined by measured apply walls."""

    def __init__(self, prior: dict, alpha: float = POSTERIOR_ALPHA):
        self._log = {k: math.log(float(prior[k])) for k in RATE_FIELDS}
        self.alpha = float(alpha)
        self.backend = str(prior.get("backend", ""))
        self.device_kind = str(prior.get("device_kind", ""))
        self.prior_source = str(prior.get("source", "default"))
        self.n_updates = int(prior.get("n_updates", 0))

    def rates(self) -> dict:
        """The current belief, shaped like a calibration dict (drops
        into every ``roofline`` pricing entry point unchanged)."""
        out = {k: math.exp(v) for k, v in self._log.items()}
        out["backend"] = self.backend
        out["device_kind"] = self.device_kind
        out["source"] = "posterior" if self.n_updates else self.prior_source
        out["n_updates"] = self.n_updates
        return out

    def _nudge(self, field: str, ratio: float) -> None:
        # log-EMA toward (current · ratio): log += α·log(ratio)
        r = min(max(float(ratio), 1.0 / _RHO_CLAMP), _RHO_CLAMP)
        self._log[field] += self.alpha * math.log(r)

    def update(self, counts: Dict[str, dict], wall_ms: float,
               measured: Optional[Dict[str, float]] = None) -> dict:
        """One window's evidence: structural ``counts`` (the engine's
        ``_phase_counts``), the mean steady apply ``wall_ms``, and any
        directly measured phase walls.  Returns the correction ratios
        applied (for telemetry)."""
        measured = {k: float(v) for k, v in (measured or {}).items()
                    if v and v > 0}
        bounds = phase_bounds_ms(counts, self.rates())
        applied = {}
        # direct observations first: measured bytes/wall IS the rate
        for phase, wall in measured.items():
            fields = _PHASE_RATES.get(phase, ())
            by = float(counts.get(phase, {}).get("bytes", 0))
            if len(fields) == 1 and by > 0:
                obs = by / (wall * 1e-3)
                cur = math.exp(self._log[fields[0]])
                self._nudge(fields[0], obs / cur)
                applied[fields[0]] = obs / cur
        # shared correction for everything the host could not split
        rem_meas = float(wall_ms) - sum(measured.values())
        rem_priced = sum(b for p, b in bounds.items()
                         if p not in measured and b > 0)
        if rem_meas > 0 and rem_priced > 0:
            rho = rem_priced / rem_meas
            touched = {f for p, b in bounds.items()
                       if p not in measured and b > 0
                       for f in _PHASE_RATES.get(p, ())}
            for f in sorted(touched):
                self._nudge(f, rho)
                applied[f] = applied.get(f, 1.0) * rho
        self.n_updates += 1
        return applied

    def to_dict(self) -> dict:
        d = {k: math.exp(v) for k, v in self._log.items()}
        d.update(backend=self.backend, device_kind=self.device_kind,
                 source="posterior", prior_source=self.prior_source,
                 n_updates=self.n_updates, alpha=self.alpha)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RatePosterior":
        p = cls(d, alpha=float(d.get("alpha", POSTERIOR_ALPHA)))
        p.prior_source = str(d.get("prior_source", d.get("source",
                                                         "default")))
        return p


# ---------------------------------------------------------------------------
# posterior persistence (capacity / serve admission read these)


def _posterior_fingerprint(backend: str, device_kind: str,
                           mode: str) -> str:
    return hashlib.sha256(
        f"tune-posterior|{backend}|{device_kind}|{mode}|v1"
        .encode()).hexdigest()


def posterior_path(backend: Optional[str] = None,
                   device_kind: Optional[str] = None,
                   mode: str = "streamed") -> Optional[str]:
    """Content-addressed posterior sidecar (None with the artifact layer
    off) — keyed like the calibration sidecar plus the engine mode,
    because a streamed and a hybrid apply exercise the rates through
    different phase mixes."""
    from ..utils.artifacts import artifact_path, artifacts_enabled

    if not artifacts_enabled():
        return None
    if backend is None or device_kind is None:
        from ..obs.roofline import device_identity

        b, k = device_identity(backend)
        backend, device_kind = backend or b, device_kind or k
    try:
        return artifact_path(
            "tuning", _posterior_fingerprint(backend, device_kind, mode),
            ".posterior.json")
    except OSError as e:
        log_debug(f"posterior artifact cache unavailable: {e!r}")
        return None


def save_posterior(post: RatePosterior, mode: str) -> Optional[str]:
    """Atomic soft-fail write, process 0 only — the artifact contract."""
    path = posterior_path(post.backend or None,
                          post.device_kind or None, mode)
    if not path:
        return None
    if _process_index() != 0:
        return None
    try:
        with open(path + ".tmp", "w") as f:
            json.dump(post.to_dict(), f, indent=1, sort_keys=True)
        os.replace(path + ".tmp", path)
    except OSError as e:
        log_warn(f"posterior save skipped ({path}): {e!r}")
        return None
    return path


def load_posterior(backend: Optional[str] = None,
                   device_kind: Optional[str] = None,
                   mode: str = "streamed") -> Optional[dict]:
    """A previously learned posterior's rates, or None."""
    path = posterior_path(backend, device_kind, mode)
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            d = json.load(f)
        if not all(k in d for k in RATE_FIELDS):
            return None
        return d
    except (OSError, json.JSONDecodeError, ValueError) as e:
        log_warn(f"posterior sidecar unreadable ({path}): {e!r}")
        return None


# ---------------------------------------------------------------------------
# the live loop


def tune_window() -> int:
    try:
        return max(int(os.environ.get("DMT_TUNE_WINDOW",
                                      str(DEFAULT_WINDOW))), 1)
    except ValueError:
        return DEFAULT_WINDOW


class LiveTuner:
    """The ``tune=live`` controller one engine owns per mode.

    The engine feeds it one :meth:`observe` per apply (structural
    counts, measured wall, measured phase walls); every
    :func:`tune_window` steady applies it updates the posterior, prices
    the *current* config under the refreshed rates, and — when the
    window's measured-vs-priced ratio left :data:`DRIFT_BAND` — re-runs
    the static search and returns the winning config as a re-tune
    proposal.  Returning is all it does: the ENGINE owns when to apply
    it (next safe boundary) and how (the boundary rebuild), and a proposal
    equal to the current knobs is dropped on the floor.

    The first apply after every (re)build is excluded from the window —
    it carries compilation, not steady-state rates (the same first-apply
    drop ``roofline_report`` performs).
    """

    def __init__(self, mode: str, stats: dict, prior: dict,
                 current: TunedConfig,
                 window: Optional[int] = None):
        self.mode = str(mode)
        self.stats = dict(stats)
        self.posterior = RatePosterior(prior)
        self.current = current
        self.window = int(window) if window else tune_window()
        self.last_ratio: Optional[float] = None
        self.windows = 0
        #: True exactly when the most recent :meth:`observe` closed an
        #: update window — the engine's multi-controller agreement round
        #: keys off this so every rank joins the collective at the same
        #: apply (window boundaries are deterministic in apply count)
        self.window_closed = False
        self._walls = []
        self._measured: Dict[str, float] = {}
        self._counts: Optional[dict] = None
        self._skip_next = True

    def note_rebuild(self, current: TunedConfig) -> None:
        """A (re)build happened: adopt the new config, restart the
        window, and skip the next apply's compile wall."""
        self.current = current
        self._walls = []
        self._measured = {}
        self._counts = None
        self._skip_next = True

    def priced_ms(self) -> float:
        """The current config's price under the current posterior."""
        return price_config(self.stats, self.current,
                            self.posterior.rates())

    def observe(self, counts: Dict[str, dict], wall_ms: float,
                measured: Optional[Dict[str, float]] = None
                ) -> Optional[TunedConfig]:
        """One apply's telemetry in; a re-tune proposal (or None) out."""
        self.window_closed = False
        if self._skip_next:
            self._skip_next = False
            return None
        self._walls.append(float(wall_ms))
        self._counts = counts
        for k, v in (measured or {}).items():
            if v and v > 0:
                self._measured[k] = self._measured.get(k, 0.0) + float(v)
        if len(self._walls) < self.window:
            return None
        mean_wall = sum(self._walls) / len(self._walls)
        mean_meas = {k: v / len(self._walls)
                     for k, v in self._measured.items()}
        # measured-vs-priced on the ENGINE's actual structural counts —
        # the same counts the posterior updates from, so once the rates
        # have converged this ratio sits at ~1 regardless of how far the
        # search's pre-build candidate model sits from the built plan's
        # true geometry (candidate ranking only needs relative prices)
        priced = sum(phase_bounds_ms(counts,
                                     self.posterior.rates()).values())
        self.last_ratio = mean_wall / priced if priced > 0 else None
        self.posterior.update(counts, mean_wall, mean_meas)
        self.windows += 1
        self.window_closed = True
        self._walls = []
        self._measured = {}
        save_posterior(self.posterior, self.mode)
        if self.last_ratio is None:
            return None
        lo, hi = DRIFT_BAND
        if lo <= self.last_ratio <= hi:
            return None
        from dataclasses import replace

        from .search import choose_config

        cand = choose_config(self.stats, self.posterior.rates(),
                             self.mode)
        cand = replace(cand, source="retune")
        if cand.same_knobs(self.current):
            log_debug(
                f"autotune drift (ratio {self.last_ratio:.2f}) but the "
                "search re-picks the current config; rates updated only")
            return None
        log_info(f"autotune: measured/priced ratio "
                 f"{self.last_ratio:.2f} left {DRIFT_BAND}; proposing "
                 f"re-tune {self.current.token()} -> {cand.token()}")
        return cand
