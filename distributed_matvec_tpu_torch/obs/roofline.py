# Ported from distributed_matvec_tpu/obs/roofline.py (calibration sidecars, the phase model, the auto policies, the report; not the HLO column).
"""Analytical roofline model over ``apply_phases`` events + rate calibration.

For every (engine, mode) seen in a telemetry run this module combines the
*structural* phase counts (``obs/phases.py``) with measured hardware rates
to compute

* a **bound time** per phase (the time the phase would take running at the
  calibrated rate: bytes / bandwidth, gathers / gather-rate),
* an **attributed wall** per phase — measured where the engines measured it
  (streamed ``plan_h2d``), otherwise the leftover apply wall split in
  proportion to the bounds, so the phase walls *sum to the measured apply
  wall exactly*,
* the per-phase **achieved-vs-bound fraction** (bound / attributed wall),
* the **binding resource** — the phase with the largest bound share, named
  via :data:`~.phases.PHASE_RESOURCE`, and
* a **pipelined-apply speedup estimate**: overlapping the exchange of chunk
  *i* with the compute of chunk *i+1* saves ``min(compute, exchange) ·
  (1 − 1/nchunks)``.

The same model prices the two ``auto`` policies of ``DistributedEngine``
(:func:`choose_pipeline_depth`, :func:`choose_hybrid_split`) and the
autotuner's knob search (``tune/``).

Calibration: measured rates live in a content-addressed JSON sidecar under
the artifact root (``calibration/<fp>.json``; fingerprint = backend
``cuda`` or ``cpu`` + the device's name).  ``python -m
distributed_matvec_tpu_torch.obs.calibrate`` measures and writes it; this
module, the engines and ``serve/capacity.py`` read it.  Without a sidecar
:data:`DEFAULT_CALIBRATIONS` applies — every report states its source.

The JAX module's third report column (``hlo_phase_split``, priced from the
compiled program's ``hlo_cost`` events) waits for a counterpart of its
``obs/hlo.py``; the report here takes the path that has no such events.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.logging import log_debug, log_warn
from .phases import ORBIT_OPS, PHASE_RESOURCE, PHASES

__all__ = [
    "RATE_FIELDS",
    "ORBIT_OPS",
    "DEFAULT_CALIBRATIONS",
    "device_identity",
    "default_calibration",
    "calibration_path",
    "save_calibration",
    "load_calibration",
    "resolve_calibration",
    "phase_bounds_ms",
    "attribute_phases",
    "choose_pipeline_depth",
    "price_term_split",
    "choose_hybrid_split",
    "roofline_report",
    "print_roofline",
    "reconcile_error",
]

#: Rate fields every calibration carries (units in the name).
RATE_FIELDS = ("gather_rows_per_s", "h2d_bytes_per_s",
               "exchange_bytes_per_s", "flops_per_s")

#: Rates per backend when no measured sidecar exists.  ``cpu`` holds the
#: JAX package's CPU-rig figures, so the CPU parity tests price alike in
#: both packages.  ``cuda`` holds the rates ``obs/calibrate.py`` measured
#: on one H100 (the card's name and power limit as ``nvidia-smi
#: --query-gpu=name,power.limit`` printed them, PERF.md §5).
DEFAULT_CALIBRATIONS: Dict[str, Dict[str, float]] = {
    "cpu": {"gather_rows_per_s": 25e6, "h2d_bytes_per_s": 8e9,
            "exchange_bytes_per_s": 4e9, "flops_per_s": 5e9},
    # NVIDIA H100 80GB HBM3, 700.00 W: python -m
    # distributed_matvec_tpu_torch.obs.calibrate (the first of two runs
    # back to back; the second read 6 % fewer gathers, 10 % less exchange)
    "cuda": {"gather_rows_per_s": 45469009982.926186,
             "h2d_bytes_per_s": 51628558415.4614,
             "exchange_bytes_per_s": 1076566708426.8965,
             "flops_per_s": 164838047131.27368},
}

#: Scatter-side entries are weighted 2× a gather (the ELL split cost
#: model's weighting, parallel/engine.py::choose_ell_split).
SCATTER_WEIGHT = 2.0


def device_identity(device=None) -> Tuple[str, str]:
    """``(backend, device kind)`` of ``device`` (a torch device or its
    name; None: ``cuda`` when a card is present, else ``cpu``): the
    card's name from ``torch.cuda.get_device_name``, or the CPU's."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return "cuda", torch.cuda.get_device_name(device)
    return "cpu", platform.processor() or platform.machine() or "cpu"


def default_calibration(backend: Optional[str] = None) -> dict:
    """The default rates for ``backend`` (``cuda`` when a card is present
    and None is given, else ``cpu``), tagged ``source="default"`` so
    reports say so."""
    if backend is None:
        backend = device_identity()[0]
    base = DEFAULT_CALIBRATIONS.get(
        str(backend).lower(), DEFAULT_CALIBRATIONS["cpu"])
    return dict(base, backend=str(backend), source="default")


def _calibration_fingerprint(backend: str, device_kind: str) -> str:
    return hashlib.sha256(
        f"calibration|{backend}|{device_kind}|v1".encode()).hexdigest()


def calibration_path(backend: Optional[str] = None,
                     device_kind: Optional[str] = None) -> Optional[str]:
    """Content-addressed sidecar path for this backend's measured rates
    (None when the artifact layer is off or the root is uncreatable)."""
    from ..utils.artifacts import artifact_path, artifacts_enabled

    if not artifacts_enabled():
        return None
    if backend is None or device_kind is None:
        b, k = device_identity(backend)
        backend, device_kind = backend or b, device_kind or k
    try:
        return artifact_path(
            "calibration", _calibration_fingerprint(backend, device_kind),
            ".json")
    except OSError as e:
        log_debug(f"calibration cache unavailable: {e!r}")
        return None


def save_calibration(cal: dict, path: Optional[str] = None) -> Optional[str]:
    """Persist measured rates (atomic write; soft-fail — a read-only
    checkout must not turn a measurement into an I/O error).  Returns the
    path written, or None."""
    path = path or calibration_path(cal.get("backend"),
                                    cal.get("device_kind"))
    if not path:
        return None
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path + ".tmp", "w") as f:
            json.dump(dict(cal, source="measured"), f, indent=1,
                      sort_keys=True)
        os.replace(path + ".tmp", path)
    except OSError as e:
        log_warn(f"calibration save failed ({path}): {e!r}")
        return None
    log_debug(f"calibration saved to {path}")
    return path


def load_calibration(path: Optional[str] = None, device=None
                     ) -> Optional[dict]:
    """Read a calibration sidecar (the default content-addressed one of
    ``device`` when ``path`` is None); None when absent/unreadable."""
    if not path:
        b, k = device_identity(device)
        path = calibration_path(b, k)
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            cal = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        log_warn(f"calibration sidecar unreadable ({path}): {e!r}")
        return None
    if not all(k in cal for k in RATE_FIELDS):
        log_warn(f"calibration sidecar {path} missing rate fields; ignored")
        return None
    return cal


def resolve_calibration(path: Optional[str] = None, device=None) -> dict:
    """Explicit path > saved measured sidecar of ``device`` > the
    defaults of its backend.  An explicit path that is missing or invalid
    raises — a user who pointed at a calibration must never get a
    silently re-priced report."""
    if path:
        cal = load_calibration(path)
        if cal is None:
            raise FileNotFoundError(
                f"calibration file {path} is missing or carries no rate "
                "fields (expected an obs/calibrate.py JSON)")
        return cal
    cal = load_calibration(device=device)
    if cal is not None:
        return cal
    backend, kind = device_identity(device)
    return dict(default_calibration(backend), device_kind=kind)


# ---------------------------------------------------------------------------
# the model


def phase_bounds_ms(phases: Dict[str, dict], cal: dict) -> Dict[str, float]:
    """Bound time (ms) per phase at the calibrated rates:

    * ``plan_h2d``   bytes / h2d_bytes_per_s
    * ``compute``    gathers / gather_rows_per_s + flops / flops_per_s
      (same formula for the hybrid split pair ``compute_decode`` /
      ``compute_recompute`` — the decode side carries gathers, the
      recompute side orbit-scan flops, so each prices at its own
      resource)
    * ``exchange``   bytes / exchange_bytes_per_s
    * ``accumulate`` SCATTER_WEIGHT · gathers / gather_rows_per_s

    Phases with no structural counts bound at 0 (``overhead`` always)."""
    g = float(cal["gather_rows_per_s"])
    h = float(cal["h2d_bytes_per_s"])
    x = float(cal["exchange_bytes_per_s"])
    fl = float(cal["flops_per_s"])
    out = {}
    for p, c in phases.items():
        by = float(c.get("bytes", 0))
        ga = float(c.get("gathers", 0))
        f = float(c.get("flops", 0))
        if p == "plan_h2d":
            t = by / h
        elif p in ("compute", "compute_decode", "compute_recompute"):
            t = ga / g + f / fl
        elif p == "exchange":
            t = by / x
        elif p == "accumulate":
            t = SCATTER_WEIGHT * ga / g
        else:
            t = 0.0
        out[p] = t * 1e3
    return out


def attribute_phases(phases: Dict[str, dict], wall_ms: float,
                     cal: dict) -> Dict[str, dict]:
    """Split one apply's measured wall across phases.

    Measured phase walls (streamed ``plan_h2d``'s H2D waits) are taken as
    recorded; the remaining wall is distributed over the model-bounded
    phases in proportion to their bounds (so a phase's achieved-vs-bound
    fraction is bound/attributed — the same number for every attributed
    phase, which is the honest statement a host-side-only decomposition can
    make); with no bounded phases the remainder lands in ``overhead``.  The
    attributed walls sum to ``wall_ms`` exactly by construction."""
    bounds = phase_bounds_ms(phases, cal)
    measured = {p: float(c["wall_ms"]) for p, c in phases.items()
                if c.get("wall_ms") is not None}
    remaining = max(wall_ms - sum(measured.values()), 0.0)
    bounded = {p: b for p, b in bounds.items()
               if b > 0 and p not in measured}
    total_bound = sum(bounded.values())
    out = {}
    for p in PHASES:
        if p != "overhead" and p not in phases:
            continue
        c = phases.get(p, {})
        if p in measured:
            w = measured[p]
        elif p in bounded and total_bound > 0:
            w = remaining * bounded[p] / total_bound
        elif p == "overhead":
            w = remaining if total_bound <= 0 else 0.0
        else:
            w = 0.0
        b = bounds.get(p, 0.0)
        out[p] = {"wall_ms": w, "bound_ms": b,
                  "achieved_fraction": (b / w) if w > 0 else None,
                  "bytes": int(c.get("bytes", 0)),
                  "gathers": int(c.get("gathers", 0)),
                  "flops": int(c.get("flops", 0)),
                  "measured": p in measured}
    return out


#: ``pipeline="auto"`` arms only when the priced overlappable time (the
#: exchange/compute overlap plus the whole hideable plan stream) is at
#: least this share of the apply's total bound — below it the pipeline's
#: bookkeeping cannot pay for itself.  The JAX package's threshold, kept
#: so both packages resolve ``auto`` alike under the same rates.
AUTO_PIPELINE_MIN_FRACTION = 0.10

#: Depth ``auto`` picks when the plan stream (``plan_h2d``) carries a
#: meaningful share of the hideable time: staging latency hides best with
#: several uploads in flight.  A pure compute/exchange overlap needs only
#: the classic double buffer (depth 2).
AUTO_PIPELINE_DEEP = 4


def choose_pipeline_depth(counts: Dict[str, dict], cal: dict,
                          nchunks: int, n_devices: int) -> int:
    """The ``pipeline="auto"`` policy — price the overlap before building
    it (the same cost model the pipelined-apply estimate uses) and
    return a depth:

    * 0 (off) when there is nothing to pipeline — a single-chunk apply,
      or a priced overlappable time (``min(compute, exchange)·(1−1/n)``
      plus the hideable ``plan_h2d`` stream) below
      :data:`AUTO_PIPELINE_MIN_FRACTION` of the total bound;
    * :data:`AUTO_PIPELINE_DEEP` when the plan stream dominates the
      hideable time (staging latency wants several uploads in flight);
    * 2 (the classic double buffer) otherwise.

    The depth is clamped to ``nchunks`` by the caller-facing contract
    (more slots than chunks buy nothing)."""
    if nchunks < 2:
        return 0
    bounds = phase_bounds_ms(counts, cal)
    total = sum(bounds.values())
    if total <= 0:
        return 0
    # hybrid mode splits compute into decode/recompute phases — the
    # overlappable compute is their sum
    comp = (bounds.get("compute", 0.0)
            + bounds.get("compute_decode", 0.0)
            + bounds.get("compute_recompute", 0.0))
    exch = bounds.get("exchange", 0.0) if n_devices > 1 else 0.0
    h2d = bounds.get("plan_h2d", 0.0)
    hideable = min(comp, exch) * (1.0 - 1.0 / nchunks) + h2d
    if hideable / total < AUTO_PIPELINE_MIN_FRACTION:
        return 0
    depth = AUTO_PIPELINE_DEEP if h2d >= 0.5 * hideable else 2
    return min(depth, nchunks)


def price_term_split(live_per_term, rows: int, group_order: int,
                     cal: dict, bytes_per_live_entry: float,
                     cplx: bool = False) -> dict:
    """Per-term recompute-vs-stream pricing — the hybrid mode's cost
    model, shared by the engine's ``auto`` split, the capacity
    model's hybrid row (``serve/capacity.py``), and the tests, so all
    three answer the same question from the same rates.

    Per term ``t`` (all times in ms, per apply, across all ``rows``
    padded basis rows):

    * **stream**: the term's plan slice travels H2D and decodes —
      ``live[t] · (bytes_per_live_entry / h2d + 1/gather + fmul/flops)``
      (each live entry is streamed bytes, one ``x[row]`` gather, and the
      multiply);
    * **recompute**: the term's structure is re-derived on device —
      ``rows · ((G·ORBIT_OPS + fmul) / flops)`` (the orbit scan runs on
      every row whether or not the term fires there; the send side is a
      row-major broadcast, no gather).

    ``live_per_term`` is the global live-entry census ([T] ints, summed
    over chunks/shards/ranks); ``rows`` the matching global padded row
    total (each term is scanned once per row).  Returns ``{stream_ms,
    recompute_ms, stream_mask}`` — ``stream_mask[t]`` True when
    streaming term ``t`` prices cheaper or equal."""
    live = np.asarray(live_per_term, np.float64).reshape(-1)
    g = float(cal["gather_rows_per_s"])
    h = float(cal["h2d_bytes_per_s"])
    fl = float(cal["flops_per_s"])
    fmul = 8.0 if cplx else 2.0
    per_entry_s = bytes_per_live_entry / h + 1.0 / g + fmul / fl
    stream_ms = live * per_entry_s * 1e3
    recompute_ms = np.full(
        live.shape,
        float(rows) * (max(int(group_order), 1) * ORBIT_OPS + fmul)
        / fl * 1e3)
    return {"stream_ms": stream_ms, "recompute_ms": recompute_ms,
            "stream_mask": stream_ms <= recompute_ms}


def choose_hybrid_split(live_per_term, rows: int, group_order: int,
                        cal: dict, bytes_per_live_entry: float,
                        cplx: bool = False) -> np.ndarray:
    """The ``hybrid="auto"`` policy: stream exactly the terms whose plan
    slice prices cheaper than re-deriving their structure on device
    (:func:`price_term_split`).  Deterministic in (census, rates), so
    every rank of a multi-controller job — and a later warm restore under
    the same fingerprint — resolves the identical mask."""
    return np.asarray(
        price_term_split(live_per_term, rows, group_order, cal,
                         bytes_per_live_entry, cplx)["stream_mask"], bool)


def _mean(vals: List[float]) -> float:
    return sum(vals) / len(vals) if vals else 0.0




def roofline_report(events: List[dict],
                    calibration: Optional[dict] = None) -> dict:
    """The full roofline report for one run: per (engine, mode) group the
    mean steady apply (the first apply per group is dropped as the
    compile/warm-up one whenever ≥2 were recorded), phase attribution,
    binding resource, and the pipelined-apply speedup estimate."""
    cal = calibration or resolve_calibration()
    groups: Dict[tuple, List[dict]] = {}
    for ev in events:
        if ev.get("kind") == "apply_phases" and ev.get("phases"):
            # pipelined applies form their OWN group per depth: a run that
            # records sequential AND pipelined applies of one (engine,
            # mode) reports them side by side — that comparison IS the
            # measured-vs-priced overlap story below
            depth = int((ev.get("pipeline") or {}).get("depth") or 0)
            groups.setdefault(
                (str(ev.get("engine")), str(ev.get("mode")), depth),
                []).append(ev)
    out = {"calibration": {k: cal.get(k) for k in
                           RATE_FIELDS + ("backend", "device_kind",
                                          "source")},
           "groups": {}}
    for (engine, mode, depth), evs in sorted(groups.items()):
        steady = evs[1:] if len(evs) > 1 else evs
        wall = _mean([float(e.get("wall_ms") or 0.0) for e in steady])
        nchunks = max(int(steady[-1].get("chunks") or 1), 1)
        # mean structural counts + mean measured phase walls over the
        # steady applies (counts are constant per (mode, columns); the
        # mean keeps mixed-column runs honest)
        phase_names = sorted({p for e in steady for p in e["phases"]})
        agg: Dict[str, dict] = {}
        for p in phase_names:
            recs = [e["phases"].get(p) or {} for e in steady]
            walls = [float(r["wall_ms"]) for r in recs
                     if r.get("wall_ms") is not None]
            agg[p] = {"bytes": int(_mean([r.get("bytes", 0) for r in recs])),
                      "gathers": int(_mean([r.get("gathers", 0)
                                            for r in recs])),
                      "flops": int(_mean([r.get("flops", 0) for r in recs])),
                      "wall_ms": _mean(walls) if walls else None}
        attributed = attribute_phases(agg, wall, cal)
        bound_total = sum(a["bound_ms"] for a in attributed.values())
        binding = max(attributed,
                      key=lambda p: attributed[p]["bound_ms"]) \
            if bound_total > 0 else "overhead"
        comp = sum(attributed.get(p, {}).get("wall_ms", 0.0)
                   for p in ("compute", "compute_decode",
                             "compute_recompute"))
        exch = attributed.get("exchange", {}).get("wall_ms", 0.0)
        overlap = min(comp, exch) * (1.0 - 1.0 / nchunks) \
            if nchunks > 1 else 0.0
        pipelined = max(wall - overlap, 1e-9)
        stalls = [c.get("stall_ms") for e in steady
                  for c in (e.get("chunk_timeline") or [])
                  if c.get("stall_ms") is not None]
        grp = {
            "applies": len(evs),
            "steady_applies": len(steady),
            "wall_ms": round(wall, 4),
            "chunks": nchunks,
            "phases": {p: {k: (round(v, 4) if isinstance(v, float) else v)
                           for k, v in a.items()}
                       for p, a in attributed.items()},
            "binding_phase": binding,
            "binding_resource": PHASE_RESOURCE.get(binding, binding),
            "roofline_fraction": round(bound_total / wall, 4)
            if wall > 0 else None,
            "pipelined_speedup_estimate": round(wall / pipelined, 3),
            "pipelined_overlap_ms": round(overlap, 4),
        }
        if stalls:
            grp["mean_chunk_stall_ms"] = round(_mean(stalls), 4)
        if depth:
            pipes = [e.get("pipeline") or {} for e in steady]
            grp["pipeline_depth"] = depth
            # only MEASURED values aggregate: a fused pipeline records
            # depth alone (no host-driven chunk loop), and an absent
            # measurement must not render as a perfect 0-ms barrier
            for k in ("barrier_ms", "hidden_ms", "overlap_fraction"):
                vals = [float(p[k]) for p in pipes
                        if p.get(k) is not None]
                if vals:
                    grp[k] = round(_mean(vals), 4)
        key = f"{engine}/{mode}" + (f"+pipe{depth}" if depth else "")
        out["groups"][key] = grp
    # measured-vs-priced: when a run holds BOTH the sequential and a
    # pipelined group of one (engine, mode), put the overlap estimate (priced
    # off the sequential phases) next to the measured pipelined wall, and
    # flag a pipeline whose measured overlap fell below half its estimate
    # (only when the estimate is worth chasing — a CPU-rig run whose
    # priced overlap is ~0 must not cry wolf)
    for key, grp in out["groups"].items():
        if "+pipe" not in key:
            continue
        base = out["groups"].get(key.split("+pipe", 1)[0])
        if not base or not base.get("wall_ms"):
            continue
        wall_b, wall_p = float(base["wall_ms"]), float(grp["wall_ms"])
        priced_overlap = float(base["pipelined_overlap_ms"])
        measured_overlap = max(wall_b - wall_p, 0.0)
        grp["measured_speedup"] = round(wall_b / max(wall_p, 1e-9), 3)
        grp["priced_speedup"] = base["pipelined_speedup_estimate"]
        grp["measured_overlap_ms"] = round(measured_overlap, 4)
        grp["priced_overlap_ms"] = round(priced_overlap, 4)
        grp["overlap_below_estimate"] = bool(
            priced_overlap >= 0.02 * wall_b
            and measured_overlap < 0.5 * priced_overlap)
    # autotuner rows: the chosen configs and any
    # drift-triggered re-tunes this run recorded, plus a per-group
    # priced-vs-tuned-vs-measured triple — "priced" is the calibrated
    # bound of the structural counts (roofline_fraction's numerator),
    # "tuned" the search's pre-build estimate for the adopted config,
    # "measured" the steady apply wall
    tune_cfgs = [e for e in events if e.get("kind") == "tune_config"]
    retunes = [e for e in events if e.get("kind") == "retune"]
    if tune_cfgs or retunes:
        out["tuning"] = {
            "configs": [{k: e.get(k) for k in
                         ("engine", "mode", "token", "priced_ms",
                          "source", "search_s")} for e in tune_cfgs],
            "retunes": [{k: e.get(k) for k in
                         ("engine", "mode", "apply", "old_token",
                          "new_token", "ratio", "priced_ms",
                          "rebuild_s")} for e in retunes],
        }
        for key, grp in out["groups"].items():
            eng_mode = key.split("+pipe", 1)[0]
            match = [e for e in tune_cfgs
                     if f"{e.get('engine')}/{e.get('mode')}" == eng_mode]
            if match:
                grp["tuned_token"] = str(match[-1].get("token"))
                grp["tuned_priced_ms"] = float(
                    match[-1].get("priced_ms") or 0.0)
    return out


def reconcile_error(report: dict) -> float:
    """Max relative |Σ phase walls − measured wall| / wall over the
    report's groups — the reconciliation the roofline-check gate asserts
    stays within tolerance (≈0 by construction; a drift means the
    attribution broke)."""
    worst = 0.0
    for grp in report.get("groups", {}).values():
        wall = float(grp.get("wall_ms") or 0.0)
        if wall <= 0:
            continue
        s = sum(float(a.get("wall_ms") or 0.0)
                for a in grp.get("phases", {}).values())
        worst = max(worst, abs(s - wall) / wall)
    return worst


def print_roofline(report: dict) -> None:
    cal = report.get("calibration", {})
    print(f"calibration: {cal.get('source')} "
          f"(backend={cal.get('backend')}"
          + (f", {cal.get('device_kind')}" if cal.get("device_kind")
             else "") + ")")
    print("  " + "  ".join(f"{k}={cal.get(k):.3g}" for k in RATE_FIELDS
                           if cal.get(k)))
    for name, grp in sorted(report.get("groups", {}).items()):
        print(f"\n{name}: {grp['steady_applies']} steady applies, "
              f"wall {grp['wall_ms']:.3f} ms/apply, "
              f"{grp['chunks']} chunk(s)")
        print(f"  {'phase':<12} {'wall ms':>10} {'bound ms':>10} "
              + f"{'achieved':>9} {'bytes':>14} {'gathers':>12}")
        for p in PHASES:
            a = grp["phases"].get(p)
            if a is None:
                continue
            ach = a.get("achieved_fraction")
            if ach is None:
                cell = "-"
            elif a.get("measured") and ach > 1.0:
                # a measured wall BELOW the un-overlapped bound: the phase
                # is hidden behind other work (the double-buffered plan
                # stream doing its job) — a fraction > 1 would misread
                cell = "hidden"
            else:
                cell = f"{ach:.1%}"
            print(f"  {p:<12} {a['wall_ms']:>10.4f} {a['bound_ms']:>10.4f} "
                  + f"{cell:>9} "
                  f"{a['bytes']:>14,} {a['gathers']:>12,}"
                  + ("  (measured)" if a.get("measured") else ""))
        frac = grp.get("roofline_fraction")
        print(f"  binding resource: {grp['binding_resource']} "
              f"(phase {grp['binding_phase']}"
              + (f", run at {frac:.1%} of the combined roofline)"
                 if frac is not None else ")"))
        if grp.get("tuned_priced_ms") is not None:
            bound = sum(a["bound_ms"] for a in grp["phases"].values())
            print(f"  priced vs tuned vs measured: bound {bound:.4f} ms | "
                  f"tuned {grp['tuned_priced_ms']:.4f} ms "
                  f"[{grp['tuned_token']}] | measured "
                  f"{grp['wall_ms']:.4f} ms")
        if grp.get("mean_chunk_stall_ms") is not None:
            print(f"  mean plan-stream chunk stall: "
                  f"{grp['mean_chunk_stall_ms']:.4f} ms")
        if grp.get("pipeline_depth"):
            frac = grp.get("overlap_fraction")
            if grp.get("barrier_ms") is not None:
                print(f"  pipeline depth {grp['pipeline_depth']}: "
                      f"time-at-barrier {grp['barrier_ms']:.4f} ms/apply, "
                      f"{grp.get('hidden_ms', 0.0):.4f} ms staged behind "
                      "compute"
                      + (f" ({frac:.0%} of the staging latency hidden)"
                         if frac is not None else ""))
            else:
                print(f"  pipeline depth {grp['pipeline_depth']} "
                      "(in-program schedule — no host-measured barrier "
                      "split)")
            if grp.get("measured_speedup") is not None:
                print(f"  measured vs priced: {grp['measured_speedup']:.2f}x"
                      f" measured ({grp['measured_overlap_ms']:.3f} ms "
                      f"overlapped) vs {grp['priced_speedup']:.2f}x priced "
                      f"({grp['priced_overlap_ms']:.3f} ms)")
                if grp.get("overlap_below_estimate"):
                    print("  WARNING: measured overlap fell below 50% of "
                          "the roofline estimate — the pipeline is not "
                          "hiding what the model priced (check depth, "
                          "chunk count, and the calibration)")
        else:
            print(f"  pipelined-apply estimate: overlap exchange with chunk "
                  f"compute saves {grp['pipelined_overlap_ms']:.3f} ms "
                  f"-> {grp['pipelined_speedup_estimate']:.2f}x")
    tuning = report.get("tuning")
    if tuning:
        print("\ntuning:")
        for c in tuning.get("configs", []):
            print(f"  {c['engine']}/{c['mode']}: {c['token']} "
                  f"priced {float(c['priced_ms'] or 0.0):.4f} ms "
                  f"[{c['source']}]"
                  + (f" (search {float(c['search_s']):.2f} s)"
                     if c.get("search_s") else ""))
        for r in tuning.get("retunes", []):
            print(f"  retune {r['engine']}/{r['mode']} @ apply "
                  f"{r['apply']}: {r['old_token']} -> {r['new_token']} "
                  f"(measured/priced {float(r['ratio']):.2f}x, rebuilt in "
                  f"{float(r['rebuild_s']):.2f} s)")
