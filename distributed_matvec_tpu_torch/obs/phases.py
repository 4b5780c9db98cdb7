# Ported from distributed_matvec_tpu/obs/phases.py.
"""Per-apply phase attribution: where one matvec spends its time and bytes.

Whole-apply wall clocks (``matvec_apply`` events) say *that* an apply was
slow; this module decomposes every apply into named phases and emits one
``apply_phases`` event per apply:

==============  ============================================================
phase           meaning
==============  ============================================================
``plan_h2d``    host→device plan streaming (streamed mode's per-apply chunk
                copies; zero for resident-structure modes)
``compute``     gather + multiply: structure-table / exchange-slot gathers,
                the fused orbit scan, coefficient multiply-accumulate
``exchange``    the cross-shard amplitude ``all_to_all`` payload
``accumulate``  receive-side ``index_add_`` / tail scatter-adds
``overhead``    dispatch + validation + everything unattributed (defined as
                whole-apply wall minus the attributed phases at report time)
==============  ============================================================

Contract: nothing here adds device work.  ``bytes`` / ``gathers`` /
``flops`` are *structural* counts the engines know on the host (pure
functions of the engine geometry, computed once per (mode, columns) and
cached), equal to the JAX engines' counts for the same operator, mode, D,
row chunk and columns.  Wall times are host ``perf_counter`` readings
(on the card, after the apply's one end-of-apply synchronization) and CUDA
events on the plan-copy stream; phase *wall* attribution happens at report
time (``obs/roofline.py`` splits the measured wall across phases in
proportion to the cost model).

Exactness invariant (pinned by ``tests/test_torch_phases.py``): the
per-phase ``bytes``/``gathers``/``flops`` sum to the event's ``*_total``
fields exactly.

``DMT_PHASES=off`` (or ``config.phases``) disables the events; with the
whole obs layer off (``DMT_OBS=off``) the engines take no timing at all.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from ..utils.config import get_config
from .events import emit, obs_enabled

__all__ = [
    "PHASES",
    "PHASE_RESOURCE",
    "ORBIT_OPS",
    "phases_enabled",
    "zero_counts",
    "emit_apply_phases",
    "emit_tune_config",
    "emit_retune",
]

#: Flops charged per group element of the fused orbit scan (coset-walk
#: step: permute + phase + compare).  A documented constant of the cost
#: model, not a hardware truth — both engines' fused-mode compute counts
#: use it.
ORBIT_OPS = 16

#: Canonical phase order (reports render in this order; ``overhead`` is
#: derived at report time and carries no structural counts).  The two
#: ``compute_*`` phases are HYBRID mode's split of ``compute``:
#: ``compute_decode`` is the streamed term subset's decode + x-row gather
#: + multiply, ``compute_recompute`` the recompute subset's orbit scan +
#: routing + multiply — the roofline report prices each against its own
#: resource.  Non-hybrid modes keep the single ``compute`` phase.
PHASES = ("plan_h2d", "compute", "compute_decode", "compute_recompute",
          "exchange", "accumulate", "overhead")

#: The hardware resource each phase is bound by — what a roofline report
#: names when a phase dominates.
PHASE_RESOURCE = {
    "plan_h2d": "h2d bandwidth",
    "compute": "gather rate",
    "compute_decode": "gather rate",
    "compute_recompute": "flop rate (orbit scan)",
    "exchange": "interconnect bandwidth",
    "accumulate": "scatter rate",
    "overhead": "host dispatch",
}


def phases_enabled() -> bool:
    """Whether ``apply_phases`` events are emitted (requires obs on; the
    env var is consulted directly so harnesses can flip it per subprocess —
    same contract as :func:`~.events.obs_enabled`)."""
    if not obs_enabled():
        return False
    env = os.environ.get("DMT_PHASES")
    knob = env if env is not None else get_config().phases
    return str(knob).strip().lower() not in ("off", "0", "false", "no")


def zero_counts() -> Dict[str, Dict[str, int]]:
    """A fresh all-zero per-phase count dict (``overhead`` excluded — it
    carries no structural counts by definition; the hybrid-only
    ``compute_*`` split phases excluded too — only the hybrid engine adds
    them)."""
    return {p: {"bytes": 0, "gathers": 0, "flops": 0}
            for p in ("plan_h2d", "compute", "exchange", "accumulate")}


def emit_apply_phases(engine: str, mode: str, apply_index: int,
                      wall_ms: float, counts: Dict[str, Dict[str, int]],
                      chunks: int = 1, columns: int = 1,
                      measured_ms: Optional[Dict[str, float]] = None,
                      chunk_timeline: Optional[list] = None,
                      pipeline: Optional[dict] = None
                      ) -> Optional[dict]:
    """Record one apply's phase decomposition.

    ``counts`` maps phase → ``{bytes, gathers, flops}`` (structural, exact);
    ``measured_ms`` carries phases whose wall time was *measured* (streamed
    mode's ``plan_h2d``: the device time the compute stream waited on the
    plan copies; a pipelined apply's exposed ``exchange`` wait) rather than
    model-attributed; ``chunk_timeline`` is the streamed per-chunk record
    ``[{chunk, stall_ms, dispatch_ms, ...}, ...]``; ``pipeline`` carries
    the measured overlap split of a pipelined apply (``{depth,
    barrier_ms, hidden_ms, overlap_fraction}``): ``barrier_ms`` is the
    plan-staging wait actually EXPOSED, ``hidden_ms`` the staging work
    that ran behind chunk compute.  Totals are computed here so readers
    (and the exactness tests) never re-derive them."""
    if not phases_enabled():
        return None
    totals = {"bytes": 0, "gathers": 0, "flops": 0}
    phases = {}
    for p, c in counts.items():
        rec = {k: int(c.get(k, 0)) for k in ("bytes", "gathers", "flops")}
        if measured_ms and p in measured_ms:
            rec["wall_ms"] = round(float(measured_ms[p]), 4)
        for k in totals:
            totals[k] += rec[k]
        phases[p] = rec
    ev = {"engine": str(engine), "mode": str(mode),
          "apply": int(apply_index), "wall_ms": round(float(wall_ms), 4),
          "chunks": int(chunks), "columns": int(columns),
          "phases": phases,
          "bytes_total": totals["bytes"],
          "gathers_total": totals["gathers"],
          "flops_total": totals["flops"]}
    if chunk_timeline:
        ev["chunk_timeline"] = chunk_timeline
    if pipeline:
        ev["pipeline"] = {k: (round(float(v), 4)
                              if isinstance(v, float) else v)
                          for k, v in pipeline.items()}
    return emit("apply_phases", **ev)


def emit_tune_config(engine: str, mode: str, config: dict, token: str,
                     priced_ms: float, source: str, search_s: float,
                     fingerprint: str) -> Optional[dict]:
    """One autotune decision: the knob config an engine build adopted,
    where it came from (``search`` | ``artifact`` | ``retune``), its
    roofline price, and what the search cost.  Rides the obs switch only
    — tune events are build-time bookkeeping, not per-apply work, so the
    ``phases`` knob does not gate them."""
    if not obs_enabled():
        return None
    return emit("tune_config", engine=str(engine), mode=str(mode),
                config=dict(config), token=str(token),
                priced_ms=round(float(priced_ms), 4), source=str(source),
                search_s=round(float(search_s), 6),
                fingerprint=str(fingerprint))


def emit_retune(engine: str, mode: str, apply_index: int,
                old_token: str, new_token: str, ratio: float,
                priced_ms: float, rebuild_s: float) -> Optional[dict]:
    """One drift-triggered re-tune applied at a safe boundary: the
    measured/priced ``ratio`` that left ``tune/live.DRIFT_BAND``, the old
    and new knob tokens, and what the boundary re-key cost."""
    if not obs_enabled():
        return None
    return emit("retune", engine=str(engine), mode=str(mode),
                apply=int(apply_index), old_token=str(old_token),
                new_token=str(new_token), ratio=round(float(ratio), 4),
                priced_ms=round(float(priced_ms), 4),
                rebuild_s=round(float(rebuild_s), 4))
