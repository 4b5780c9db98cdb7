# Ported from tools/capacity.py (mode_bytes_per_row, stream_plan_bytes_per_row, hybrid_split_model, load_tuning, load_rate_calibration, plan, price_job and the constants they read).
"""Admission pricing: the device-memory capacity model and ``price_job``.

The solve service's scheduler prices every submission with
:func:`price_job` before it is queued.  The model is the JAX package's
capacity planner (``tools/capacity.py``), copied into the port so that the
port imports nothing of the JAX package or of ``tools/``; for the same
inputs it gives the same dict, float for float.

Model (bytes per padded basis row, one device):

    ell      T0 * (4 + cf)         idx i32 + coeff (f64, or 2*f64 c128)
    compact  T0 * 4 + 20           sign-tagged i32 + inv_n f64 + n_parts 3*f32
    fused    0 resident            structure recomputed per apply
    streamed 0 resident            the plan lives in host RAM
                                   (:func:`stream_plan_bytes_per_row`)
    common   ~36 + 8*v*w           diag + basis row + lookup pair, plus v
                                   live vectors of width w

With a rate calibration (:func:`load_rate_calibration`, an explicit JSON)
each mode also gets an ``est_apply_ms`` and a job an ``est_solve_s``;
without one admission prices memory only.  The rates, the model constants
and the default budgets are the JAX package's; the port has no H100
calibration of its own yet, so its admission ETAs are unpriced unless a
rates file is passed.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

from ..obs import roofline as _roofline

__all__ = ["price_job", "plan", "mode_bytes_per_row",
           "stream_plan_bytes_per_row", "hybrid_split_model",
           "load_rate_calibration", "load_tuning",
           "EST_COLUMNS_PER_EIGENPAIR", "KPM_BOUNDS_COLUMNS",
           "EVOLVE_STEPS_PER_UNIT_TIME"]

# per-row overhead shared by every mode: diag f64 + padded alpha u64 +
# norm f64 + lookup pair (2*u32) + directory amortized (~4 B)
COMMON_ROW_BYTES = 36
# utilization headroom: XLA fragmentation + per-apply scratch mean a table
# filling 100% of HBM OOMs long before that
DEFAULT_UTILIZATION = 0.85


def mode_bytes_per_row(T0: int, pair: bool) -> Dict[str, float]:
    """The analytic per-row structure cost of each mode (DEVICE bytes;
    streamed/hybrid keep no resident structure on device — their plans
    live in host RAM, see :func:`stream_plan_bytes_per_row`)."""
    cf = 16 if pair else 8
    return {"ell": T0 * (4 + cf),
            "compact": T0 * 4 + 20,
            "streamed": 0.0,
            "hybrid": 0.0,
            "fused": 0.0}


#: stream_compress settings the planner models (ops/plan_codec.py tiers).
STREAM_COMPRESS_SETTINGS = ("off", "lossless", "f32", "bf16")

#: Live-entry share of a compacted plan (the codec stores only entries
#: whose coefficient is nonzero): measured ~52% live on Heisenberg
#: chains.  A documented model constant — measured calibration wins.
LIVE_FRACTION = 0.55

#: Row-chunk size assumed when pricing the pipelined streamed tier (the
#: engine's ``matvec_batch_size`` default): the pipelined estimate's
#: ``1 − 1/nchunks`` factor needs a chunk count, and the planner has no
#: engine in hand.
PIPELINE_CHUNK_ROWS = 1 << 16

#: Modeled SPREAD of per-term live fractions for the offline hybrid
#: split: real operators' terms fire at different rates
#: (the measured 48% dead share on chain_24_symm is an AVERAGE over
#: terms), so the planner spreads the per-term liveness linearly over
#: ``LIVE_FRACTION · [1−spread, 1+spread]`` — enough heterogeneity for
#: the priced split to land mid-way when the rates put the break-even
#: inside the spread.  A documented model constant, same standing as
#: ``LIVE_FRACTION`` — an engine's measured census (the ``auto`` split
#: at build time) always wins.
HYBRID_LIVE_SPREAD = 0.5

#: Share of a compacted-tier plan row the SHARED receive layout
#: (bitpacked ridx/rok) occupies — it streams per chunk regardless of
#: which terms the split stores, so a partial-term plan's bytes floor at
#: this fraction of the full row (measured 0.39–0.40 on the lossless
#: tier: 115056/288864 B on the tfxy_12 all-recompute gate engine,
#: 2827968/7288512 B on the tfxy_16 mixed split).
HYBRID_SHARED_ROW_FRACTION = 0.4


def stream_plan_bytes_per_row(num_terms: int, pair: bool,
                              compress: str = "off") -> float:
    """HOST bytes per basis row of a streamed engine's resolved plan:
    dest index + coefficient per (row, term); the per-chunk receive
    layout (ridx + rok per exchange slot) adds a few percent and is
    folded into a flat overhead rather than modeled exactly.

    Compressed settings (``ops/plan_codec.py``): only LIVE entries are
    stored (``LIVE_FRACTION`` models the Heisenberg-class dead share —
    measured 48% dead on chain_24_symm; operators where every term fires
    on every row should read the measured calibration instead),
    destination+row indices bitpack to ~4 B/live entry, and the
    receive-layout overhead drops 10% → 8% (capacity trimmed, ridx
    packed, rok 1 bit).  Coefficients: ``lossless`` assumes u16
    dictionary codes (symm-sector coefficients repeat; a dict overflow
    falls back to raw f64 and the measured calibration then wins);
    ``f32``/``bf16`` are modeled in their raw-quantized form — the
    tiers exist for operators whose coefficients do NOT repeat enough
    to dictionary-code."""
    cf = 16 if pair else 8
    if compress in (None, "", "off"):
        return num_terms * (4 + cf) * 1.10
    ncomp = 2 if pair else 1
    coeff_b = {"lossless": 2.0, "f32": 4.0 * ncomp,
               "bf16": 2.0 * ncomp}[compress]
    return num_terms * (4.0 + coeff_b) * LIVE_FRACTION * 1.08


def hybrid_split_model(n_states: int, num_terms: int, pair: bool,
                       n_devices: int, group_order: int,
                       rates: Optional[dict],
                       eff_tier: str) -> Optional[dict]:
    """Offline model of the hybrid mode's per-term split,
    pricing through the same :func:`~..obs.roofline.price_term_split` the
    JAX engine's ``auto`` policy uses — so the planner, that engine and
    ``price_job`` agree on the economics.

    Per-term live fractions are modeled as a linear
    ``LIVE_FRACTION·[1±HYBRID_LIVE_SPREAD]`` spread (an engine's measured
    census wins at build time); ``group_order`` is |G| (1 for
    unprojected sectors, where recompute is cheapest).  None when
    no usable rate calibration is available."""
    if not (rates and all(rates.get(k) for k in
                          ("flops_per_s", "gather_rows_per_s",
                           "h2d_bytes_per_s"))):
        return None
    import numpy as np

    T = max(int(num_terms), 1)
    rows_share = n_states / max(n_devices, 1)
    spread = np.linspace(1.0 - HYBRID_LIVE_SPREAD,
                         1.0 + HYBRID_LIVE_SPREAD, T)
    live_frac = np.clip(LIVE_FRACTION * spread, 0.02, 1.0)
    live = live_frac * rows_share
    ncomp = 2 if pair else 1
    coeff_b = {"lossless": 2.0, "f32": 4.0 * ncomp,
               "bf16": 2.0 * ncomp}[eff_tier]
    res = _roofline.price_term_split(live, rows_share,
                                     max(int(group_order), 1), rates,
                                     4.0 + coeff_b, cplx=pair)
    mask = np.asarray(res["stream_mask"], bool)
    total_live = float(live.sum())
    return {"stream_mask": mask,
            "stream_terms": int(mask.sum()), "num_terms": T,
            "stream_term_fraction": float(mask.mean()),
            "stream_live_fraction":
            (float(live[mask].sum()) / total_live if total_live else 1.0),
            "stream_ms": res["stream_ms"],
            "recompute_ms": res["recompute_ms"],
            "live_frac": live_frac, "eff_tier": eff_tier,
            "group_order": max(int(group_order), 1)}


#: The rate fields an overlay must carry to replace a calibration in the
#: pricing paths (``obs/roofline.RATE_FIELDS``).
TUNE_RATE_FIELDS = ("gather_rows_per_s", "h2d_bytes_per_s",
                    "exchange_bytes_per_s", "flops_per_s")


def load_tuning(backend: Optional[str] = None,
                device_kind: Optional[str] = None) -> Optional[dict]:
    """The autotuner's persisted state, which ``price_job`` folds into
    admission pricing.  ``tune/`` is not in the port, so nothing is ever
    persisted: None, as the JAX function returns when nothing is."""
    return None


def load_rate_calibration(path: Optional[str] = None) -> Optional[dict]:
    """A measured-rates calibration JSON (the fields of
    ``obs/roofline.RATE_FIELDS``) from an explicit path; None without a
    path.  The JAX function also reads a content-addressed default
    sidecar, which waits for the artifact layer in the port.  An explicit
    path that does not load raises (never a silent drop of the
    est_apply_ms column the user asked for)."""
    cal = _roofline.load_calibration(path)
    if path and cal is None:
        raise FileNotFoundError(
            f"calibration file {path} is missing or carries no rate "
            "fields (expected gather_rows_per_s, h2d_bytes_per_s, "
            "exchange_bytes_per_s and flops_per_s)")
    return cal


def plan(n_states: int, num_terms: int, T0: int, pair: bool,
         hbm_gb: float, n_devices: int, vectors: int, vec_width: int,
         measured: Optional[dict] = None,
         utilization: float = DEFAULT_UTILIZATION,
         host_ram_gb: float = 64.0,
         rates: Optional[dict] = None,
         stream_compress: str = "off",
         group_order: int = 1) -> dict:
    """The capacity report: bytes/row, max basis per device and per mesh
    for each mode, plus (optionally) measured calibration.  The streamed
    mode is additionally bounded by HOST RAM (``host_ram_gb``, per rank —
    one rank per device assumed): its resolved plan streams from there,
    so the binding constraint is min(device rows, host plan rows) — and
    the plan is the ENCODED stream at the chosen ``stream_compress``
    setting (every setting's bytes/row rides along in
    ``host_plan_bytes_per_row_by_compress``).  With a ``rates``
    calibration (a rates JSON) each mode also gets an
    ``est_apply_ms`` gather/stream-bound apply-time estimate; the
    streamed estimate prices the *encoded* H2D bytes, so compression
    shows up directly in the est ms/apply column."""
    T0 = int(T0) if T0 else int(num_terms)
    if stream_compress not in STREAM_COMPRESS_SETTINGS:
        raise ValueError(f"unknown stream_compress {stream_compress!r}")
    per_mode = mode_bytes_per_row(T0, pair)
    plan_row_by = {s: stream_plan_bytes_per_row(int(num_terms), pair, s)
                   for s in STREAM_COMPRESS_SETTINGS}
    vec_bytes = 8 * vectors * max(vec_width, 1) * (2 if pair else 1)
    common = COMMON_ROW_BYTES + vec_bytes
    budget = hbm_gb * 1e9 * utilization
    host_budget = host_ram_gb * 1e9 * utilization
    out = {"inputs": {"n_states": int(n_states), "num_terms": int(num_terms),
                      "T0": T0, "pair": bool(pair), "hbm_gb": hbm_gb,
                      "host_ram_gb": host_ram_gb,
                      "n_devices": int(n_devices), "vectors": vectors,
                      "vec_width": vec_width, "utilization": utilization,
                      "stream_compress": stream_compress},
           "modes": {}}
    if measured:
        out["calibration"] = measured
        mmode = measured.get("mode")
        n_pad = measured.get("n_padded") or measured.get("n_states")
        if mmode in per_mode and measured.get("table_bytes") and n_pad:
            per_mode[mmode] = measured["table_bytes"] / float(n_pad)
            out["calibration"] = dict(
                measured, bytes_per_row_measured=round(per_mode[mmode], 2))
        if mmode == "streamed" and measured.get("plan_bytes") and n_pad:
            # the ledger's plan_bytes are the ENCODED bytes at the
            # recorded stream_compress setting; anchor that setting on
            # the measurement (and "off" on plan_bytes_raw when present),
            # then scale the un-measured settings by the model's ratios
            mcomp = str(measured.get("stream_compress") or "off")
            if mcomp not in plan_row_by:
                mcomp = "off"
            model = dict(plan_row_by)      # pre-anchor model ratios
            anchor_row = measured["plan_bytes"] / float(n_pad)
            raw_row = (measured["plan_bytes_raw"] / float(n_pad)
                       if measured.get("plan_bytes_raw") else None)
            for s in STREAM_COMPRESS_SETTINGS:
                if s == mcomp:
                    plan_row_by[s] = anchor_row
                elif s == "off" and raw_row is not None:
                    plan_row_by[s] = raw_row
                else:
                    plan_row_by[s] = anchor_row * model[s] / model[mcomp]
            out["calibration"] = dict(
                out["calibration"],
                plan_bytes_per_row_measured=round(anchor_row, 2),
                plan_bytes_per_row_compress=mcomp)
    plan_row = plan_row_by[stream_compress]
    # hybrid encodes at the compacted tier (compress "off" maps to
    # lossless — a term subset cannot ride the raw layout), and its
    # split is modeled through the shared roofline pricer
    hyb_tier = "lossless" if stream_compress in (None, "", "off") \
        else stream_compress
    hyb = hybrid_split_model(int(n_states), int(num_terms), bool(pair),
                             int(n_devices), int(group_order), rates,
                             hyb_tier)
    out["inputs"]["group_order"] = int(group_order)
    if rates:
        out["rates"] = {k: rates.get(k) for k in
                        ("gather_rows_per_s", "h2d_bytes_per_s",
                         "backend", "device_kind", "source")}
    rows_share = n_states / max(n_devices, 1)
    for mode, struct_bytes in per_mode.items():
        row = struct_bytes + common
        rows_dev = int(budget // row)
        entry = {
            "structure_bytes_per_row": round(struct_bytes, 2),
            "bytes_per_row": round(row, 2),
        }
        if mode == "streamed":
            entry["host_plan_bytes_per_row"] = round(plan_row, 2)
            entry["stream_compress"] = stream_compress
            entry["host_plan_bytes_per_row_by_compress"] = {
                s: round(r, 2) for s, r in plan_row_by.items()}
            rows_dev = min(rows_dev, int(host_budget // plan_row))
        elif mode == "hybrid":
            # the hybrid plan stores the streamed term subset only: host
            # bytes shrink by the recomputed terms' live share, floored
            # at the shared ridx/rok receive layout's share of the row
            # (it streams per chunk regardless of the split)
            frac = hyb["stream_live_fraction"] if hyb else 1.0
            row_h = plan_row_by[hyb_tier] * (
                HYBRID_SHARED_ROW_FRACTION
                + (1.0 - HYBRID_SHARED_ROW_FRACTION) * frac)
            entry["host_plan_bytes_per_row"] = round(row_h, 2)
            entry["stream_compress"] = hyb_tier
            if hyb:
                entry["hybrid_stream_terms"] = hyb["stream_terms"]
                entry["hybrid_stream_term_fraction"] = round(
                    hyb["stream_term_fraction"], 4)
            rows_dev = min(rows_dev, int(host_budget // max(row_h, 1.0)))
            if rates and rates.get("h2d_bytes_per_s"):
                # priced split: the streamed share at the h2d floor plus
                # the recomputed terms' orbit-scan flops.  NB the pure
                # streamed row is priced at the CONFIGURED tier while
                # hybrid always rides the compacted tier, so hybrid's
                # est undercuts both pure tiers when the recompute
                # credit (and, off-tier, the forced compaction) is
                # decisive — near the per-term break-even a mixed split
                # prices close to pure streamed, which is the honest
                # reading of break-even economics
                h2d_ms = rows_share * row_h \
                    / float(rates["h2d_bytes_per_s"]) * 1e3
                rec_ms = float(hyb["recompute_ms"][
                    ~hyb["stream_mask"]].sum()) if hyb else 0.0
                entry["est_apply_ms"] = round(h2d_ms + rec_ms, 3)
        if rates and rates.get("gather_rows_per_s"):
            # gather-roofline apply-time estimate per device shard at the
            # calibrated rates: ell/compact gather T0 entries/row; fused
            # scans T per row (the orbit-scan constant is in the flops
            # term the roofline model carries — this is the gather floor);
            # streamed is bounded by its plan stream (h2d bytes)
            g = float(rates["gather_rows_per_s"])
            if mode in ("ell", "compact", "fused"):
                per = T0 if mode in ("ell", "compact") else int(num_terms)
                entry["est_apply_ms"] = round(
                    rows_share * per / g * 1e3, 3)
            elif mode == "streamed" and rates.get("h2d_bytes_per_s"):
                h2d_ms = rows_share * plan_row \
                    / float(rates["h2d_bytes_per_s"]) * 1e3
                entry["est_apply_ms"] = round(h2d_ms, 3)
                # pipelined streamed tier: price the
                # whole apply wall (plan stream + chunk compute +
                # amplitude exchange at the calibrated rates), then take
                # back the roofline's overlap term
                # min(compute, exchange+stream)·(1 − 1/nchunks) — what a
                # pipeline_depth >= 2 apply is priced to cost, so the
                # recommendation can prefer it
                if rates.get("flops_per_s") \
                        and rates.get("exchange_bytes_per_s"):
                    live = LIVE_FRACTION \
                        if stream_compress not in (None, "", "off") else 1.0
                    ent_rows = rows_share * num_terms * live
                    compute_ms = ent_rows * 2 \
                        / float(rates["flops_per_s"]) * 1e3
                    exch_ms = (ent_rows * 8
                               / float(rates["exchange_bytes_per_s"]) * 1e3
                               if n_devices > 1 else 0.0)
                    nch = max(int(math.ceil(
                        rows_share / PIPELINE_CHUNK_ROWS)), 1)
                    wall = h2d_ms + compute_ms + exch_ms
                    overlap = (min(compute_ms, exch_ms + h2d_ms)
                               * (1.0 - 1.0 / nch)) if nch > 1 else 0.0
                    entry["est_apply_ms_pipelined"] = round(
                        max(wall - overlap, 0.0), 3)
                    entry["pipeline_nchunks_assumed"] = nch
        entry.update({
            "max_rows_per_device": rows_dev,
            "max_basis_size": rows_dev * n_devices,
            "fits_n_states": bool(n_states <= rows_dev * n_devices),
            "devices_needed_for_n_states":
                max(1, math.ceil(n_states / rows_dev)) if rows_dev else None,
        })
        out["modes"][mode] = entry
    return out


#: Solve-length model for :func:`price_job`: Lanczos columns to
#: convergence per requested eigenpair (Heisenberg-class spectra reach
#: 1e-10 residuals well inside this on the bench configs).  A documented
#: model constant, same standing as ``LIVE_FRACTION`` — the measured
#: trend record wins once the service has run the config.
EST_COLUMNS_PER_EIGENPAIR = 48

#: Dynamics solve-length models, in the same matvec-
#: COLUMN units the eigensolver model uses, so every solver kind prices
#: through the one calibrated `est ms/apply` rate:
#:  * kpm — the doubling recurrence takes ~n_moments/2 block applies of
#:    n_vectors columns each, plus the spectral-bounds Lanczos pass;
#:  * evolve — ~EVOLVE_STEPS_PER_UNIT_TIME accepted steps per unit
#:    time at the default tolerance, each step krylov_dim applies of a
#:    2-column (Re, Im) block.
#: Documented model constants with the same standing as
#: EST_COLUMNS_PER_EIGENPAIR — the measured trend record wins once the
#: service has run the config.
KPM_BOUNDS_COLUMNS = 64
EVOLVE_STEPS_PER_UNIT_TIME = 8


def price_job(spec, calibration: Optional[dict] = None,
              hbm_gb: float = 16.0, host_ram_gb: float = 64.0,
              utilization: float = DEFAULT_UTILIZATION,
              vectors: int = 3, tuning: Optional[dict] = None) -> dict:
    """Admission pricing for ONE job spec — what the solve service's
    scheduler (``serve/scheduler.py``) calls for every submission.

    ``spec`` is a mapping with ``n_states``/``num_terms``/``mode``/
    ``n_devices`` (+ optional ``pair``/``k``/``max_iters``/``t0``) — what
    ``JobSpec.pricing()`` produces.  ``calibration`` is a rates dict from
    :func:`load_rate_calibration` (or any mapping with
    ``gather_rows_per_s`` etc.); None prices memory fits only.
    ``tuning`` is a :func:`load_tuning` record: when it carries a live
    posterior for the spec's mode, THOSE learned rates price the job —
    admission tracks what the hardware actually did, not the catalog.

    Returns ``{est_apply_ms, est_solve_s, fits, est_iters, reason}``:
    ``fits`` is the memory verdict for the spec's mode on its mesh (the
    streamed mode's host-plan budget included), ``est_apply_ms`` the
    calibrated roofline apply estimate (None without rates), and
    ``est_solve_s`` that estimate times the modeled iteration count
    (``EST_COLUMNS_PER_EIGENPAIR``·k, capped by the spec's own
    ``max_iters``).  A spec whose dimension is unknown before the basis
    builds (yaml submissions) is passed through un-priced with
    ``fits=True`` — admission stays optimistic rather than rejecting
    blind."""
    n_states = spec.get("n_states")
    if not n_states:
        return {"est_apply_ms": None, "est_solve_s": None, "fits": True,
                "est_iters": None, "priced": False,
                "reason": "unpriced (dimension unknown before basis build)"}
    mode = str(spec.get("mode") or "ell")
    rate_source = (calibration or {}).get("source")
    if tuning and tuning.get("rates"):
        post = tuning["rates"].get(mode) \
            or next(iter(tuning["rates"].values()), None)
        if post and all(post.get(k) for k in TUNE_RATE_FIELDS):
            calibration = post
            rate_source = post.get("source", "posterior")
    num_terms = int(spec.get("num_terms") or 1)
    k = max(int(spec.get("k") or 1), 1)
    report = plan(int(n_states), num_terms,
                  int(spec.get("t0") or num_terms),
                  bool(spec.get("pair")), float(hbm_gb),
                  max(int(spec.get("n_devices") or 1), 1),
                  vectors, max(k, 2), utilization=utilization,
                  host_ram_gb=float(host_ram_gb), rates=calibration,
                  group_order=max(int(spec.get("group_order") or 1), 1))
    entry = report["modes"].get(mode)
    if entry is None:
        return {"est_apply_ms": None, "est_solve_s": None, "fits": False,
                "est_iters": None, "priced": False,
                "reason": f"unknown engine mode {mode!r}"}
    fits = bool(entry["fits_n_states"])
    est_apply_ms = entry.get("est_apply_ms")
    solver = str(spec.get("solver") or "eigs")
    if solver == "kpm":
        # moment recurrence: ceil(n_moments/2) block applies of
        # n_vectors columns, plus the bounds pass
        est_iters = (int(spec.get("n_moments") or 256) + 1) // 2 \
            * max(int(spec.get("n_vectors") or 4), 1) + KPM_BOUNDS_COLUMNS
    elif solver == "evolve":
        # trajectory: steps/unit-time x krylov applies x the 2-column
        # (Re, Im) block a complex state rides on a real engine
        import math as _math
        steps = max(int(_math.ceil(
            EVOLVE_STEPS_PER_UNIT_TIME * float(spec.get("t_final") or 1.0))),
            1)
        est_iters = steps * max(int(spec.get("krylov_dim") or 24), 2) * 2
    else:
        est_iters = min(EST_COLUMNS_PER_EIGENPAIR * k,
                        int(spec.get("max_iters") or 10 ** 9))
    # 6 decimals: a sub-millisecond solve must price > 0, or a long
    # queue of tiny jobs would never grow the admission backlog
    est_solve_s = (round(est_apply_ms * est_iters / 1e3, 6)
                   if est_apply_ms is not None else None)
    reason = "" if fits else (
        f"{mode} needs {entry['devices_needed_for_n_states']} device(s) "
        f"for {int(n_states):,} rows, mesh has "
        f"{report['inputs']['n_devices']}")
    return {"est_apply_ms": est_apply_ms, "est_solve_s": est_solve_s,
            "fits": fits, "est_iters": est_iters, "priced": True,
            "reason": reason, "rate_source": rate_source,
            "bytes_per_row": entry["bytes_per_row"],
            "max_rows_per_device": entry["max_rows_per_device"]}
