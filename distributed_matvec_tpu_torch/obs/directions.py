# Ported from distributed_matvec_tpu/obs/directions.py.
"""Metric direction registry — the ONE place that says which way is up.

Every gate needs the same answer to the same question: for metric X, is a
LOWER new value the regression (rates, speedups, throughputs) or a HIGHER
one (walls, bytes, error bounds)?  This module is the shared table, so
registering a new metric's direction (e.g. ``serve_solves_per_min``: higher
is better) happens exactly once.

The rule is tag-based, not an exact-name whitelist: any metric whose name
contains one of :data:`HIGHER_IS_BETTER_TAGS` is higher-is-better,
everything else numeric is cost-like (growth is the regression) — which is
the deliberate registration for error metrics like ``compress_rel_err``:
numerical error growing is the regression.  The tables (tags and
:data:`METRIC_HELP`) are the JAX package's, entry for entry, so both
packages' exporters print the same ``# HELP`` lines.
"""

from __future__ import annotations

__all__ = ["HIGHER_IS_BETTER_TAGS", "is_higher_better",
           "METRIC_HELP", "metric_meta"]

#: Substring tags marking rate-like metrics (higher is better).
#: ``solves_per_min`` covers the solve service's throughput
#: (``serve_solves_per_min``); latency percentiles
#: (``serve_p99_latency_ms``) fall through to the cost-like default.
HIGHER_IS_BETTER_TAGS = (
    "iters_per_s", "speedup", "_rate", "hit_rate",
    "compress_ratio", "overlap_fraction", "solves_per_min",
    # dynamics throughputs: Chebyshev moments and
    # accepted evolution steps per second — rates, so shrinkage is the
    # regression; the paired error metrics (kpm_dos_rel_err,
    # evolve_norm_drift, evolve_energy_drift) deliberately fall through
    # to the cost-like default (error growth is the regression)
    "moments_per_s", "steps_per_s",
)


def is_higher_better(metric: str) -> bool:
    """True when a LOWER value of ``metric`` is the regression."""
    return any(tag in metric for tag in HIGHER_IS_BETTER_TAGS)


#: Help strings for the exporter's ``# HELP`` lines, keyed by the BASE
#: instrument name (no labels).  This table rides next to the direction
#: tags deliberately: the OpenMetrics exporter (``obs/export.py``) and the
#: trend gates (``bench_trend``, ``obs_report diff``) read the SAME file,
#: so a metric's type, direction and meaning are registered exactly once
#: and the scrape plane can never drift from the gate plane.  A metric
#: absent here still exports (help falls back to the name) — the table is
#: documentation, not an allowlist.
METRIC_HELP = {
    "matvec_apply_ms": "Wall time of one eager matvec apply (ms)",
    "double_buffer_stall_ms": "Producer wait on a busy device buffer (ms)",
    "plan_stream_stall_ms": "Apply wait on plan-chunk staging (ms)",
    "bytes_h2d": "Host-to-device bytes copied",
    "bytes_d2h": "Device-to-host bytes copied",
    "exchange_bytes": "Cross-shard exchange payload bytes",
    "artifact_cache": "Artifact-cache events by kind/event label",
    "aot_executable_cache": "AOT executable cache hits/misses",
    "retrace_count": "Program retraces (shape/layout cache misses)",
    "engine_table_bytes": "Resident engine structure-table bytes",
    "ell_table_bytes": "Resident ELL structure-table bytes",
    "stream_plan_bytes": "Resolved streamed-plan bytes (RAM or disk tier)",
    "hbm_bytes_in_use": "Device memory in use at the last watermark poll",
    "hbm_peak_bytes": "Peak device memory over the process lifetime",
    "executable_temp_bytes": "Compiler-reported executable temp allocation",
    "oom_events": "OomError diagnoses attached to resource exhaustion",
    "compress_rel_err": "Measured streamed-plan decode relative error",
    "matvec_output_norm": "Norm of the last probed apply output",
    "matvec_nonfinite": "NaN/Inf elements counted by the health probes",
    "exchange_overflow": "Exchange-capacity overflow events",
    "exchange_invalid": "Invalid exchange-slot events",
    "health_events": "Numerical-health events by level",
    "fault_injected": "Injected faults fired (DMT_FAULT sites)",
    "io_retry": "Idempotent I/O reads retried",
    "engine_pool_bytes": "Serve-plane engine pool resident bytes",
    "engine_pool_max_bytes": "Serve-plane engine pool byte budget",
    "engine_pool_engines": "Warm engines resident in the serve pool",
    "job_queue_depth": "Solve-service jobs queued or running",
    "serve_batch_width": "Jobs packed into the in-flight solver batch",
    "slo_alert_count": "SLO burn-rate alerts fired (lifetime)",
    "flight_dump_count": "Flight-recorder post-mortem bundles written",
    "hlo_profile_count": "HLO cost profiles captured at compile time",
    "profile_capture_count": "Profiler trace captures by kind "
                             "(sampled/triggered/manual)",
    "profile_overhead_latch_count":
        "Sampled profiling latched off by the overhead guard",
    "hlo_flops": "Whole-program flops from the compiled apply's "
                 "HLO cost analysis",
    "hlo_bytes": "Whole-program bytes accessed from the compiled "
                 "apply's HLO cost analysis",
    "profile_overhead_pct": "Measured profiling overhead (trace "
                            "start/stop cost over un-profiled "
                            "apply wall, percent)",
}


def metric_meta(name: str) -> dict:
    """Everything the telemetry plane knows about base metric ``name``:
    ``{"help": str, "higher_is_better": bool}``.  The instrument TYPE
    (counter/gauge/histogram) is a property of the live registry, not of
    the name — the exporter takes it from the snapshot section the series
    appears in."""
    return {"help": METRIC_HELP.get(name, name.replace("_", " ")),
            "higher_is_better": is_higher_better(name)}
