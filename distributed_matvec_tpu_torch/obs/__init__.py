# Ported from distributed_matvec_tpu/obs/__init__.py (the surface of the modules the port has).
"""obs — process-wide telemetry: metrics registry, structured event log,
spans, SLOs, crash bundles and the OpenMetrics exporter.

The JAX package's telemetry core, copied where it is framework-free:

* :mod:`~.metrics` — counters / gauges / fixed-bucket histograms with
  labeled series; :func:`snapshot` turns the registry into plain data.
* :mod:`~.events` — append-only JSONL per process
  (``<run_dir>/rank_<r>/events.jsonl``, rank-tagged envelope, monotonic
  ``seq``, soft-fail writes), an in-memory ring buffer, and
  :func:`annotate` ranges in ``torch.profiler`` traces.
* :mod:`~.trace` — one ``trace_id`` per run (agreed across ranks through
  the shared run directory), the ``job_id`` namespacing knob
  (``DMT_JOB_ID``), and parent-linked spans stamped into every event's
  envelope.
* :mod:`~.slo` — declarative SLOs with multi-window burn-rate alerting.
* :mod:`~.flight` — post-mortem bundles (preemption, fatal signals).
* :mod:`~.export` — OpenMetrics text, ``/metrics`` and ``/healthz``.
* :mod:`~.directions` — which way each metric is better, and its help.
* :mod:`~.phases` — per-apply phase attribution: the engines' structural
  byte/gather/flop counts and measured walls as ``apply_phases`` events.
* :mod:`~.roofline` — the cost model over those events: calibration
  sidecars, phase bounds and attribution, the ``auto`` depth and hybrid
  split policies, the roofline report.
* :mod:`~.calibrate` — the rate calibration measured on the device
  (``python -m distributed_matvec_tpu_torch.obs.calibrate``).
* :mod:`~.health` — the engines' apply probes (nonfinite count and norm,
  queued behind the apply and read at the next one: no synchronization),
  the exchange counters and the lossy tiers' compress drift on the same
  queue, and the solvers' watchdog (``solver_health``); ``DMT_HEALTH``.
* :mod:`~.memory` — the memory ledger, watermarks from
  ``torch.cuda.memory_stats``, the decode kernel's attributes, and OOM
  forensics (``OomError``).
* :mod:`~.profile` — sampled ``torch.profiler`` windows with an overhead
  guard and triggered capture; ``DMT_PROFILE``.
* :mod:`~.kernel_costs` — the counterpart of the JAX ``hlo``: per-kernel
  device ms of a profiled apply, bucketed into the phases.

The engines emit ``engine_init`` at construction and ``matvec_apply``
and ``apply_phases`` per apply inside an ``apply`` span; the solvers open
a ``solve`` span with ``iteration`` spans, and the solve service its
events and spans.

Config: ``DMT_OBS_DIR`` (or ``obs_dir``) points the sink at a run
directory; unset ⇒ in-memory only; ``DMT_OBS=off`` disables the layer
entirely, at which point every instrument is the shared no-op
:data:`~.metrics.NULL`.
"""

from .events import (annotate, emit, event_path, events, flush, obs_enabled,
                     reset, run_dir)
from .export import (merge_openmetrics, parse_openmetrics,
                     render_openmetrics, start_exporter, stop_exporter,
                     textfile_path, write_textfile)
from .flight import (flight_dump, install_fatal_handlers, list_bundles,
                     postmortem_dir, read_bundle, reset_flight,
                     verify_bundle)
from .metrics import (DEFAULT_BUCKETS, NULL, counter, gauge, histogram,
                      reset_metrics, series_name)
from .metrics import snapshot as _metrics_snapshot
from .slo import (SloSpec, check_slos, default_slos, reset_slo)
from .slo import evaluate as evaluate_slos
from .trace import (current_span_id, deepest_span, emit_span, job_id,
                    job_scope, open_spans, reset_trace, span, span_path,
                    trace_enabled, trace_id)

__all__ = [
    "annotate",
    "emit",
    "event_path",
    "events",
    "flush",
    "obs_enabled",
    "reset",
    "run_dir",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "series_name",
    "reset_metrics",
    "NULL",
    "DEFAULT_BUCKETS",
    "current_span_id",
    "deepest_span",
    "emit_span",
    "job_id",
    "job_scope",
    "open_spans",
    "reset_trace",
    "span",
    "span_path",
    "trace_enabled",
    "trace_id",
    "merge_openmetrics",
    "parse_openmetrics",
    "render_openmetrics",
    "start_exporter",
    "stop_exporter",
    "textfile_path",
    "write_textfile",
    "flight_dump",
    "install_fatal_handlers",
    "list_bundles",
    "postmortem_dir",
    "read_bundle",
    "reset_flight",
    "verify_bundle",
    "SloSpec",
    "check_slos",
    "default_slos",
    "evaluate_slos",
    "reset_slo",
]


def snapshot() -> dict:
    """The metrics registry as plain data, after folding in every queued
    health probe (waiting for their copies to land)."""
    from .health import drain

    drain(block=True)
    return _metrics_snapshot()


def reset_all() -> None:
    """Reset events, metrics, trace, SLO and flight state (test isolation
    helper); also stops a running exporter."""
    stop_exporter()
    reset()
    reset_metrics()
    reset_trace()
    reset_slo()
    reset_flight()
    from .health import reset_health
    from .kernel_costs import reset_kernel_costs
    from .memory import reset_memory
    from .profile import reset_profile

    reset_health()
    reset_memory()
    reset_profile()
    reset_kernel_costs()
