# Ported from distributed_matvec_tpu/utils/config.py (RuntimeConfig, _from_env, get/set/update_config).
"""Typed runtime configuration — the analog of the reference's ``config const``
flag system (``CommonParameters.chpl:1-7`` plus per-module knobs, e.g.
``DistributedMatrixVector.chpl:456-460``).

Chapel ``config const`` values are compile-time defaults overridable on the
command line (``--kFlag=value``).  Here they are dataclass fields overridable
via environment variables (``DMT_<NAME>=value``) or programmatically through
:func:`get_config` / :func:`set_config`.

Every field and every ``DMT_*`` name of the JAX package's config is kept, so
one environment configures both packages alike.  A field that has no effect
in the port says so in its comment (``port: no effect``): the four TPU
workarounds (``split_gather``, ``term_loop``, ``complex_pair``,
``allow_complex_on_tpu``), which never will, and ``artifact_max_gb``, whose
structure sidecars come with the persistence slice.  They are still parsed,
so a run's config identity (flight bundles, ``/healthz``) is the same in
both packages, and each warns once (``log_warn``) when it is set to a value
other than its default — a warning, not an error, because one environment
configures both packages.  The engines read their unset constructor
arguments here, where the JAX engines read them: ``matvec_mode``,
``matvec_batch_size``, ``stream_compress``, ``stream_kernel``,
``pipeline``, ``hybrid``, ``tune``, ``all_to_all_capacity_factor``,
``remote_buffer_size`` and ``ell_build_budget_gb``.

One deliberate difference: ``stream_kernel="auto"`` resolves to the CUDA
decode kernel wherever it is eligible (real sector, dictionary codes, not
the ``off`` tier, not hybrid), where the JAX package's ``auto`` resolves to
its XLA decode.  ``pallas`` means the same as ``auto``.  ``xla`` would send
chunks the kernel can take through its plain version, which the port
never does, so a streamed or hybrid engine built under it raises
``NotImplementedError``.

The XLA-flag helpers of the JAX module (``xla_flag_supported``,
``ensure_cpu_collective_timeout``) have no counterpart: the port runs no
XLA.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

__all__ = ["RuntimeConfig", "get_config", "set_config", "update_config"]


@dataclass
class RuntimeConfig:
    # -- observability (CommonParameters.chpl:2) ----------------------------
    display_timings: bool = False          # kDisplayTimings: the engines'
    #   timer trees (utils/timers.py) and the enumeration's timed scopes
    #   print to stderr
    log_debug: bool = False                # logDebug gating (FFI.chpl:78-80)
    profile_dir: str = ""                  # non-empty → utils/profiling.
    #   maybe_profile writes a torch.profiler Chrome trace there
    obs: str = "on"                        # telemetry layer (obs/): metrics
    #   registry + structured event sink.  "off" (DMT_OBS=off) disables the
    #   whole layer — every instrument becomes a shared no-op object
    obs_dir: str = ""                      # event-sink run directory
    #   (DMT_OBS_DIR): non-empty → append-only JSONL stream per process at
    #   <obs_dir>/rank_<r>/events.jsonl; empty → in-memory only
    health: str = "on"                     # numerical-health watchdog
    #   (DMT_HEALTH, obs/health.py): "on" logs and continues, "strict"
    #   raises HealthError on a critical condition, "off" disables probes
    health_every: int = 16                 # engine-apply probe cadence
    #   (DMT_HEALTH_EVERY): the first and every n-th apply queue the
    #   output probe (deferred, no synchronization)
    memory_every: int = 64                 # device-memory watermark cadence
    #   (DMT_MEMORY_EVERY, obs/memory.py): the first and every n-th apply
    trace: str = "on"                      # end-to-end solve tracing
    #   (DMT_TRACE, obs/trace.py): "on" stamps every event's envelope with
    #   trace_id/job_id/span_id and emits one `span` event per closed span;
    #   "off" disables stamping + span events while the rest of the obs
    #   layer keeps running (obs off implies off)
    job_id: str = ""                       # job-namespacing id
    #   (DMT_JOB_ID): stamped into every event envelope; empty defaults to
    #   the run's trace id.  The solve service scopes it per job
    obs_port: int = 0                      # OpenMetrics exporter base port
    #   (DMT_OBS_PORT, obs/export.py): >0 → each rank serves GET /metrics
    #   and GET /healthz on port obs_port + rank; 0 (the default) binds
    #   nothing, and DMT_OBS=off never touches a socket regardless
    flight_ring: int = 256                 # flight-recorder ring depth
    #   (DMT_FLIGHT_RING, obs/flight.py): how many of the newest in-memory
    #   events a post-mortem bundle carries
    phases: str = "on"                     # per-apply phase attribution
    #   (DMT_PHASES, obs/phases.py): with obs on, every engine apply emits
    #   one apply_phases event (structural counts + measured walls); "off"
    #   keeps matvec_apply and drops the phase events
    profile: str = "off"                   # continuous profiling plane
    #   (DMT_PROFILE, obs/profile.py): "sampled" wraps every
    #   profile_every-th apply in a torch.profiler window (kernel costs,
    #   obs/kernel_costs.py), "triggered" captures on SLO alerts only
    profile_every: int = 64                # sampled-profile cadence
    #   (DMT_PROFILE_EVERY)
    profile_overhead_pct: float = 2.0      # measured-overhead budget
    #   (DMT_PROFILE_OVERHEAD_PCT): sampling latches off past it after
    #   two windows

    # -- enumeration (CommonParameters.chpl:5-6) ----------------------------
    is_representative_batch_size: int = 10240   # kIsRepresentativeBatchSize
    enumeration_backend: str = "auto"           # auto | native (C++) | numpy

    # -- matvec engine (DistributedMatrixVector.chpl:456-460,55-57) ---------
    remote_buffer_size: int = 150_000      # kRemoteBufferSize → the chunked
    #   modes' exchange bucket cap
    all_to_all_capacity_factor: float = 1.25  # padding headroom over mean bucket size

    # -- device/layout ------------------------------------------------------
    matvec_batch_size: int = 1 << 16       # row chunk B of the engines
    ell_build_budget_gb: float = 12.0      # device-memory budget for the ELL
    #   structure build; when the one-pass build's full-width [T, N_pad]
    #   buffers would exceed it, LocalEngine switches to the two-pass
    #   low-memory build (count → pack)
    matvec_mode: str = "ell"               # "ell" (precomputed structure) |
    #   "compact" (4 B/entry, isotropic real sectors) | "streamed"
    #   (DistributedEngine: structure resolved once into a host-RAM plan,
    #   streamed host → device per apply) | "fused" (recompute structure
    #   every apply) | "hybrid" (DistributedEngine: a static per-term
    #   recompute-vs-stream split, see `hybrid` below)
    stream_plan_ram_gb: float = 8.0        # host-RAM budget for a streamed
    #   engine's plan before the disk tier: the autotuner's grid prices the
    #   disk tier past it (and a tuned disk tier raises: the plan always
    #   stays in pinned host memory; the disk tier is not ported)
    stream_compress: str = "off"           # streamed-plan codec tier
    #   (DMT_STREAM_COMPRESS, ops/plan_codec.py): "off" (raw arrays, rok
    #   still bitpacked), "lossless" (bitpacked indices + f64 dictionary
    #   coefficients; exact), "f32"/"bf16" (quantized coefficients, f64
    #   accumulation)
    pipeline: str = "off"                  # pipelined chunked applies
    #   (DMT_PIPELINE): "off" (sequential compute-then-exchange per chunk)
    #   or an integer >= 2 (that many chunks' exchanges in flight; the
    #   accumulation order is unchanged, so pipelined applies are
    #   bit-identical to sequential ones); "auto" prices the overlap of the
    #   built plan with the rate calibration (obs/roofline.py)
    hybrid: str = "auto"                   # hybrid-mode term split policy
    #   (DMT_HYBRID): "all-stream" / "all-recompute" / "stream:i,j,..."
    #   pin the split; "auto" streams the terms whose plan slice prices
    #   cheaper than recomputing them (obs/roofline.choose_hybrid_split)
    tune: str = "off"                      # self-tuning runtime (DMT_TUNE,
    #   tune/): "static" picks the streamed/hybrid knobs left unset (row
    #   chunk, depth, value-exact tier, split) by the calibrated cost model
    #   and keeps the answer as a tuning artifact; "live" also refines the
    #   rates from each window of measured applies and re-tunes at the next
    #   apply when measured/priced leaves (0.5, 2) (DMT_TUNE_WINDOW applies
    #   per window, default 8)
    stream_kernel: str = "auto"            # streamed-chunk decode path
    #   (DMT_STREAM_KERNEL): "auto" and "pallas" (port: the CUDA decode
    #   kernel on every eligible chunk — real sector, dictionary codes,
    #   not off, not hybrid — and the torch decode on the others; the JAX
    #   package's auto is its XLA decode), "xla" (port: a streamed or
    #   hybrid engine raises NotImplementedError)
    split_gather: str = "auto"             # triple-f32 gathers (port: no
    #   effect — Hopper gathers f64 natively)
    term_loop: str = "auto"                # ELL/compact per-term loop form
    #   (port: no effect — the port's term loop is eager)
    complex_pair: str = "auto"             # (re,im)-f64 pair engines (port:
    #   no effect — Hopper runs complex128 natively)
    allow_complex_on_tpu: bool = False     # c128-on-TPU guard (port: no
    #   effect)

    # -- solvers (solve/lanczos.py) -----------------------------------------
    lanczos_reorth: str = "selective"      # per-iteration reorthogonalization
    #   policy of `lanczos` when the caller passes none: "selective"
    #   (window MGS escalated to full MGS blocks when the ω-recurrence
    #   estimate crosses √ε) | "full" (full MGS sweeps every iteration)

    # -- fault tolerance (utils/faults.py / preempt.py, parallel/heartbeat.py)
    fault: str = ""                        # deterministic fault injection
    #   (DMT_FAULT, utils/faults.py): sites exchange, plan_upload,
    #   solver_block
    io_retries: int = 3                    # bounded retries of the
    #   plan_upload host fetch (utils/faults.with_retries)
    io_retry_base_s: float = 0.05          # first backoff, doubling
    heartbeat_s: float = 0.0               # cross-rank heartbeat interval
    #   (DMT_HEARTBEAT_S, parallel/heartbeat.py): the watchdog's default
    #   interval (2 s while 0); the CLI slice's app starts it when > 0
    heartbeat_timeout_s: float = 120.0     # a peer's beat older than this
    #   is a stall: stall_report, flight bundle, exit 76
    preempt: str = "auto"                  # SIGTERM/SIGINT preemption latch
    #   (DMT_PREEMPT): "auto" installs the latch handlers around solves
    #   (the solve service exits EXIT_PREEMPTED=75 so a supervisor
    #   relaunches the same argv and resumes); "off" leaves signal
    #   dispositions alone

    # -- artifact cache (utils/artifacts.py) --------------------------------
    artifact_cache: str = "on"             # content-addressed cache
    #   (DMT_ARTIFACT_CACHE, utils/artifacts.py): the calibration sidecar
    #   and the tuning artifacts and posteriors; "off" disables all three
    artifact_dir: str = ""                 # cache root (DMT_ARTIFACT_DIR
    #   wins; default ~/.cache/distributed_matvec_tpu/artifacts)
    artifact_max_gb: float = 8.0           # per-sidecar cap of the
    #   structure sidecars (port: no effect — they come with the HDF5
    #   persistence slice)

    # -- solve service (serve/) ---------------------------------------------
    serve_pool_gb: float = 2.0             # engine-pool byte budget
    #   (DMT_SERVE_POOL_GB): resident engines (device tables + host-RAM
    #   streamed plans) beyond it are evicted LRU
    serve_block_width: int = 6             # max jobs packed into one
    #   batched lanczos_block call (DMT_SERVE_BLOCK_WIDTH)
    serve_accept_horizon_s: float = 30.0   # admission verdict boundary
    #   (DMT_SERVE_ACCEPT_HORIZON_S): a job whose priced queue-wait ETA
    #   exceeds this is admitted with verdict "queue" (ETA attached)
    #   instead of "accept"; jobs that do not fit at all are rejected


_ENV_PREFIX = "DMT_"
_config: RuntimeConfig | None = None


def _from_env(cfg: RuntimeConfig) -> RuntimeConfig:
    for f in dataclasses.fields(cfg):
        env = os.environ.get(_ENV_PREFIX + f.name.upper())
        if env is None:
            continue
        if f.type in ("bool", bool):
            value = env.lower() in ("1", "true", "yes", "on")
        elif f.type in ("int", int):
            value = int(env)
        elif f.type in ("float", float):
            value = float(env)
        else:
            value = env
        setattr(cfg, f.name, value)
    return cfg


#: fields the port parses and ignores: the TPU workarounds, and the
#: structure sidecars' cap (the persistence slice)
NO_EFFECT = ("split_gather", "term_loop", "complex_pair",
             "allow_complex_on_tpu", "artifact_max_gb")
_warned: set = set()


def _warn_no_effect(cfg: RuntimeConfig) -> None:
    """Warn once per field when a field of :data:`NO_EFFECT` is set to a
    value other than its default."""
    from .logging import log_warn

    default = RuntimeConfig()
    for name in NO_EFFECT:
        value = getattr(cfg, name)
        if name in _warned or value == getattr(default, name):
            continue
        _warned.add(name)
        log_warn(f"config {name}={value!r} has no effect in the PyTorch "
                 "port (set for the JAX package)")


def get_config() -> RuntimeConfig:
    global _config
    if _config is None:
        _config = _from_env(RuntimeConfig())
        _warn_no_effect(_config)
    return _config


def set_config(cfg: RuntimeConfig) -> None:
    global _config
    _config = cfg
    _warn_no_effect(cfg)


def update_config(**kwargs) -> RuntimeConfig:
    cfg = get_config()
    for k, v in kwargs.items():
        if not hasattr(cfg, k):
            raise AttributeError(f"unknown config field {k!r}")
        setattr(cfg, k, v)
    _warn_no_effect(cfg)
    return cfg
