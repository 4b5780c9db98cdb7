# Ported from distributed_matvec_tpu/obs/memory.py.
"""Device-memory observability: ledger, watermarks, kernel analysis, OOM
forensics.

A pillar of the telemetry subsystem (see ``obs/__init__``).  The engine
design pivots on device-memory headroom — mode selection (ell vs fused vs
streamed), batch widths, and "will this basis fit?" all come down to
bytes.  Four producers report through here:

* **Ledger** (:func:`track` / :func:`ledger_tree` / :func:`emit_ledger`):
  a process-wide registry of named allocations.  Engines, the streamed
  plan, the pinned H2D ring and the solvers register what they hold (ELL
  tables, the host plan, ring slots, Krylov workspace) under
  ``/``-separated attribution paths — the JAX package's paths; the tree
  rolls totals up per component and is emitted as ``memory_ledger``
  events.  Entries are *live*: :meth:`Handle.release` (or the owner being
  garbage-collected, via ``weakref.finalize``) removes them.
* **Watermark sampler** (:func:`sample_watermark` / :func:`watermark_due`):
  reads ``torch.cuda.memory_stats(device)`` (``allocated_bytes.all.
  current``/``.peak``, ``reserved_bytes.all.current``) and the CUDA
  runtime's view ``torch.cuda.mem_get_info`` around engine init, plan
  uploads and every ``memory_every``-th apply, publishing ``hbm_bytes_in_use`` /
  ``hbm_peak_bytes`` gauges and ``memory_watermark`` events.  Without a
  card the first sample soft-fails and the sampler stays silent — the
  ledger remains the advisory source there.
* **Kernel analysis** (:func:`record_executable_analysis`): the port's
  one compiled device program is the decode kernel, and its
  ``cudaFuncGetAttributes`` (registers, static shared memory, local bytes,
  max threads per block) are recorded once per process as a
  ``memory_analysis`` event and a JSON sidecar under the artifact root —
  the counterpart of the JAX package's ``compiled.memory_analysis()``.
* **OOM forensics** (:func:`attach_oom` / :class:`OomError`): a
  ``torch.cuda.OutOfMemoryError`` raised in an engine build or apply
  becomes the typed :class:`OomError` carrying a :class:`MemoryReport`
  (ledger tree + a watermark taken after the failed frames released their
  tensors + ``cudaMemGetInfo``'s free bytes + kernel analyses +
  remediation),
  emitted as a critical ``memory_report`` event.

Disabled-path contract: with ``DMT_OBS=off`` every producer is a no-op —
:func:`track` returns the shared :data:`NULL_HANDLE`,
:func:`watermark_due` is False, analyses record nothing, and
:func:`attach_oom` returns ``None`` so the original error propagates
untouched.  The hot-path hooks live on the error path or behind a cadence
check.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..utils.config import get_config
from ..utils.logging import log_debug, log_warn
from .events import emit, obs_enabled
from .metrics import counter, gauge

__all__ = [
    "Handle",
    "NULL_HANDLE",
    "track",
    "track_tree",
    "ledger_entries",
    "ledger_tree",
    "ledger_total",
    "host_rss_bytes",
    "emit_ledger",
    "next_instance",
    "sample_watermark",
    "watermark_due",
    "last_watermark",
    "record_executable_analysis",
    "executable_analyses",
    "MemoryReport",
    "tensor_bytes",
    "OomError",
    "is_resource_exhausted",
    "build_memory_report",
    "remediation",
    "attach_oom",
    "reset_memory",
]


# ---------------------------------------------------------------------------
# ledger

_lock = threading.Lock()
_ledger: Dict[str, dict] = {}           # path -> entry dict (insertion order)
_instances: Dict[str, int] = {}         # per-kind engine/solver counters

#: Finalizer-safe deferred releases.  Handle.release is the target of the
#: engines' ``weakref.finalize``, which the garbage collector may run in
#: the MIDDLE of a ledger operation on the same thread (any allocation
#: inside a ``with _lock:`` block can trigger a collection) — taking the
#: non-reentrant ``_lock`` there deadlocks the process (observed: an
#: engine finalizer firing inside ``ledger_entries``'s snapshot
#: comprehension froze the whole test suite).  So release never locks: it
#: queues its paths on this list (``list.append`` is atomic under the
#: GIL, and the GC never starts a nested collection from a finalizer),
#: and every locked ledger operation drains the queue first.
_released: List[List[str]] = []


def _drain_released_locked() -> None:
    """Apply queued finalizer releases; the caller holds ``_lock``."""
    while _released:
        for p in _released.pop():
            _ledger.pop(p, None)


@dataclass
class Handle:
    """A live ledger registration; :meth:`release` removes every path this
    handle owns (idempotent).  :meth:`set` re-points one path's byte count
    — growing workspaces (block-Lanczos bases) update in place instead of
    re-registering."""

    paths: List[str] = field(default_factory=list)

    def set(self, path: str, nbytes: int) -> None:
        with _lock:
            _drain_released_locked()
            ent = _ledger.get(path)
            if ent is not None:
                ent["bytes"] = int(nbytes)

    def release(self) -> None:
        # GC-safe by construction: NO lock here (see ``_released``)
        paths, self.paths = self.paths, []
        if paths:
            _released.append(paths)


class _NullHandle(Handle):
    """Shared no-op handle returned when the layer is disabled."""

    __slots__ = ()

    def __init__(self):
        super().__init__(paths=[])

    def set(self, path, nbytes):
        pass

    def release(self):
        pass


NULL_HANDLE = _NullHandle()


def next_instance(kind: str) -> str:
    """A readable unique attribution id for one engine/solver instance
    (``local:0``, ``distributed:1``, ...) — ledger paths must not collide
    when a process holds several engines of the same kind."""
    with _lock:
        i = _instances.get(kind, 0)
        _instances[kind] = i + 1
    return f"{kind}:{i}"


def track(path: str, nbytes: int, device: str = "",
          handle: Optional[Handle] = None, **meta) -> Handle:
    """Register one named allocation under a ``/``-separated attribution
    path (``engine/local:0/structure/idx``).  Re-tracking an existing path
    replaces it (a rebuilt table supersedes the old entry).  Returns the
    handle owning the registration (pass ``handle=`` to accumulate several
    paths under one owner)."""
    if not obs_enabled():
        return NULL_HANDLE
    h = handle if handle is not None else Handle()
    ent = {"bytes": int(nbytes), "device": str(device)}
    for k, v in meta.items():
        ent[k] = v
    with _lock:
        _drain_released_locked()
        _ledger[path] = ent
        if path not in h.paths:
            h.paths.append(path)
    return h


def tensor_bytes(tree) -> int:
    """Summed bytes of every tensor in a nest of tuples, lists, dicts,
    named tuples and dataclasses (the engines' table bundles); arrays with
    ``nbytes`` count too."""
    import dataclasses

    import torch

    if isinstance(tree, torch.Tensor):
        return int(tree.numel()) * int(tree.element_size())
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tensor_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(tensor_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return int(getattr(tree, "nbytes", 0) or 0)


def track_tree(path: str, tree, device: str = "",
               handle: Optional[Handle] = None, **meta) -> Handle:
    """Register the summed bytes of a nest of tensors under one path
    (the engines' table bundles are such nests)."""
    if not obs_enabled():
        return NULL_HANDLE
    return track(path, tensor_bytes(tree), device=device, handle=handle,
                 **meta)


def ledger_entries() -> Dict[str, dict]:
    """Snapshot of the live ledger: {path: {bytes, device, ...meta}}."""
    with _lock:
        _drain_released_locked()
        return {p: dict(e) for p, e in _ledger.items()}


def ledger_tree() -> dict:
    """The live ledger as a nested attribution tree: each node carries the
    rolled-up ``bytes`` of its subtree plus ``children``; leaf nodes keep
    their entry metadata."""
    root = {"bytes": 0, "children": {}}
    for path, ent in ledger_entries().items():
        node = root
        node["bytes"] += ent["bytes"]
        for part in path.split("/"):
            node = node["children"].setdefault(
                part, {"bytes": 0, "children": {}})
            node["bytes"] += ent["bytes"]
        for k, v in ent.items():
            if k != "bytes":
                node[k] = v
    return root


def ledger_total(prefix: Optional[str] = None,
                 device: Optional[str] = None) -> int:
    """Total live bytes, optionally restricted to paths under ``prefix``
    and/or to one ``device`` class (``"host"`` for host-RAM entries like
    the streamed engine's plan; ``"device"`` for HBM-resident arrays)."""
    total = 0
    for path, ent in ledger_entries().items():
        if prefix is not None and path != prefix \
                and not path.startswith(prefix + "/"):
            continue
        if device is not None and ent.get("device") != device:
            continue
        total += ent["bytes"]
    return total


def host_rss_bytes() -> int:
    """This process's current resident-set size in bytes (0 when the
    platform exposes none) — the host-RAM watermark companion to the
    device ``memory_stats()`` sampler, read by the streamed engine's plan
    accounting and the OOM forensics report.  Proc-based (no psutil
    dependency); soft-fails to 0 anywhere /proc is absent."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def emit_ledger(context: str, **fields) -> Optional[dict]:
    """One ``memory_ledger`` event: the current attribution tree + total
    plus caller context (engines pass mode / sizes / T0 so the capacity
    planner can work from the snapshot alone)."""
    if not obs_enabled():
        return None
    return emit("memory_ledger", context=str(context),
                total_bytes=int(ledger_total()),
                entries=ledger_entries(), **fields)


# ---------------------------------------------------------------------------
# watermark sampler

_wm_lock = threading.Lock()
_wm_unsupported = False       # first None/failing memory_stats() latches
_last_watermark: Optional[dict] = None


def _device_stats() -> Optional[List[dict]]:
    """The current card's allocator and ``cudaMemGetInfo`` figures as one
    row, or None without a card (latched after the first miss so the
    per-apply cadence never re-pays a failing query)."""
    global _wm_unsupported
    if _wm_unsupported:
        return None
    try:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device")
        dev = torch.cuda.current_device()
        st = torch.cuda.memory_stats(dev)
        free, total = torch.cuda.mem_get_info(dev)
        rows = [{
            "device": f"cuda:{dev}",
            "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(st.get("reserved_bytes.all.current", 0)),
            "bytes_free": int(free),
            "bytes_limit": int(total),
        }]
    except Exception as e:
        with _wm_lock:
            _wm_unsupported = True
        log_debug(f"device memory stats unavailable: {e!r} "
                  "(advisory mode: the ledger only)")
        return None
    return rows


def sample_watermark(tag: str, **fields) -> Optional[dict]:
    """Read the card's memory and publish one ``memory_watermark`` event plus
    the ``hbm_bytes_in_use`` / ``hbm_peak_bytes`` gauges.  Returns the
    sample dict, or None when the layer is off or the backend has no
    stats (soft-fail: never raises)."""
    global _last_watermark
    if not obs_enabled():
        return None
    rows = _device_stats()
    if rows is None:
        return None
    in_use = sum(r["bytes_in_use"] for r in rows)
    peak = max(r["peak_bytes_in_use"] for r in rows)
    limit = sum(r["bytes_limit"] for r in rows)
    sample = {"tag": str(tag), "bytes_in_use": in_use,
              "peak_bytes": peak, "bytes_limit": limit,
              "bytes_reserved": sum(r["bytes_reserved"] for r in rows),
              "bytes_free": sum(r["bytes_free"] for r in rows),
              "devices": rows}
    gauge("hbm_bytes_in_use").set(in_use)
    gauge("hbm_peak_bytes").set(peak)
    with _wm_lock:
        _last_watermark = sample
    emit("memory_watermark", **sample, **fields)
    return sample


def watermark_due(apply_index: int) -> bool:
    """Whether eager apply ``apply_index`` should sample a watermark: the
    first and every ``memory_every``-th apply.  Always False when the
    layer is off or the backend already proved statless, so the hot path
    never branches further."""
    if not obs_enabled() or _wm_unsupported:
        return False
    every = max(int(get_config().memory_every), 1)
    return apply_index % every == 0


def last_watermark() -> Optional[dict]:
    """The most recent watermark sample (OOM forensics context), or None."""
    with _wm_lock:
        return dict(_last_watermark) if _last_watermark else None


# ---------------------------------------------------------------------------
# compiled-kernel analysis

_exec_analyses: Dict[str, dict] = {}


def record_executable_analysis(key: str, analysis: Optional[dict],
                               program: Optional[str] = None,
                               **fields) -> Optional[dict]:
    """Record the resource figures of one compiled device program
    (``key`` identifies the build; ``program`` the kernel's name): for
    the decode kernel, ``cudaFuncGetAttributes`` — ``num_regs``,
    ``shared_size_bytes``, ``local_size_bytes``, ``const_size_bytes``,
    ``max_threads_per_block``.  Stores it in the process registry, emits
    a ``memory_analysis`` event, sets the
    ``executable_local_bytes{program=...}`` gauge, and writes a JSON
    sidecar under the artifact root (all soft-fail).  Returns the
    analysis dict, or None when disabled or absent."""
    if not obs_enabled() or not analysis:
        return None
    ana = {"key": str(key), "program": str(program or key)}
    for k, v in analysis.items():
        ana[k] = int(v)
    with _lock:
        _exec_analyses[str(key)] = dict(ana)
    gauge("executable_local_bytes",
          program=ana["program"]).set(ana.get("local_size_bytes", 0))
    emit("memory_analysis", **ana, **fields)
    _save_analysis_sidecar(str(key), ana)
    return ana


def _save_analysis_sidecar(name: str, ana: dict) -> None:
    """Persist one analysis under the artifact root so the capacity
    planner and run-diff can read compile-time resource facts without
    re-running; soft-fail like every other cache write."""
    from ..utils.artifacts import artifact_path, artifacts_enabled

    if not artifacts_enabled():
        return
    try:
        import hashlib

        fp = hashlib.sha256(name.encode()).hexdigest()
        path = artifact_path("kernel-analysis", fp, ".json")
        with open(path, "w") as f:
            json.dump(ana, f, sort_keys=True)
    except OSError as e:
        log_debug(f"memory-analysis sidecar save skipped: {e!r}")


def executable_analyses() -> Dict[str, dict]:
    """Snapshot of every captured executable analysis, keyed by program."""
    with _lock:
        return {k: dict(v) for k, v in _exec_analyses.items()}


# ---------------------------------------------------------------------------
# OOM forensics

class OomError(RuntimeError):
    """A device out-of-memory failure with forensics attached: ``.report``
    carries the :class:`MemoryReport` dict (ledger tree, watermark, the
    ``cudaMemGetInfo``'s free bytes, kernel analyses, remediation)."""

    def __init__(self, message: str, report: dict):
        super().__init__(message)
        self.report = report


@dataclass
class MemoryReport:
    """Structured OOM forensics: what was resident (ledger), what the
    device said (watermark), what the compiler predicted (analyses), and
    what to try next (remediation)."""

    context: dict
    ledger: dict
    ledger_total_bytes: int
    watermark: Optional[dict]
    executables: Dict[str, dict]
    remediation: List[str]
    host_rss_bytes: int = 0

    def to_dict(self) -> dict:
        return {"context": self.context, "ledger": self.ledger,
                "ledger_total_bytes": self.ledger_total_bytes,
                "watermark": self.watermark,
                "executables": self.executables,
                "remediation": self.remediation,
                "host_rss_bytes": self.host_rss_bytes}


_OOM_MARKERS = ("resource_exhausted", "out of memory", "out-of-memory")


def is_resource_exhausted(exc: BaseException) -> bool:
    """Whether an exception is a device out-of-memory failure:
    ``torch.cuda.OutOfMemoryError``, or a message the allocator or the
    runtime words as one (``CUDA out of memory``, ``cudaErrorMemory...``
    surfaces as "out of memory")."""
    try:
        import torch

        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
    except Exception:
        pass
    msg = f"{type(exc).__name__}: {exc}".lower()
    return any(m in msg for m in _OOM_MARKERS)


def remediation(context: dict) -> List[str]:
    """Suggested ways out of the OOM the context describes, most effective
    first.  These are the levers the engines actually expose — the point
    is that the error message names them instead of leaving the operator
    to rediscover the design doc."""
    mode = str(context.get("mode", ""))
    engine = str(context.get("engine", ""))
    phase = str(context.get("phase", ""))
    out = []
    if mode in ("streamed", "hybrid"):
        out.append(
            "set tune=static (DMT_TUNE=static): the autotuner prices the "
            "row-chunk / compress / pipeline / plan-tier cross-product "
            "against the calibrated roofline and picks the cheapest "
            "feasible config — usually the right knobs without hand-tuning")
    if mode in ("ell", "compact"):
        out.append(
            "switch to mode='streamed' (DistributedEngine): the routing "
            "plan lives in host RAM and streams per apply — fused-level "
            "device memory at near-plan-bandwidth apply speed")
        out.append(
            "switch to mode='fused' (recomputes structure per apply: "
            "O(B*T) scratch instead of resident O(N*T0) tables)")
        if mode == "ell":
            out.append(
                "mode='compact' fits isotropic real sectors in 4 B/entry "
                "(~1/3 of the standard ELL tables)")
    if phase == "init":
        out.append(
            "lower ell_build_budget_gb (DMT_ELL_BUILD_BUDGET_GB) to force "
            "the two-pass low-memory build bounded by the packed table "
            "size")
    out.append(
        "lower matvec_batch_size (DMT_MATVEC_BATCH_SIZE): per-chunk "
        "scratch and fused exchange buffers scale with the row chunk")
    out.append(
        "narrow the apply batch (fewer RHS columns per matvec): gather "
        "scratch scales with vec_width")
    if engine == "distributed":
        out.append(
            "add shards (more devices / a larger mesh): per-device table "
            "and vector bytes scale ~1/D")
    else:
        out.append(
            "shard over a mesh with DistributedEngine: per-device bytes "
            "scale ~1/D")
    out.append(
        "run tools/capacity.py against this run's obs stream for "
        "per-mode bytes/row and the max basis size this device fits")
    return out


def build_memory_report(**context) -> MemoryReport:
    """Assemble the forensics snapshot for an OOM (or for inspection): a
    fresh watermark (``oom`` tag) when the card can be read, else the
    last one."""
    fresh = sample_watermark("oom")
    return MemoryReport(
        context=dict(context),
        ledger=ledger_tree(),
        ledger_total_bytes=ledger_total(),
        watermark=fresh or last_watermark(),
        executables=executable_analyses(),
        remediation=remediation(context),
        host_rss_bytes=host_rss_bytes(),
    )


def attach_oom(exc: BaseException, **context) -> Optional[OomError]:
    """OOM forensics entry point for the engines' error paths: when the
    layer is on and ``exc`` is a device out-of-memory failure, release the
    tensors the failed frames still pin (their locals: a live traceback
    keeps them allocated, and the report must read the memory as the
    caller will find it), emit the critical ``memory_report`` event and
    return a typed :class:`OomError` for the caller to ``raise ... from
    exc``.  Returns None otherwise — the caller re-raises the original, so
    with ``DMT_OBS=off`` this is a no-op and non-OOM errors are never
    rewritten."""
    if not obs_enabled() or not is_resource_exhausted(exc):
        return None
    release_frames(exc)
    report = build_memory_report(**context)
    rd = report.to_dict()
    counter("oom_events").inc()
    emit("memory_report", level="critical", error=f"{exc}"[:500], **rd)
    try:
        # the flight recorder's OOM trigger: the bundle carries this
        # report plus the open-span stack and the last ring events —
        # lazily imported (flight imports this module the same way)
        from .flight import flight_dump

        flight_dump("oom", error=f"{exc}"[:500], report=rd)
    except Exception:
        pass
    detail = " ".join(f"{k}={v}" for k, v in context.items())
    lines = "\n  - ".join(report.remediation)
    msg = (f"device memory exhausted ({detail}): {exc}\n"
           f"resident per the memory ledger: "
           f"{report.ledger_total_bytes / 1e9:.3f} GB"
           + (f"; allocated {report.watermark['bytes_in_use'] / 1e9:.3f}"
              f" GB, peak {report.watermark['peak_bytes'] / 1e9:.3f} GB, "
              f"free per cudaMemGetInfo "
              f"{report.watermark['bytes_free'] / 1e9:.3f} GB"
              if report.watermark else "")
           + f"\nremediation:\n  - {lines}")
    log_warn(f"OOM forensics: {detail} "
             f"(ledger {report.ledger_total_bytes / 1e9:.3f} GB resident)")
    return OomError(msg, rd)


def release_frames(exc: BaseException) -> None:
    """Clear the locals of the finished frames in ``exc``'s traceback
    (frames still executing are left alone) and return the allocator's
    cached blocks, so the tensors the failed build or apply held are
    freed before anything reads the card's memory."""
    import gc
    import traceback

    traceback.clear_frames(exc.__traceback__)
    gc.collect()
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.empty_cache()
    except Exception:
        pass


# ---------------------------------------------------------------------------


def reset_memory() -> None:
    """Drop ledger, analyses, watermark state and the unsupported latch
    (tests).  The per-kind instance counters are deliberately NOT reset:
    handles (and engine GC finalizers) from before the reset stay live,
    and reusing an instance id would let a stale finalizer release a
    NEW owner's identically-named paths."""
    global _wm_unsupported, _last_watermark
    with _lock:
        _drain_released_locked()
        _ledger.clear()
        _exec_analyses.clear()
    with _wm_lock:
        _wm_unsupported = False
        _last_watermark = None
