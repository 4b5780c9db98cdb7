# Ported from distributed_matvec_tpu/obs/flight.py.
"""Flight recorder — a crash's last words, bundled before the lights go out.

A process that dies with exit 75 (preemption) or a fatal signal leaves its
diagnosis scattered: the tail of ``rank_<r>/events.jsonl``, the open-span
stack (gone with the process), the config identity (never written
anywhere).  This module collects all of it at the moment of death into ONE
content-addressed post-mortem bundle::

    <run_dir>/rank_<r>/postmortem/<reason>-<sha16>.json
    <run_dir>/rank_<r>/postmortem/LATEST        (name of the newest bundle)

Bundle contents (``version`` 1): the trigger (``reason`` / ``exit_code``
/ ``signum``), rank + trace/job identity **from the trace layer, never
from a payload**, the open-span stack root-first plus ``span_path`` /
``deepest_span``, the last ``flight_ring`` events of the in-memory ring,
the full metrics snapshot, the runtime config as plain data, and the
memory picture — here ``torch.cuda.memory_allocated`` and
``max_memory_allocated`` of the current card (the JAX package reads its
``obs/memory.py`` ledger, which is not in the port).  The filename's
``sha16`` is SHA-256 over the file's exact bytes, so a bundle is
self-verifying (:func:`verify_bundle`).

Contracts: with ``DMT_OBS=off`` nothing happens — no ring is consulted,
no directory is created, no bundle is written (:func:`flight_dump`
returns None before touching anything).  Dumps are once-per-reason per
process, reentrancy-guarded, and soft-fail: a full disk costs one warning,
never a second exception inside a crash path.  Lock waits against the
trace layer are bounded (1 s).

Triggers wired in the port: the preemption latch's first observation
(``utils/preempt.py`` — the signal handler itself stays I/O-free; the dump
runs on the solve thread when the latch is first seen), and
:func:`install_fatal_handlers` (a ``faulthandler`` traceback file
pre-armed inside the postmortem directory for SIGSEGV/SIGFPE/SIGABRT/
SIGBUS, plus a pre-written ``context.json`` carrying the identity a
signal context cannot collect).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import List, Optional

from ..utils.config import get_config
from ..utils.logging import _process_count, _process_index, log_warn
from . import metrics as _metrics
from . import trace as _trace
from .events import (_json_default, emit, flush, obs_enabled, run_dir)
from .events import events as _ring_events

__all__ = [
    "flight_dump",
    "postmortem_dir",
    "list_bundles",
    "read_bundle",
    "verify_bundle",
    "install_fatal_handlers",
    "reset_flight",
]

_lock = threading.Lock()
_dumped: set = set()          # reasons already bundled by this process
_dumping = threading.local()  # reentrancy guard (emit inside dump)


def postmortem_dir(rank: Optional[int] = None) -> Optional[str]:
    """``<run_dir>/rank_<r>/postmortem``, or None without a sink dir."""
    d = run_dir()
    if not d:
        return None
    r = _process_index() if rank is None else int(rank)
    return os.path.join(d, f"rank_{r}", "postmortem")


def _open_spans_bounded(timeout: float = 1.0) -> List[dict]:
    """Root-first open-span stack with a bounded lock wait — same
    rationale as :func:`~.trace.deepest_span`: a crash dump must not
    deadlock on a lock the dying main thread holds."""
    if not _trace._lock.acquire(timeout=timeout):
        return []
    try:
        return [dict(name=s.name, kind=s.kind, span_id=s.sid, **s.attrs)
                for s in _trace._stack]
    finally:
        _trace._lock.release()


def _memory_picture() -> dict:
    """The card's allocator picture, or {} without one (no CUDA, or no
    CUDA context yet — reading it must not create one in a crash path)."""
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return {}
        return {"device": int(torch.cuda.current_device()),
                "allocated_bytes": int(torch.cuda.memory_allocated()),
                "max_allocated_bytes": int(torch.cuda.max_memory_allocated())}
    except Exception:
        return {}


def flight_dump(reason: str, exit_code: Optional[int] = None,
                signum: Optional[int] = None, **extra) -> Optional[str]:
    """Write one post-mortem bundle for ``reason``; returns its path.

    None when the layer is off, no run directory is configured (there is
    nowhere durable to put it), this reason already dumped, or the write
    failed (soft — one warning).  ``extra`` fields (e.g. the watchdog's
    stall report) join the bundle top level unless they would collide
    with its identity keys, which always win."""
    if not obs_enabled():
        return None
    if getattr(_dumping, "active", False):
        return None
    pm_dir = postmortem_dir()
    if not pm_dir:
        return None
    with _lock:
        if reason in _dumped:
            return None
        _dumped.add(reason)
    _dumping.active = True
    try:
        cap = max(1, int(get_config().flight_ring))
        bundle = {
            "version": 1,
            "reason": str(reason),
            "exit_code": exit_code,
            "signum": signum,
            "ts": round(time.time(), 6),
            "rank": _process_index(),
            "n_ranks": _process_count(),
            "trace_id": _trace.trace_id(),
            "job_id": _trace.job_id(),
            "span_path": _trace.span_path(timeout=1.0),
            "span": _trace.deepest_span(timeout=1.0),
            "open_spans": _open_spans_bounded(),
            "config": dataclasses.asdict(get_config()),
            "metrics": _metrics.snapshot(),
            "memory": _memory_picture(),
            "events": _ring_events()[-cap:],
        }
        for k, v in extra.items():
            if k not in bundle:
                bundle[k] = v
        data = json.dumps(bundle, sort_keys=True,
                          default=_json_default).encode()
        sha = hashlib.sha256(data).hexdigest()[:16]
        path = os.path.join(pm_dir, f"{reason}-{sha}.json")
        os.makedirs(pm_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        latest = os.path.join(pm_dir, "LATEST")
        ltmp = f"{latest}.{os.getpid()}.tmp"
        with open(ltmp, "w") as f:
            f.write(os.path.basename(path) + "\n")
        os.replace(ltmp, latest)
        _metrics.counter("flight_dump_count").inc()
        emit("flight_dump", level="critical", reason=str(reason),
             exit_code=exit_code, bundle=path, sha=sha,
             span_path=bundle["span_path"])
        flush()
        return path
    except OSError as e:
        log_warn(f"flight recorder dump failed ({reason}): {e!r}")
        return None
    finally:
        _dumping.active = False


def list_bundles(directory: Optional[str] = None) -> List[str]:
    """Every bundle under a run directory (all ranks), sorted by path.
    ``directory`` defaults to the configured run dir."""
    d = directory or run_dir()
    if not d or not os.path.isdir(d):
        return []
    out: List[str] = []
    for name in sorted(os.listdir(d)):
        pm = os.path.join(d, name, "postmortem")
        if name.startswith("rank_") and os.path.isdir(pm):
            out.extend(os.path.join(pm, b) for b in sorted(os.listdir(pm))
                       if b.endswith(".json"))
    return out


def read_bundle(path: str) -> dict:
    """Load one bundle (no verification — see :func:`verify_bundle`)."""
    with open(path, "rb") as f:
        return json.loads(f.read().decode())


def verify_bundle(path: str) -> bool:
    """Whether the filename's content address matches the bytes — the
    bundle is untampered and untorn."""
    name = os.path.basename(path)
    stem = name[: -len(".json")] if name.endswith(".json") else name
    claimed = stem.rsplit("-", 1)[-1]
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return False
    return hashlib.sha256(data).hexdigest()[:16] == claimed


def install_fatal_handlers() -> Optional[str]:
    """Arm ``faulthandler`` to dump Python tracebacks for fatal signals
    (SIGSEGV/SIGFPE/SIGABRT/SIGBUS) into the postmortem directory, and
    pre-write a ``context.json`` with the identity a signal handler
    could never collect (trace/job id, rank, config).  Returns the
    traceback file path; None when the layer is off or sink-less."""
    if not obs_enabled():
        return None
    pm_dir = postmortem_dir()
    if not pm_dir:
        return None
    try:
        import faulthandler

        os.makedirs(pm_dir, exist_ok=True)
        ctx = {"ts": round(time.time(), 6), "rank": _process_index(),
               "n_ranks": _process_count(), "trace_id": _trace.trace_id(),
               "job_id": _trace.job_id(),
               "config": dataclasses.asdict(get_config())}
        ctx_path = os.path.join(pm_dir, "context.json")
        tmp = f"{ctx_path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(ctx, f, sort_keys=True)
        os.replace(tmp, ctx_path)
        tb_path = os.path.join(pm_dir, "fatal_signals.txt")
        # the file object must outlive the process — faulthandler keeps
        # only the fd; stash the handle on the module so GC cannot close it
        global _fatal_file
        _fatal_file = open(tb_path, "a")
        faulthandler.enable(file=_fatal_file, all_threads=True)
        return tb_path
    except OSError as e:
        log_warn(f"fatal-signal handlers unavailable: {e!r}")
        return None


_fatal_file = None


def reset_flight() -> None:
    """Forget which reasons dumped (tests)."""
    with _lock:
        _dumped.clear()


def _preempt_hook(signum) -> None:
    from ..utils.preempt import EXIT_PREEMPTED
    flight_dump("preempt", exit_code=EXIT_PREEMPTED, signum=signum)


# Route the preemption latch through the recorder: the first safe-point
# observation of the latch dumps a bundle (the handler itself stays
# I/O-free — see utils/preempt.py).
from ..utils.preempt import set_flight_hook as _set_flight_hook  # noqa: E402

_set_flight_hook(_preempt_hook)
