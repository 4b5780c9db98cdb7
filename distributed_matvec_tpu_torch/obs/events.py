# Ported from distributed_matvec_tpu/obs/events.py.
"""Structured event sink: append-only JSONL per process + profiler bridge.

One pillar of the telemetry subsystem (see ``obs/__init__``).  Every event is
a flat JSON object with a fixed envelope::

    {"seq": 17, "ts": 1754092800.123456, "proc": 0, "rank": 0, "n_ranks": 2,
     "kind": "engine_init", "trace_id": "9f2c...", "job_id": "9f2c...",
     "span_id": "3-a1b2", ...payload fields...}

``seq`` is a per-process monotonic sequence number (readers order one rank's
stream by ``seq`` — wall clocks across hosts are not trusted), ``rank`` the
process rank of the initialized ``torch.distributed`` group (0 without
one) and ``n_ranks`` its size (``proc`` is kept as a ``rank`` alias for
pre-rank readers).  The envelope is the JAX package's, field for field, so
one reader serves both packages' streams.  When the tracing layer is on
(``obs/trace.py``, default) the envelope also carries the run's
``trace_id``, the ``job_id`` namespacing knob, and the ``span_id`` of the
innermost open span — readers treat all three as optional (pre-trace
streams simply lack them).  With ``DMT_OBS_DIR`` (or
``config.obs_dir``) set, each process appends to its OWN file
``<dir>/rank_<r>/events.jsonl`` — multi-host safe by construction, no
cross-process file locking — and every event is
also kept in a bounded in-memory ring buffer (:func:`events`) so a live
process can inspect its own stream.  With no directory configured the layer
still runs in-memory only (the default), and with ``DMT_OBS=off`` it is
fully disabled (:func:`emit` returns ``None`` without building an event).

Sink writes fail SOFT: a read-only checkout or full disk logs one
``log_warn`` and degrades to in-memory — telemetry must never turn a
computation into an I/O error.

:func:`annotate` bridges the host-side event timeline into ``torch.profiler``
traces: it returns a ``record_function`` context so an instrumented phase
shows up as a named range in the profiler's trace, lining up with the JSONL
timestamps (the JAX package's ``jax.profiler.TraceAnnotation``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import List, Optional

from ..utils.config import get_config
from ..utils.logging import _process_count, _process_index, log_warn

__all__ = [
    "obs_enabled",
    "run_dir",
    "event_path",
    "emit",
    "events",
    "annotate",
    "flush",
    "reset",
    "set_trace_stamper",
]

_BUFFER_CAP = 1 << 16

_lock = threading.Lock()
_buffer: deque = deque(maxlen=_BUFFER_CAP)
_seq = 0
_sink = None                 # open file object, or None
_sink_path: Optional[str] = None
_sink_failed = False
_atexit_registered = False
_trace_stamper = None        # obs/trace.py registers its envelope stamper


def set_trace_stamper(fn) -> None:
    """Register the tracing layer's envelope stamper (``obs/trace.py``
    calls this at import).  ``fn()`` returns the ``trace_id``/``job_id``/
    ``span_id`` fields :func:`emit` merges into every event's envelope —
    a callback instead of an import so this sink stays standalone and
    cycle-free.  A failing stamper is dropped for the process: causality
    stamps must never cost the event itself."""
    global _trace_stamper
    _trace_stamper = fn


def obs_enabled() -> bool:
    """Whether the telemetry layer is active (default on).

    The env var is consulted directly (not just through the config
    snapshot) so a harness can flip it for a subprocess without racing the
    config cache."""
    env = os.environ.get("DMT_OBS")
    knob = env if env is not None else get_config().obs
    return str(knob).strip().lower() not in ("off", "0", "false", "no")


def run_dir() -> Optional[str]:
    """The event-sink run directory, or None for in-memory-only operation
    (``DMT_OBS_DIR`` env var > ``obs_dir`` config field)."""
    if not obs_enabled():
        return None
    return os.environ.get("DMT_OBS_DIR") or get_config().obs_dir or None


def event_path() -> Optional[str]:
    """This process's JSONL file path (``<dir>/rank_<r>/events.jsonl`` — one
    subdirectory per rank so multi-rank runs merge by construction), or None
    when no sink is configured."""
    d = run_dir()
    if not d:
        return None
    return os.path.join(d, f"rank_{_process_index()}", "events.jsonl")


def _json_default(o):
    """Make numpy scalars/arrays (the payloads solvers and engines carry)
    JSON-serializable; anything else degrades to its repr — an exotic field
    must not cost the event line."""
    try:
        import numpy as np

        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
    except ImportError:  # pragma: no cover - numpy is a hard dep
        pass
    return repr(o)


def _write(ev: dict) -> None:
    global _sink, _sink_path, _sink_failed, _atexit_registered
    if _sink_failed:
        return
    path = event_path()
    if path is None:
        return
    try:
        if _sink is None or _sink_path != path:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if _sink is not None:
                _sink.close()
            # line-buffered append so `obs_report tail --follow` sees events
            # as they happen, and a crash loses at most the current line
            _sink = open(path, "a", buffering=1)
            _sink_path = path
            if not _atexit_registered:
                # flush-on-exit backstop: the final events of a preempted
                # or crashing run (checkpoint-written, solver_preempted,
                # stall_report) must reach rank_<r>/events.jsonl even when
                # the harness never reaches its explicit flush()
                import atexit

                atexit.register(flush)
                _atexit_registered = True
        _sink.write(json.dumps(ev, default=_json_default) + "\n")
    except OSError as e:
        _sink_failed = True  # degrade to in-memory; warn ONCE, not per event
        log_warn(f"event sink disabled ({path}): {e!r}")


def emit(kind: str, **fields) -> Optional[dict]:
    """Record one event; returns the full event dict, or None when the
    layer is disabled.  The envelope keys (``seq``/``ts``/``proc``/
    ``rank``/``n_ranks``/``kind``) always win: a payload field colliding
    with one is DROPPED — readers key cross-rank ordering and straggler
    attribution on the envelope, so a producer must never be able to
    spoof it."""
    global _seq, _trace_stamper
    if not obs_enabled():
        return None
    stamp = None
    if _trace_stamper is not None:
        # outside _lock: the stamper takes the trace layer's own lock and
        # may touch the run directory once (trace-id agreement)
        try:
            stamp = _trace_stamper()
        except Exception as e:
            log_warn(f"trace stamper disabled: {e!r}")
            _trace_stamper = None
    with _lock:
        seq = _seq
        _seq += 1
        rank = _process_index()
        ev = {"seq": seq, "ts": round(time.time(), 6),
              "proc": rank, "rank": rank, "n_ranks": _process_count(),
              "kind": str(kind)}
        if stamp:
            # trace_id / job_id / span_id join the envelope: causal
            # identity is envelope truth, so a producer cannot spoof it
            ev.update(stamp)
        for k, v in fields.items():
            if k not in ev:
                ev[k] = v
        _buffer.append(ev)
        _write(ev)
    return ev


def events(kind: Optional[str] = None) -> List[dict]:
    """Snapshot of this process's in-memory event buffer (optionally
    filtered by ``kind``) — newest last."""
    with _lock:
        evs = list(_buffer)
    if kind is not None:
        evs = [e for e in evs if e.get("kind") == kind]
    return evs


def annotate(name: str):
    """Context manager marking a named range in the active
    ``torch.profiler`` trace (no-op when the layer is off).  Host-side
    only — a ``record_function`` never launches device work."""
    if not obs_enabled():
        return nullcontext()
    try:
        import torch

        return torch.profiler.record_function(name)
    except Exception:
        return nullcontext()


def flush() -> None:
    """Flush the JSONL sink (harness exit points; in-memory mode no-op)."""
    with _lock:
        if _sink is not None:
            try:
                _sink.flush()
            except OSError:
                pass


def reset() -> None:
    """Close the sink and clear buffer + sequence counter (tests; also the
    way to re-point an already-running process at a new ``obs_dir``)."""
    global _seq, _sink, _sink_path, _sink_failed
    with _lock:
        if _sink is not None:
            try:
                _sink.close()
            except OSError:
                pass
        _sink = None
        _sink_path = None
        _sink_failed = False
        _seq = 0
        _buffer.clear()
