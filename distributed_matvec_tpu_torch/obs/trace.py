# Ported from distributed_matvec_tpu/obs/trace.py.
"""End-to-end solve tracing: one ``trace_id`` per run, parent-linked spans.

One pillar of the telemetry subsystem (see ``obs/__init__``).  This
module gives every run a **trace id** and every span a parent-linked
**span id**, stamped into the event envelope next to ``rank``/``seq`` — so
every event becomes attributable to the exact span that produced it.  The
solve service opens one ``serve_batch`` span per batch and emits one
``job:<id>`` span per job as its child.

Identity
--------
* ``trace_id()`` — 16-hex id shared by every rank of one run.  Resolution
  order: ``DMT_TRACE_ID`` (a supervisor pinning the id explicitly) > the
  ``trace_id`` file under the obs run directory (first rank to arrive
  creates it atomically with ``O_EXCL``; every other rank reads the
  winner's value — multi-rank runs already share the directory, and the
  id is thereby a property of the *run directory*, exactly like the event
  streams themselves) > a per-process random id (in-memory-only runs).
* ``job_id()`` — the solve-service namespacing knob (``DMT_JOB_ID`` /
  ``config.job_id``); defaults to the trace id.  Stamped into every event
  so a multiplexed scheduler can filter one job's telemetry out of a
  shared stream.

Spans
-----
``span(name, kind=..., **attrs)`` is a context manager pushing onto a
process-global stack (engines and solvers run on the main thread; the
heartbeat watchdog only *reads* the stack, which is why it is global and
locked rather than thread-local).  Closing a span emits ONE ``span`` event
carrying ``name``/``cat``/``t0``/``dur_ms``/``parent_span_id`` — emitted
*before* the pop, so the envelope's ``span_id`` stamp is the span's own id.
The JAX package's taxonomy (run > solve > iteration > apply > chunk) holds
here too; in the port only the service layer opens spans so far (run >
serve_batch > job).

Contracts: spans are pure host bookkeeping — no device work, no
synchronization; ``DMT_TRACE=off`` disables stamping and span events
while leaving the rest of obs running;
``DMT_OBS=off`` is a provable no-op (``span`` returns a shared null
context, no ids are generated, nothing is emitted).
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

from ..utils.config import get_config
from ..utils.logging import log_warn
from .events import emit, obs_enabled, run_dir, set_trace_stamper

__all__ = [
    "trace_enabled",
    "trace_id",
    "job_id",
    "span",
    "current_span_id",
    "open_spans",
    "deepest_span",
    "span_path",
    "reset_trace",
]

_lock = threading.Lock()
_stack: List["_Span"] = []
_trace_id: Optional[str] = None
_id_counter = 0
#: the span ids' random suffix, drawn once per process (and per reset)
_span_salt: Optional[str] = None


def trace_enabled() -> bool:
    """Whether span tracing + envelope stamping is active (requires obs
    on; the env var is consulted directly so harnesses can flip it per
    subprocess — same contract as :func:`~.events.obs_enabled`)."""
    if not obs_enabled():
        return False
    env = os.environ.get("DMT_TRACE")
    knob = env if env is not None else get_config().trace
    return str(knob).strip().lower() not in ("off", "0", "false", "no")


def _rand_id(nbytes: int = 8) -> str:
    return os.urandom(nbytes).hex()


def _agree_trace_id(directory: str, proposal: str) -> str:
    """Cross-rank agreement through the shared run directory: the first
    rank to arrive creates ``<dir>/trace_id`` atomically (``O_EXCL``) with
    its proposal; everyone else reads the winner.  Soft-fail (an
    unwritable or vanished directory degrades to the per-rank proposal —
    telemetry must never turn a computation into an I/O error)."""
    path = os.path.join(directory, "trace_id")
    try:
        os.makedirs(directory, exist_ok=True)
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
        # the O_EXCL create is the winner marker only; the CONTENT lands
        # via an atomic replace, so a racing reader observes either an
        # empty file (retries below) or the full id — never a torn prefix
        tmp = f"{path}.{proposal}.tmp"
        with open(tmp, "w") as f:
            f.write(proposal + "\n")
        os.replace(tmp, path)
        return proposal
    except FileExistsError:
        pass
    except OSError as e:
        log_warn(f"trace_id agreement unavailable ({path}): {e!r}")
        return proposal
    # another rank won the create — read its id (retry while empty: the
    # winner's atomic replace may not have landed yet)
    for _ in range(50):
        try:
            with open(path) as f:
                got = f.read().strip()
            if got:
                return got
        except OSError:
            pass
        time.sleep(0.01)
    log_warn(f"trace_id file {path} stayed empty; using a rank-local id")
    return proposal


def trace_id() -> Optional[str]:
    """This run's trace id (lazy; None when tracing is disabled).  See the
    module docstring for the resolution order."""
    if not trace_enabled():
        return None
    return _resolved_trace_id()


def _resolved_trace_id() -> str:
    """:func:`trace_id` with tracing known to be on."""
    global _trace_id
    if _trace_id is not None:
        return _trace_id
    # resolve OUTSIDE the span lock: the file agreement touches the shared
    # run directory, and the heartbeat watchdog must be able to read the
    # span stack even while a rank wedges on that mount.  Two threads
    # racing here both reach the same agreed value (the O_EXCL winner);
    # first store wins.
    pinned = os.environ.get("DMT_TRACE_ID", "").strip()
    if pinned:
        resolved = pinned
    else:
        proposal = _rand_id()
        d = run_dir()
        resolved = _agree_trace_id(d, proposal) if d else proposal
    with _lock:
        if _trace_id is None:
            _trace_id = resolved
    return _trace_id


def job_id() -> Optional[str]:
    """The job-namespacing id (``DMT_JOB_ID`` env > ``config.job_id`` >
    the trace id) — the groundwork the solve service's multiplexed
    scheduler keys per-job telemetry on."""
    if not trace_enabled():
        return None
    return _resolved_job_id()


def _resolved_job_id() -> str:
    """:func:`job_id` with tracing known to be on."""
    env = os.environ.get("DMT_JOB_ID")
    knob = env if env is not None else get_config().job_id
    knob = str(knob).strip()
    return knob if knob else _resolved_trace_id()


class _Span:
    __slots__ = ("name", "kind", "sid", "parent_sid", "t0", "attrs")

    def __init__(self, name: str, kind: str, sid: str,
                 parent_sid: Optional[str], attrs: Dict):
        self.name = name
        self.kind = kind
        self.sid = sid
        self.parent_sid = parent_sid
        self.t0 = time.time()
        self.attrs = attrs


def _next_span_id() -> str:
    """Span ids are ``<rank-local ordinal>-<4 random hex>`` — unique
    within a trace once prefixed by the rank (the envelope carries the
    rank, and readers key spans on ``(rank, span_id)``), cheap to
    generate, and stable enough to grep.  The hex is drawn once per
    process: it tells a relaunched rank's spans from its predecessor's,
    and an ``os.urandom`` call per span cost ≈ 0.18 ms of host time per
    apply on an H100 host (``tools/torch_obs_cost.py``)."""
    global _id_counter, _span_salt
    if _span_salt is None:
        _span_salt = _rand_id(2)
    _id_counter += 1
    return f"{_id_counter:x}-{_span_salt}"


@contextmanager
def _span_cm(name: str, kind: str, attrs: Dict):
    with _lock:
        parent = _stack[-1].sid if _stack else None
        sp = _Span(str(name), str(kind), _next_span_id(), parent, attrs)
        _stack.append(sp)
    try:
        yield sp
    finally:
        dur_ms = (time.time() - sp.t0) * 1e3
        # emit BEFORE the pop: the envelope stamper sees the closing span
        # on top of the stack, so the span event's own span_id is itself
        # and its children's events (already written) point at it
        emit("span", name=sp.name, cat=sp.kind,
             parent_span_id=sp.parent_sid,
             t0=round(sp.t0, 6), dur_ms=round(dur_ms, 4), **sp.attrs)
        with _lock:
            try:
                _stack.remove(sp)
            except ValueError:      # reset_trace() ran inside the span
                pass


def span(name: str, kind: str = "span", **attrs):
    """Context manager for one traced span.  With tracing disabled this is
    a shared null context: no id, no lock, no event — the provable-no-op
    contract of ``DMT_OBS=off``."""
    if not trace_enabled():
        return nullcontext()
    return _span_cm(name, kind, attrs)


def emit_span(name: str, kind: str, t0: float, dur_ms: float,
              **attrs) -> None:
    """One retro-dated span event parented to the CURRENTLY open span —
    for work whose extent is known only after the fact and cannot ride
    the context-manager nesting (the solve service's per-job spans: a
    job's in-batch window closes when its column converges, while the
    batch span is still open).  The span is pushed for exactly the
    duration of its own event emission — same emit-before-pop move as
    the context manager, so the envelope stamper records the span's own
    id on its event — and carries the caller's ``t0``/``dur_ms`` rather
    than wall-clock-now."""
    if not trace_enabled():
        return
    with _lock:
        parent = _stack[-1].sid if _stack else None
        sp = _Span(str(name), str(kind), _next_span_id(), parent, attrs)
        _stack.append(sp)
    try:
        emit("span", name=sp.name, cat=sp.kind, parent_span_id=parent,
             t0=round(float(t0), 6), dur_ms=round(float(dur_ms), 4),
             **attrs)
    finally:
        with _lock:
            try:
                _stack.remove(sp)
            except ValueError:
                pass


@contextmanager
def _job_scope_cm(jid: str):
    from ..utils.config import get_config, update_config
    old_env = os.environ.get("DMT_JOB_ID")
    old_cfg = get_config().job_id
    # env AND config, the both-or-neither contract of --job-id: the env
    # var outranks the config field, so scoping only the config would be
    # silently defeated by an inherited DMT_JOB_ID
    os.environ["DMT_JOB_ID"] = jid
    update_config(job_id=jid)
    try:
        yield
    finally:
        if old_env is None:
            os.environ.pop("DMT_JOB_ID", None)
        else:
            os.environ["DMT_JOB_ID"] = old_env
        update_config(job_id=old_cfg)


def job_scope(jid: Optional[str]):
    """Context manager stamping ``jid`` as the envelope ``job_id`` of
    every event emitted inside — how the solve service namespaces one
    job's lifecycle events and spans inside a multiplexed stream (the
    envelope drops payload fields that collide with its keys, so a
    payload ``job_id=`` could never do this).  No-op when tracing is off
    or ``jid`` is empty."""
    if not trace_enabled() or not jid:
        return nullcontext()
    return _job_scope_cm(str(jid))


def current_span_id() -> Optional[str]:
    """The innermost open span's id, or None."""
    with _lock:
        return _stack[-1].sid if _stack else None


def open_spans() -> List[dict]:
    """Snapshot of the open-span stack, root first — each entry
    ``{name, kind, span_id, attrs...}``."""
    with _lock:
        return [dict(name=s.name, kind=s.kind, span_id=s.sid, **s.attrs)
                for s in _stack]


def deepest_span(timeout: Optional[float] = None) -> Optional[dict]:
    """The innermost open span (``{name, kind, span_id, attrs...}``), or
    None — what a stall report attaches so a watchdog exit names the
    phase/chunk the wedged rank was executing.  ``timeout`` bounds the
    lock wait (the watchdog passes one: it must be able to abort a
    wedged process even if the main thread died holding the lock)."""
    if not _lock.acquire(timeout=-1 if timeout is None else timeout):
        return None
    try:
        if not _stack:
            return None
        s = _stack[-1]
        return dict(name=s.name, kind=s.kind, span_id=s.sid, **s.attrs)
    finally:
        _lock.release()


def span_path(timeout: Optional[float] = None) -> str:
    """Human-readable ancestry of the open stack (``solve>iteration>
    apply>chunk``), empty when nothing is open (or, with ``timeout``,
    when the lock could not be taken in time)."""
    if not _lock.acquire(timeout=-1 if timeout is None else timeout):
        return ""
    try:
        return ">".join(s.name for s in _stack)
    finally:
        _lock.release()


def _stamp() -> Dict[str, object]:
    """The envelope fields :func:`~.events.emit` merges into every event:
    ``trace_id`` + ``job_id`` always (when tracing is on), ``span_id``
    when a span is open.  Registered with the event sink at import time —
    the sink stays standalone and import-cycle-free."""
    if not trace_enabled():
        return {}
    # tracing is on for the whole stamp: one check, not one per field
    out: Dict[str, object] = {"trace_id": _resolved_trace_id(),
                              "job_id": _resolved_job_id()}
    sid = current_span_id()
    if sid is not None:
        out["span_id"] = sid
    return out


set_trace_stamper(_stamp)


def reset_trace() -> None:
    """Drop the cached trace id and any open spans (tests; also how a
    long-lived process re-keys itself after re-pointing ``obs_dir`` at a
    new run directory)."""
    global _trace_id, _id_counter, _span_salt
    with _lock:
        _trace_id = None
        _id_counter = 0
        _span_salt = None
        _stack.clear()
