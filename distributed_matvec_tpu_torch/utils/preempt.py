# Ported from distributed_matvec_tpu/utils/preempt.py.
"""Preemption-safe solves: SIGTERM/SIGINT latch + the ``Preempted`` exit.

Preemptible machines deliver a SIGTERM and a short grace window; a long
solve must turn that into a clean stop at a safe point and a distinct exit
code, not a torn process.  The contract:

* :func:`ensure_installed` installs latch-setting handlers — no I/O, no
  locks, nothing a signal context can deadlock on.  Installed
  process-wide (idempotent, main thread only, ``DMT_PREEMPT=off`` to opt
  out) and deliberately NOT uninstalled after a solve: a signal landing
  *between* solves must still latch, so the next safe point exits
  preempted.  The solver loops install **SIGTERM only** so a library
  user's Ctrl-C keeps its ordinary KeyboardInterrupt semantics; the solve
  service opts SIGINT into the latch too.
* The solver checks the latch at a *safe point* — the block boundary,
  where the recurrence state is host-consistent and no collective is in
  flight — agrees on the verdict across ranks (:func:`agreed`: one
  max-``all_reduce`` over the rank group), flushes the obs sinks, and
  raises :class:`Preempted`.  A solve given a checkpoint path writes its
  checkpoint first and names it in ``Preempted.checkpoint_path`` (None
  without one, as in the JAX solvers).
* The solve service catches :class:`Preempted` and exits
  :data:`EXIT_PREEMPTED` (75, ``EX_TEMPFAIL``: "transient, retry") with
  every in-flight job still spooled, so a supervisor can relaunch the SAME
  argv and resume the undone work.

A second signal while the latch is already set restores the default
disposition and re-raises it — a stuck process can always be killed the
ordinary way.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Optional

__all__ = ["EXIT_PREEMPTED", "Preempted", "ensure_installed", "requested",
           "agreed", "trigger", "reset", "set_flight_hook", "safe_point",
           "exit_preempted"]

#: Distinct exit code for a preemption (EX_TEMPFAIL: transient failure,
#: relaunch with the same argv to resume).
EXIT_PREEMPTED = 75

_latch = False
_signum: Optional[int] = None
_prev: dict = {}
_flight_hook = None           # obs/flight registers its dump at import
_flight_fired = False


class Preempted(Exception):
    """A solve stopped at a safe point in response to a preemption signal
    (or a programmatic :func:`trigger`).  ``checkpoint_path`` is the
    checkpoint the resume should restore from (None when the solve ran
    without one)."""

    def __init__(self, solver: str, iters: int,
                 checkpoint_path: Optional[str] = None):
        self.solver = solver
        self.iters = int(iters)
        self.checkpoint_path = checkpoint_path
        where = f" (checkpoint: {checkpoint_path})" if checkpoint_path \
            else " (no checkpoint configured)"
        super().__init__(
            f"{solver} preempted at iteration {iters}{where}; relaunch "
            f"with the same arguments to resume")


def _handler(signum, frame):
    global _latch, _signum
    if _latch:
        # second signal: the graceful path is already in progress (or
        # stuck) — restore the default disposition and deliver it
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)
        return
    _latch = True
    _signum = signum


def ensure_installed(signals=(signal.SIGTERM,)) -> bool:
    """Install the latch handlers process-wide (idempotent per signal).
    The default covers SIGTERM only; the solve service passes SIGINT too.
    Main thread only — signal dispositions cannot be set elsewhere; a
    worker-thread caller still reads a latch set by a main-thread
    installation or :func:`trigger`.  ``DMT_PREEMPT=off`` (or config
    ``preempt="off"``) opts out.  Returns True when all requested handlers
    are (now) active."""
    from .config import get_config

    knob = os.environ.get("DMT_PREEMPT")
    if knob is None:
        knob = get_config().preempt
    if str(knob).strip().lower() in ("off", "0", "false", "no"):
        return False
    if threading.current_thread() is not threading.main_thread():
        return False
    ok = True
    for s in signals:
        if s in _prev:
            continue
        try:
            _prev[s] = signal.signal(s, _handler)
        except (ValueError, OSError):   # exotic embedding: leave as-is
            ok = False
    return ok


def set_flight_hook(fn) -> None:
    """Register the flight recorder's dump callback (``obs/flight.py``
    does this at import).  The signal handler itself stays I/O-free, so
    the hook runs on the SOLVE thread the first time the latch is observed
    via :func:`requested`.  ``fn(signum)`` is called at most once per
    process; a failing hook is dropped."""
    global _flight_hook
    _flight_hook = fn


def _fire_flight_hook() -> None:
    global _flight_hook, _flight_fired
    if _flight_fired or _flight_hook is None:
        return
    _flight_fired = True
    try:
        _flight_hook(_signum)
    except Exception:
        _flight_hook = None


def requested() -> bool:
    """Whether a preemption signal has been latched (this process)."""
    if _latch:
        _fire_flight_hook()
    return _latch


def signal_number() -> Optional[int]:
    return _signum


def agreed(multi) -> bool:
    """Cross-rank verdict on the latch: when the solve's collectives span
    processes every rank must take the exit branch *together* or the
    survivors hang in the next collective, so the local flags are
    max-reduced with one ``all_reduce`` over the rank group (the JAX
    package's ``process_allgather``).  ``multi`` is that group — a
    :class:`~..parallel.mesh.ShardGroup`, whose every rank must call
    together — or False/None for a solve whose collectives stay in this
    process, which returns the local latch."""
    if not multi:
        return requested()
    import torch

    flag = torch.tensor([1 if requested() else 0], dtype=torch.int32,
                        device=multi.device)
    return bool(int(multi.all_reduce(flag, op="max").item()))


def exit_preempted(solver: str, iters: int,
                   checkpoint_path: Optional[str] = None) -> None:
    """Emit ``solver_preempted``, flush the obs sinks and raise
    :class:`Preempted` ``(solver, iters, checkpoint_path)`` — a solver's
    exit once the latch is agreed set (and its checkpoint, if any, is
    written)."""
    from .. import obs

    obs.emit("solver_preempted", solver=solver, iters=int(iters),
             checkpoint=checkpoint_path or "")
    obs.flush()
    raise Preempted(solver, iters, checkpoint_path)


def safe_point(solver: str, iters: int, group=None) -> None:
    """The safe point of a solve without a checkpoint: when the latch is
    agreed set, :func:`exit_preempted` with no checkpoint — what the JAX
    solvers do at the same places when they run without one."""
    if agreed(group):
        exit_preempted(solver, iters)


def trigger() -> None:
    """Programmatically set the latch (tests, embedding harnesses with
    their own signal plumbing)."""
    global _latch
    _latch = True


def reset() -> None:
    """Clear the latch (tests; a resumed in-process solve after a handled
    ``Preempted``)."""
    global _latch, _signum, _flight_fired
    _latch = False
    _signum = None
    _flight_fired = False
