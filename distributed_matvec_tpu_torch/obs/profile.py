# Ported from distributed_matvec_tpu/obs/profile.py.
"""Sampled continuous profiling with an overhead guard and triggered
deep capture.

Three modes, selected by the ``profile`` knob (``DMT_PROFILE``, env
consulted directly like ``DMT_OBS`` so harnesses can flip it without
racing the config cache):

* ``off`` (default) — the apply hot path sees one branch and nothing
  else.
* ``sampled`` — every ``profile_every``-th apply (the ``health_every``
  cadence pattern, skipping apply 0) runs inside a bounded
  ``torch.profiler`` window (CPU activity, and CUDA activity on the card)
  whose Chrome trace is written to
  ``<run_dir>/rank_<r>/profiles/<engine>-apply<N>/trace.json``, stamped
  with ``trace_id``/``job_id`` and announced by a ``profile_captured``
  event; the detail spans the window recorded (``obs/trace.py::
  detail_spans``, on the trace's clock) go beside it as ``spans.json``.  The window's
  kernels and copies, with their device times, go through
  :mod:`~.kernel_costs` into a ``kernel_cost`` event and a fingerprinted
  profile artifact.  A **measured-overhead guard** times
  the window's own start/stop (the trace export included) against the
  cumulative apply wall; when measured overhead exceeds
  ``profile_overhead_pct`` (default 2%) after at least two profiled
  windows, sampling latches OFF for the rest of the process and says so
  (``profile_overhead_latch`` event) — profiling must never become the
  regression it is hunting.  The profiler observes: the apply launches
  the same kernels inside a window as outside it.
* ``triggered`` — no cadence; only :func:`trigger_capture` fires.

**Triggered deep capture** (active in both non-off modes): an SLO
burn-rate alert (obs/slo.py) calls :func:`trigger_capture`, which
snapshots the hottest kernels of every recorded kernel profile, the
newest sampled-trace directory, and the overhead ledger into one
flight-recorder bundle (``trace_id``/``job_id`` stamped by
``flight_dump`` itself) so the incident carries its own profile.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time
from typing import Dict, Optional

from ..utils.config import get_config
from ..utils.logging import log_debug
from . import trace as _trace
from .events import emit, obs_enabled, run_dir
from .metrics import counter

__all__ = [
    "profile_mode",
    "profile_due",
    "sample_window",
    "stamp_profile_dir",
    "observe_apply",
    "measured_overhead_pct",
    "overhead_snapshot",
    "overhead_latched",
    "trigger_capture",
    "last_sample",
    "reset_profile",
]

_MODES = ("off", "sampled", "triggered")

_lock = threading.Lock()
_state = {
    "apply_ms": 0.0,      # cumulative apply dispatch wall, all applies
    "extra_ms": 0.0,      # cumulative measured trace start/stop cost
    "applies": 0,
    "profiled": 0,
    "latched": False,     # overhead budget blown -> sampling off
    "last_dir": "",       # newest sampled trace directory
    "last_costs": None,   # kernel profile of the newest sampled window
}


def profile_mode() -> str:
    """The active profiling mode (``off``/``sampled``/``triggered``).
    Env wins over the config snapshot; anything unrecognized, or the
    whole obs layer being off, reads as ``off``."""
    if not obs_enabled():
        return "off"
    env = os.environ.get("DMT_PROFILE")
    knob = env if env is not None else get_config().profile
    mode = str(knob).strip().lower()
    return mode if mode in _MODES else "off"


def overhead_latched() -> bool:
    """Whether the overhead guard has latched sampling off."""
    with _lock:
        return _state["latched"]


def profile_due(apply_index: int) -> bool:
    """Whether apply ``apply_index`` should capture a sampled trace
    window: ``sampled`` mode, a run directory to write into, the overhead
    guard not latched, and the ``profile_every`` cadence (skipping apply
    0, which pays the first launches' set-up)."""
    if profile_mode() != "sampled" or run_dir() is None:
        return False
    with _lock:
        if _state["latched"]:
            return False
    every = max(int(get_config().profile_every), 1)
    return apply_index > 0 and apply_index % every == 0


def observe_apply(wall_ms: float, extra_ms: float = 0.0,
                  profiled: bool = False) -> None:
    """Feed one apply's dispatch wall (and, for profiled applies, the
    measured trace start/stop cost) into the overhead ledger."""
    with _lock:
        _state["apply_ms"] += float(wall_ms)
        _state["extra_ms"] += float(extra_ms)
        _state["applies"] += 1
        if profiled:
            _state["profiled"] += 1


def measured_overhead_pct() -> float:
    """Measured profiling overhead: trace start/stop cost as a percent
    of the un-profiled apply wall.  0.0 until anything is profiled."""
    with _lock:
        base = _state["apply_ms"] - _state["extra_ms"]
        if base <= 0.0 or _state["extra_ms"] <= 0.0:
            return 0.0
        return 100.0 * _state["extra_ms"] / base


def overhead_snapshot() -> Dict[str, float]:
    """Copy of the overhead ledger (bench deltas read this before and
    after a config to attribute per-config overhead)."""
    with _lock:
        snap = dict(_state)
    snap["overhead_pct"] = measured_overhead_pct()
    return snap


def _sample_dir(engine: str, apply_index: int) -> Optional[str]:
    d = run_dir()
    if not d:
        return None
    from .events import _process_index
    return os.path.join(d, f"rank_{_process_index()}", "profiles",
                        f"{engine}-apply{int(apply_index)}")


def stamp_profile_dir(path: str, **fields) -> Optional[str]:
    """Write ``PROFILE_META.json`` (trace_id/job_id + caller fields)
    into a captured trace directory so the orphan-directory era is
    over: every profile on disk names the run that produced it."""
    from .trace import job_id, trace_id

    try:
        os.makedirs(path, exist_ok=True)
        meta = {"trace_id": trace_id(), "job_id": job_id(),
                "ts": time.time(), **fields}
        mpath = os.path.join(path, "PROFILE_META.json")
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, sort_keys=True)
        os.replace(tmp, mpath)
        return mpath
    except OSError as e:
        log_debug(f"profile dir stamp skipped for {path}: {e!r}")
        return None


def _check_budget() -> None:
    """Latch sampling off when measured overhead exceeds the budget
    after at least two profiled windows (one window is all compile/IO
    noise; two is the contract's minimum evidence)."""
    budget = float(get_config().profile_overhead_pct)
    pct = measured_overhead_pct()
    with _lock:
        if _state["latched"] or _state["profiled"] < 2:
            return
        if pct <= budget:
            return
        _state["latched"] = True
    counter("profile_overhead_latch_count").inc()
    emit("profile_overhead_latch", overhead_pct=pct, budget_pct=budget)
    log_debug(f"profile sampling latched off: measured overhead "
              f"{pct:.2f}% > budget {budget:.2f}%")


_OFF_WINDOW = contextlib.nullcontext(False)


def sample_window(engine: str, apply_index: int, mode: str = ""):
    """Wrap one apply.  With profiling off, a shared null context (one
    mode check, no generator, no ledger); otherwise almost always a timed
    pass-through (one ``perf_counter`` pair); on a due sampled apply, the
    body runs inside a bounded ``torch.profiler`` window, the window's own
    start/stop cost feeds the overhead guard, and its kernels are
    recorded through :func:`~.kernel_costs.record_kernel_costs`.  Yields
    True iff a trace was captured."""
    if profile_mode() == "off":
        return _OFF_WINDOW
    return _sample_window(engine, apply_index, mode)


@contextlib.contextmanager
def _sample_window(engine: str, apply_index: int, mode: str):
    if not profile_due(apply_index):
        t0 = time.perf_counter()
        try:
            yield False
        finally:
            observe_apply((time.perf_counter() - t0) * 1e3)
        return

    target = _sample_dir(engine, apply_index)
    t0 = time.perf_counter()
    extra_s = 0.0
    prof = None
    try:
        import torch.profiler

        from ..utils.profiling import profiler_activities
        ta = time.perf_counter()
        prof = torch.profiler.profile(activities=profiler_activities())
        prof.__enter__()
        t_open = _trace.clock()
        extra_s += time.perf_counter() - ta
    except Exception as e:
        log_debug(f"profiler start failed ({target}): {e!r}")
        prof = None
    try:
        yield prof is not None
    finally:
        costs = None
        if prof is not None:
            tb = time.perf_counter()
            t_close = _trace.clock()
            try:
                prof.__exit__(None, None, None)
                os.makedirs(target, exist_ok=True)
                prof.export_chrome_trace(os.path.join(target, "trace.json"))
                with open(os.path.join(target, "spans.json"), "w") as f:
                    json.dump(_trace.detail_spans(t_open, t_close), f)
            except Exception as e:
                log_debug(f"profiler stop failed: {e!r}")
            extra_s += time.perf_counter() - tb
            try:
                from . import kernel_costs as _kc

                costs = _kc.record_kernel_costs(
                    f"{engine}-apply{int(apply_index)}", prof,
                    program=f"{engine}_{mode}_apply" if mode
                    else f"{engine}_apply", engine=engine, mode=mode,
                    apply=int(apply_index))
            except Exception as e:
                log_debug(f"kernel cost attribution failed: {e!r}")
        wall_ms = (time.perf_counter() - t0) * 1e3
        observe_apply(wall_ms, extra_s * 1e3, profiled=prof is not None)
        if prof is not None:
            with _lock:
                _state["last_dir"] = target
                _state["last_costs"] = costs
            stamp_profile_dir(target, capture="sampled", engine=engine,
                              apply=int(apply_index))
            counter("profile_capture_count", capture="sampled").inc()
            emit("profile_captured", capture="sampled", engine=engine,
                 apply=int(apply_index), dir=target,
                 overhead_ms=extra_s * 1e3,
                 overhead_pct=measured_overhead_pct())
            _check_budget()


def last_sample() -> Optional[dict]:
    """The kernel profile of the newest sampled window (None before
    one)."""
    with _lock:
        return _state["last_costs"]


def trigger_capture(reason: str, **extra) -> Optional[str]:
    """Deep capture on an incident: snapshot the hottest kernels of every
    recorded kernel profile, the newest sampled-trace directory, and the
    overhead ledger into one
    flight-recorder bundle named after ``reason``.  Active whenever
    profiling is on at all (``sampled`` includes triggers); returns the
    bundle path or None (off / no run dir / reason already dumped)."""
    if profile_mode() == "off":
        return None
    safe = re.sub(r"[^A-Za-z0-9_-]+", "_", str(reason)).strip("_")
    safe = safe or "trigger"

    payload: Dict[str, object] = {"overhead": overhead_snapshot()}
    try:
        from . import kernel_costs as _kc

        hot = []
        for key, prof in sorted(_kc.kernel_costs().items()):
            hot.append({"key": key, "program": prof.get("program", key),
                        "fingerprint": prof.get("fingerprint", ""),
                        "artifact": prof.get("artifact", ""),
                        "top_ops": _kc.hottest_ops(prof, 3)})
        payload["kernels"] = hot
    except Exception as e:
        log_debug(f"trigger capture: kernel snapshot failed: {e!r}")
    with _lock:
        payload["last_sample_dir"] = _state["last_dir"]

    from .flight import flight_dump

    path = flight_dump(f"profile_{safe}", profile=payload, **extra)
    if path:
        counter("profile_capture_count", capture="triggered").inc()
        emit("profile_captured", capture="triggered", reason=safe,
             bundle=path)
    return path


def reset_profile() -> None:
    """Reset the overhead ledger and latch (test isolation)."""
    with _lock:
        _state.update(apply_ms=0.0, extra_ms=0.0, applies=0,
                      profiled=0, latched=False, last_dir="",
                      last_costs=None)
