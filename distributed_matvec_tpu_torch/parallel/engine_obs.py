# Ported from distributed_matvec_tpu/parallel/engine.py (emit_engine_init, oom_reraise, register_engine_memory, record_structure_cache).
"""Telemetry shared by both engines: the ``engine_init`` event, the memory
ledger registration with its watermark, OOM forensics on the error paths,
and the context variable through which an apply names its engine.

The solvers take any callable as ``matvec``.  When it is the engine's
bound method they read the engine from ``matvec.__self__``; when it is a
wrapper (a lambda, a shift, a ``functools.partial``) they cannot, so a
solver's first apply opens a list in :data:`APPLYING`, every engine apply
made while one is open appends itself (:func:`note_applying`), and the
solver reads the list back (``solve/lanczos.py::guard_engine``).  Outside
that first apply the variable is None: it never holds an engine alive.
"""

from __future__ import annotations

import contextvars
import weakref
from typing import Optional

from ..obs import memory as obs_memory
from ..obs.events import emit, obs_enabled
from ..obs.metrics import gauge

__all__ = ["APPLYING", "emit_engine_init", "note_applying", "oom_reraise",
           "record_structure_cache", "register_engine_memory"]

#: A list that collects the engines applied while a solver listens, or None.
APPLYING: contextvars.ContextVar = contextvars.ContextVar(
    "dmt_applying_engines", default=None)


def note_applying(eng) -> None:
    """Record ``eng`` in the open :data:`APPLYING` list, if one is open."""
    box = APPLYING.get()
    if box is not None:
        box.append(eng)


def record_structure_cache(restored: bool, consulted: bool) -> None:
    """A structure or plan sidecar's outcome → ``artifact_cache{kind=
    structure}``: ``hit`` or ``miss``; nothing when no cache path resolved
    (an engine that never looked is not a miss)."""
    if not consulted:
        return
    from ..utils.artifacts import record_cache_event

    record_cache_event("structure", "hit" if restored else "miss")


def emit_engine_init(eng, engine_kind: str, init_s: Optional[float] = None
                     ) -> None:
    """One ``engine_init`` event carrying the construction split the
    timer tree measured (structure/plan build, transfer, diag) and what the
    artifact cache restored (``basis_restored``, ``structure_restored``);
    the port compiles nothing per engine (``compile_s`` 0) — the keys stay
    the JAX event's."""
    t = eng.timer
    build_s = (t.scope_total("build_structure")
               + t.scope_total("build_plan"))
    emit("engine_init",
         engine=engine_kind,
         mode=eng.mode,
         n_states=int(eng.n_states),
         pair=False,
         basis_restored=bool(getattr(eng, "basis_restored", False)),
         structure_restored=bool(getattr(eng, "structure_restored", False)),
         build_structure_s=round(build_s, 6),
         compile_s=0.0,
         kernels_s=round(build_s, 6),
         transfer_s=round(t.scope_total("transfer"), 6),
         diag_s=round(t.scope_total("diag"), 6),
         **({} if init_s is None else {"init_s": round(init_s, 6)}))


def oom_reraise(exc: BaseException, **context) -> None:
    """Error-path hook for engine build/apply: a device out-of-memory
    failure is re-raised as a typed :class:`~..obs.memory.OomError`
    carrying the forensics report; any other exception — or any exception
    with the obs layer off — propagates untouched."""
    oom = obs_memory.attach_oom(exc, **context)
    if oom is not None:
        raise oom from exc
    raise exc


def register_engine_memory(eng, engine_kind: str) -> None:
    """Register the engine's resident tensors in the memory ledger under
    ``engine/<kind>:<i>/<name>`` (released when the engine is collected),
    emit one ``memory_ledger`` event with the sizes the capacity planner
    reads, and sample a watermark."""
    if not obs_enabled():
        return
    inst = obs_memory.next_instance(engine_kind)
    eng._mem_instance = inst
    base = f"engine/{inst}"
    h = None
    for name, tree in eng.memory_arrays().items():
        h = obs_memory.track_tree(f"{base}/{name}", tree, device="device",
                                  handle=h)
    if h is not None:
        weakref.finalize(eng, h.release)
    table_bytes = int(eng.ell_nbytes)
    gauge("engine_table_bytes", engine=engine_kind).set(table_bytes)
    ctx = dict(engine=engine_kind, instance=inst, mode=eng.mode,
               n_states=int(eng.n_states), num_terms=int(eng.num_terms),
               pair=False, real=bool(eng.real),
               batch_size=int(eng.batch_size),
               T0=int((eng.ell_split or (0,))[0])
               if getattr(eng, "ell_split", None) else 0,
               table_bytes=table_bytes)
    if hasattr(eng, "n_padded"):
        ctx["n_padded"] = int(eng.n_padded)
    if hasattr(eng, "shard_size"):
        ctx.update(shard_size=int(eng.shard_size),
                   n_devices=int(eng.n_devices))
    if getattr(eng, "_capacity", None) is not None:
        ctx["exchange_capacity"] = int(eng._capacity)
    if getattr(eng, "plan_bytes", None) is not None:
        ctx["plan_bytes"] = int(eng.plan_bytes)
        ctx["stream_compress"] = str(eng.stream_compress)
        ctx["plan_bytes_raw"] = int(eng.plan_bytes_raw)
    obs_memory.emit_ledger(f"engine_init/{engine_kind}", **ctx)
    obs_memory.sample_watermark(f"engine_init/{engine_kind}")
