# Ported from distributed_matvec_tpu/obs/hlo.py (the counterpart: per-kernel device costs of one profiled apply).
"""Kernel-level cost attribution for profiled applies.

The JAX package reads a compiled executable's optimized HLO and spreads
XLA's ``cost_analysis()`` totals over its ops.  The port has no compiled
program to read: an apply is a sequence of kernel launches (the decode
kernel, ``index_add_``, elementwise kernels, copies).  So the counterpart
reads what one apply actually ran, from a ``torch.profiler`` window
(``obs/profile.py`` samples one every ``profile_every``-th apply):

* :func:`kernel_rows` lists every CUDA kernel and memcpy of the window
  with its device time (on the CPU, where no device activity exists, the
  ``aten::`` operators with their self CPU time);
* :func:`classify_kernel` buckets each into the phase taxonomy
  (``plan_h2d`` / ``compute`` / ``exchange`` / ``accumulate`` /
  ``overhead``), keyed on kernel-name substrings (:data:`KERNEL_PHASES`,
  first match wins): the decode kernel is ``compute``, ``index_add_``'s
  kernels ``accumulate``, host-to-device copies ``plan_h2d``, NCCL
  kernels and device-to-host copies (the staged gloo exchange)
  ``exchange``; a name no entry matches is ``overhead``;
* :func:`build_profile` assembles a profile artifact — rows merged by
  kernel name, per-phase device ms, and a fingerprint (sha256 of the
  sorted kernel names: the content address of the apply's kernel set);
* :func:`record_kernel_costs` stores it, writes the artifact under the
  artifact root (``kernel-profile/<fp2>/<fp>.json``) and emits one
  ``kernel_cost`` event.

:func:`diff_profiles`, :func:`hottest_ops`, :func:`print_profile` and
:func:`print_profile_diff` are the JAX module's, copied; each takes an
``axes`` argument whose default (``bytes``, ``flops``) is the JAX
behaviour, and kernel profiles pass ``("ms",)``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.logging import log_debug as _log_debug
from .events import emit as _emit
from .events import obs_enabled as _obs_enabled
from .metrics import counter as _counter

__all__ = [
    "KERNEL_PHASES",
    "classify_kernel",
    "kernel_rows",
    "build_profile",
    "profile_fingerprint",
    "hottest_ops",
    "diff_profiles",
    "print_profile",
    "print_profile_diff",
    "record_kernel_costs",
    "kernel_costs",
    "reset_kernel_costs",
]

#: Artifact schema version (bump on layout change, never reuse).
PROFILE_VERSION = 1

#: How many per-kernel rows ride on the ``kernel_cost`` event itself (the
#: full table lives in the artifact).
EVENT_TOP_OPS = 8

#: Kernel-name substrings (lower case) → phase, first match wins.
KERNEL_PHASES: Tuple[Tuple[str, str], ...] = (
    ("nccl", "exchange"),
    ("gloo", "exchange"),
    ("memcpy dtoh", "exchange"),
    ("memcpy ptop", "exchange"),
    ("memcpy htod", "plan_h2d"),
    ("fused_decode", "compute"),
    ("indexfunc", "accumulate"),
    ("index_add", "accumulate"),
    ("indexing_backward", "accumulate"),
    ("index_put", "accumulate"),
    ("scatter", "accumulate"),
    ("fillfunctor", "overhead"),
    ("memset", "overhead"),
    ("memcpy dtod", "overhead"),
    ("indexselect", "compute"),
    ("index_select", "compute"),
    ("gather", "compute"),
    ("elementwise", "compute"),
    ("reduce_kernel", "compute"),
    ("gemm", "compute"),
    ("gemv", "compute"),
    ("dot_kernel", "compute"),
    ("aten::mul", "compute"),
    ("aten::where", "compute"),
)


def classify_kernel(name: str) -> str:
    """Phase bucket for one kernel or memcpy name (see
    :data:`KERNEL_PHASES`); ``overhead`` when no entry matches."""
    low = str(name).lower()
    for sub, phase in KERNEL_PHASES:
        if sub in low:
            return phase
    return "overhead"


def kernel_rows(prof) -> List[dict]:
    """Every device kernel and memcpy of a finished ``torch.profiler``
    window as ``{"name", "phase", "ms", "device"}`` rows, in launch
    order; without device activity (a CPU run), the ``aten::`` operators
    with their self CPU time (``device`` ``"cpu"``)."""
    from torch.autograd import DeviceType

    rows = []
    evs = list(prof.events())
    for e in evs:
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            rows.append({"name": e.name, "phase": classify_kernel(e.name),
                         "ms": e.time_range.elapsed_us() / 1e3,
                         "device": "cuda"})
    if rows:
        return rows
    for e in evs:
        if e.name.startswith("aten::") and e.self_cpu_time_total > 0:
            rows.append({"name": e.name, "phase": classify_kernel(e.name),
                         "ms": e.self_cpu_time_total / 1e3,
                         "device": "cpu"})
    return rows


def profile_fingerprint(rows: Sequence[dict]) -> str:
    """Content address of one apply's kernel set: sha256 of its sorted
    distinct kernel names."""
    names = sorted({str(r["name"]) for r in rows})
    return hashlib.sha256("\n".join(names).encode()).hexdigest()


def build_profile(key: str, rows: Sequence[dict],
                  program: Optional[str] = None) -> dict:
    """The profile artifact of one window: rows merged by kernel name
    (``ms`` summed, ``calls`` counted, ``opcode`` = the phase, so the
    copied diff and rendering read it), per-phase device ms, totals."""
    merged: Dict[str, dict] = {}
    for r in rows:
        m = merged.setdefault(r["name"], {
            "name": r["name"], "opcode": r["phase"], "phase": r["phase"],
            "ms": 0.0, "calls": 0, "device": r.get("device", "")})
        m["ms"] += float(r["ms"])
        m["calls"] += 1
    phases: Dict[str, dict] = {}
    for m in merged.values():
        ph = phases.setdefault(m["phase"], {"ms": 0.0, "ops": 0,
                                            "calls": 0})
        ph["ms"] += m["ms"]
        ph["ops"] += 1
        ph["calls"] += m["calls"]
    return {
        "version": PROFILE_VERSION,
        "key": str(key),
        "program": str(program or key),
        "fingerprint": profile_fingerprint(rows),
        "axes": ["ms"],
        "totals": {"ms": sum(m["ms"] for m in merged.values()),
                   "calls": len(rows)},
        "phases": phases,
        "ops": sorted(merged.values(), key=lambda m: -m["ms"]),
    }


def hottest_ops(profile: dict, top: int = 3,
                axes: Sequence[str] = ("bytes", "flops")) -> List[dict]:
    """The ``top`` most expensive ops by ``axes`` in order (default:
    attributed bytes, then flops — the JAX ordering; kernel profiles
    pass ``("ms",)``)."""
    ops = sorted(profile.get("ops", ()),
                 key=lambda o: tuple(-float(o.get(a, 0.0)) for a in axes)
                 + (o.get("name", ""),))
    return ops[:max(int(top), 0)]


# ---------------------------------------------------------------------------
# differential profiling

def diff_profiles(base: dict, new: dict, threshold: float = 0.25,
                  top: int = 10,
                  axes: Sequence[str] = ("bytes", "flops")) -> dict:
    """Op-by-op diff of two profile artifacts with ``obs_report diff``
    gate semantics: every cost is cost-like, so growth beyond
    ``threshold`` (relative) is a regression.  Ops are matched by name
    first, falling back to ``opcode#ordinal`` so renamed-but-identical
    programs still align.  Returns ``{"rows", "regressions",
    "appeared", "vanished", "same_program"}``; rows/regressions are
    sorted worst-first and capped at ``top``."""
    def _index(prof):
        seen: Dict[str, int] = {}
        out = {}
        for o in prof.get("ops", ()):
            ordinal = seen.get(o["opcode"], 0)
            seen[o["opcode"]] = ordinal + 1
            out[o["name"]] = (o, f"{o['opcode']}#{ordinal}")
        return out

    bi, ni = _index(base), _index(new)
    b_alias = {alias: op for op, alias in bi.values()}
    matched: List[Tuple[dict, dict]] = []
    appeared: List[dict] = []
    used_aliases = set()
    for name, (op, alias) in ni.items():
        if name in bi:
            matched.append((bi[name][0], op))
            used_aliases.add(bi[name][1])
        elif alias in b_alias:
            matched.append((b_alias[alias], op))
            used_aliases.add(alias)
        else:
            appeared.append(op)
    vanished = [op for op, alias in bi.values()
                if alias not in used_aliases
                and op["name"] not in ni]

    rows: List[dict] = []
    for b_op, n_op in matched:
        for axis in axes:
            b_v = float(b_op.get(axis, 0.0))
            n_v = float(n_op.get(axis, 0.0))
            if b_v <= 0.0 and n_v <= 0.0:
                continue
            delta = n_v - b_v
            ratio = (n_v / b_v) if b_v > 0 else float("inf")
            rows.append({
                "name": n_op["name"], "opcode": n_op["opcode"],
                "phase": n_op.get("phase", "compute"), "axis": axis,
                "base": b_v, "new": n_v, "delta": delta, "ratio": ratio,
                "regressed": (delta > 0
                              and (b_v <= 0
                                   or delta / b_v > float(threshold))),
            })
    rows.sort(key=lambda r: (-(r["delta"] if r["delta"] > 0 else 0.0),
                             r["name"]))
    regressions = [r for r in rows if r["regressed"]]
    return {
        "rows": rows[:max(int(top), 1)],
        "regressions": regressions[:max(int(top), 1)],
        "appeared": appeared[:max(int(top), 1)],
        "vanished": vanished[:max(int(top), 1)],
        "same_program": (base.get("fingerprint")
                         == new.get("fingerprint")),
    }


# ---------------------------------------------------------------------------
# rendering

def _fmt_qty(v: float) -> str:
    for unit, div in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if abs(v) >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.0f}"


def _fmt_axis(axis: str, v: float) -> str:
    return f"{float(v):.4f}" if axis == "ms" else _fmt_qty(v)


def print_profile(profile: dict, top: int = 10, out=None) -> None:
    """Human rendering of one profile artifact: identity line, phase
    table, hottest-op table."""
    import sys
    w = out or sys.stdout
    w.write(f"program   {profile.get('program', '?')}\n")
    w.write(f"key       {profile.get('key', '?')}\n")
    w.write(f"artifact  {profile.get('fingerprint', '?')[:16]}\n")
    axes = tuple(profile.get("axes") or ("bytes", "flops"))
    t = profile.get("totals", {})
    # the JAX line names flops first
    tot = ("flops", "bytes") if axes == ("bytes", "flops") else axes
    w.write("totals    " + "  ".join(
        f"{a}={_fmt_axis(a, t.get(a, 0.0))}" for a in tot) + "\n")
    w.write(f"{'phase':<20}" + "".join(f"{a:>12}" for a in axes)
            + f"{'ops':>6}\n")
    for ph in sorted(profile.get("phases", {})):
        row = profile["phases"][ph]
        w.write(f"{ph:<20}" + "".join(
            f"{_fmt_axis(a, row.get(a, 0.0)):>12}" for a in axes)
            + f"{row['ops']:>6}\n")
    w.write(f"hottest ops (top {top}):\n")
    w.write(f"  {'op':<32}{'opcode':<22}{'phase':<14}"
            + "".join(f"{a:>10}" for a in axes) + "\n")
    for o in hottest_ops(profile, top, axes):
        w.write(f"  {o['name'][:31]:<32}{o['opcode'][:21]:<22}"
                f"{o['phase']:<14}" + "".join(
                    f"{_fmt_axis(a, o.get(a, 0.0)):>10}" for a in axes)
                + "\n")


def print_profile_diff(diff: dict, out=None) -> None:
    """Human rendering of a :func:`diff_profiles` result."""
    import sys
    w = out or sys.stdout
    if diff.get("same_program"):
        w.write("programs are byte-identical (same fingerprint)\n")
    n_reg = len(diff.get("regressions", ()))
    w.write(f"{len(diff.get('rows', ()))} changed op-axes, "
            f"{n_reg} regressed, {len(diff.get('appeared', ()))} new, "
            f"{len(diff.get('vanished', ()))} gone\n")
    if diff.get("rows"):
        w.write(f"  {'op':<32}{'axis':<7}{'base':>10}{'new':>10}"
                f"{'ratio':>8}  flag\n")
        for r in diff["rows"]:
            flag = "REGRESSED" if r["regressed"] else ""
            ratio = ("inf" if r["ratio"] == float("inf")
                     else f"{r['ratio']:.2f}x")
            w.write(f"  {r['name'][:31]:<32}{r['axis']:<7}"
                    f"{_fmt_qty(r['base']):>10}{_fmt_qty(r['new']):>10}"
                    f"{ratio:>8}  {flag}\n")
    for label, ops in (("new ops", diff.get("appeared", ())),
                       ("vanished ops", diff.get("vanished", ()))):
        for o in ops:
            w.write(f"  {label}: {o['name']} ({o['opcode']}, "
                    f"{_fmt_qty(float(o.get('bytes', 0.0)))}B)\n")


# ---------------------------------------------------------------------------
# capture

_lock = threading.Lock()
_profiles: Dict[str, dict] = {}


def record_kernel_costs(key: str, prof, program: Optional[str] = None,
                        **fields) -> Optional[dict]:
    """Attribute one finished ``torch.profiler`` window: list its kernels
    (:func:`kernel_rows`), build the profile, store it in the process
    registry, persist the artifact and emit one ``kernel_cost`` event
    (totals + per-phase device ms + top kernels + artifact path).
    Soft-fail; returns the profile dict or None."""
    if not _obs_enabled():
        return None
    try:
        prof_d = build_profile(key, kernel_rows(prof), program=program)
    except Exception as e:
        _log_debug(f"kernel attribution failed for {key}: {e!r}")
        return None
    path = _save_profile_artifact(prof_d)
    if path:
        prof_d["artifact"] = path
    with _lock:
        _profiles[str(key)] = prof_d
    _counter("kernel_profile_count", program=prof_d["program"]).inc()
    phase_ms = {f"phase_ms_{ph}": row["ms"]
                for ph, row in prof_d["phases"].items()}
    _emit("kernel_cost",
          key=prof_d["key"], program=prof_d["program"],
          fingerprint=prof_d["fingerprint"],
          artifact=prof_d.get("artifact", ""),
          device_ms=prof_d["totals"]["ms"],
          n_ops=len(prof_d["ops"]),
          top_ops=hottest_ops(prof_d, EVENT_TOP_OPS, ("ms",)),
          **phase_ms, **fields)
    return prof_d


def _save_profile_artifact(prof: dict) -> Optional[str]:
    """Write the content-addressed artifact
    (``kernel-profile/<fp2>/<fp>.json``); soft-fail like every cache
    write."""
    from ..utils.artifacts import artifact_path, artifacts_enabled

    if not artifacts_enabled():
        return None
    try:
        path = artifact_path("kernel-profile", prof["fingerprint"], ".json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(prof, f, sort_keys=True)
        os.replace(tmp, path)
        return path
    except OSError as e:
        _log_debug(f"kernel-profile artifact save skipped: {e!r}")
        return None


def kernel_costs() -> Dict[str, dict]:
    """Snapshot of every recorded kernel profile, keyed by window key."""
    with _lock:
        return {k: dict(v) for k, v in _profiles.items()}


def reset_kernel_costs() -> None:
    """Drop all recorded profiles (test isolation)."""
    with _lock:
        _profiles.clear()
