# Ported from distributed_matvec_tpu/utils/faults.py.
"""Deterministic fault injection — the chaos layer behind ``DMT_FAULT``.

Every carefully built failure path (retry-with-backoff, preemption, the
heartbeat's stall exit) is dead code until something actually fails, and
real failures on a card fleet are neither deterministic nor cheap to
reproduce.  This module turns them into a knob: named *sites* sit on the
port's comms and transfer edges, and

    DMT_FAULT="site[:field=value]*[,site2...]"

arms any subset with per-site deterministic behavior:

    p=<float>      fire probability per eligible call (default 1.0)
    n=<int>        maximum number of fires (default 1 — fail once, then
                   heal: exactly what a retry path needs to be exercised)
    skip=<int>     skip the first k eligible calls (default 0 — lets a
                   fault land mid-solve instead of on the first touch)
    seed=<int>     per-site RNG seed for p < 1 (default 0)
    rank=<int>     fire only on this process rank (the rank of the
                   initialized ``torch.distributed`` group; default: all)
    delay=<ms>     SLEEP instead of raising — latency injection, used to
                   stretch a solve so a kill lands mid-iteration
                   deterministically

The sites of the port:

* ``exchange`` — the head of ``DistributedEngine.matvec``, before any
  device work (``RuntimeError``), so the next apply runs clean;
* ``plan_upload`` — the host fetch of one plan chunk that feeds the pinned
  H2D ring of a streamed or hybrid apply (``RuntimeError``), retried
  through :func:`with_retries` (``io_retries``, ``io_retry_base_s``);
* ``plan_chunk_read`` — each record read of a streamed plan's disk tier
  (``OSError``), retried likewise; a read that keeps failing rebuilds the
  chunk from structure (``parallel/distributed.py``);
* ``solver_block`` — each solver's block boundary, beside its preemption
  safe point (``lanczos``, ``lanczos_block``, ``kpm``, ``evolve``);
* ``ckpt_write`` / ``ckpt_rename`` — before an engine structure sidecar's
  or a solver checkpoint's temp file is written and before it is renamed
  into place (``io/hdf5.py``, ``io/sharded_io.py``, ``OSError``; a solver
  checkpoint's save fails soft and the solve goes on);
* ``ckpt_reshard`` — the head of a D → D′ checkpoint restore's staging
  (``parallel/reshard.py``, ``OSError``): the restore degrades to a fresh
  solve;
* ``artifact_read`` — each read of a basis checkpoint or a structure
  sidecar, retried through :func:`with_retries` and then degrading to a
  rebuild and the quarantine tally (``utils/artifacts.py``);
* ``artifact_save`` — before the basis artifact's atomic save, which
  then fails soft.

Examples::

    DMT_FAULT=plan_upload:n=2                # two chunk fetches fail, retried
    DMT_FAULT=exchange:p=0.1:seed=7
    DMT_FAULT=solver_block:delay=250:n=10000   # 250 ms on EVERY solver
                                               # block (n=1 default would
                                               # delay only the first)

Unset, the layer is **inert** — the same no-op-singleton pattern as
``DMT_OBS=off``: :func:`check` resolves to a shared null registry and
returns after one identity test; no site state, no RNG, no event, and the
apply launches exactly the kernels it launches with the layer absent
(every site is host-side).

A fired site raises the *caller-chosen* exception type (``RuntimeError``
for the comms and transfer sites) with a ``[fault-injection]`` message
prefix, so the failure flows through exactly the handling a real failure
would take, and emits one ``fault_injected`` event plus a
``fault_injected{site=...}`` counter so a chaos run's event log shows
precisely which faults actually landed.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from .config import get_config

__all__ = ["check", "enabled", "fired_count", "reset", "with_retries",
           "FaultSpecError"]


class FaultSpecError(ValueError):
    """Malformed ``DMT_FAULT`` spec (loud: a chaos harness with a typo'd
    site spec must not silently test nothing)."""


class _Site:
    __slots__ = ("name", "p", "n", "skip", "seed", "rank", "delay_ms",
                 "calls", "fired", "_rng")

    def __init__(self, name: str, p: float = 1.0, n: int = 1, skip: int = 0,
                 seed: int = 0, rank: Optional[int] = None,
                 delay_ms: float = 0.0):
        self.name = name
        self.p = p
        self.n = n
        self.skip = skip
        self.seed = seed
        self.rank = rank
        self.delay_ms = delay_ms
        self.calls = 0
        self.fired = 0
        self._rng = None

    def should_fire(self) -> bool:
        self.calls += 1
        if self.calls <= self.skip or self.fired >= self.n:
            return False
        if self.rank is not None:
            from .logging import _process_index
            if _process_index() != self.rank:
                return False
        if self.p < 1.0:
            if self._rng is None:
                import zlib

                import numpy as np
                # keyed by (seed, site) so two armed sites never share a
                # random stream even under the default seed; crc32, NOT
                # hash() — str hashing is salted per process and would
                # make the firing pattern unreproducible across runs/ranks
                self._rng = np.random.default_rng(
                    (self.seed, zlib.crc32(self.name.encode())))
            if self._rng.random() >= self.p:
                return False
        self.fired += 1
        return True


class _NullRegistry:
    """Shared inert registry when ``DMT_FAULT`` is unset/empty."""

    __slots__ = ()
    sites: dict = {}

    def check(self, site, exc=None, **ctx):
        return None


_NULL = _NullRegistry()


class _Registry:
    __slots__ = ("sites",)

    def __init__(self, sites: dict):
        self.sites = sites

    def check(self, site: str, exc=OSError, **ctx) -> None:
        s = self.sites.get(site)
        if s is None or not s.should_fire():
            return
        if s.delay_ms > 0.0:
            time.sleep(s.delay_ms / 1e3)
            self._record(site, s, "delay", ctx)
            return
        self._record(site, s, "raise", ctx)
        raise exc(f"[fault-injection] site {site!r} fired "
                  f"(#{s.fired}/{s.n})")

    @staticmethod
    def _record(site: str, s: _Site, action: str, ctx: dict) -> None:
        try:
            from ..obs.events import emit
            from ..obs.metrics import counter

            counter("fault_injected", site=site).inc()
            emit("fault_injected", site=site, action=action,
                 fired=int(s.fired), call=int(s.calls), **ctx)
        except Exception:
            pass   # injection must never fail for a telemetry reason


def _parse(spec: str) -> "_Registry":
    sites: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        name = fields[0].strip()
        if not name:
            raise FaultSpecError(f"empty site name in DMT_FAULT {spec!r}")
        kw: dict = {}
        for f in fields[1:]:
            if "=" not in f:
                raise FaultSpecError(
                    f"bad field {f!r} in DMT_FAULT site {name!r} "
                    "(use key=value)")
            k, v = f.split("=", 1)
            k = k.strip()
            try:
                if k == "p":
                    kw["p"] = float(v)
                elif k == "n":
                    kw["n"] = int(v)
                elif k == "skip":
                    kw["skip"] = int(v)
                elif k == "seed":
                    kw["seed"] = int(v)
                elif k == "rank":
                    kw["rank"] = int(v)
                elif k == "delay":
                    kw["delay_ms"] = float(v)
                else:
                    raise FaultSpecError(
                        f"unknown field {k!r} in DMT_FAULT site {name!r} "
                        "(use p | n | skip | seed | rank | delay)")
            except ValueError as e:
                if isinstance(e, FaultSpecError):
                    raise
                raise FaultSpecError(
                    f"bad value {v!r} for field {k!r} in DMT_FAULT site "
                    f"{name!r}") from e
        sites[name] = _Site(name, **kw)
    return _Registry(sites) if sites else _NULL


_REG = None


def _registry():
    global _REG
    if _REG is None:
        # env consulted directly (not just the config snapshot) so a chaos
        # harness can arm a subprocess without racing the config cache —
        # the same contract as artifacts_enabled / obs_enabled
        env = os.environ.get("DMT_FAULT")
        spec = env if env is not None else get_config().fault
        _REG = _parse(spec or "")
    return _REG


def check(site: str, exc=OSError, **ctx) -> None:
    """One injection point.  Inert (shared-null fast path) unless
    ``DMT_FAULT`` arms ``site``; armed, either sleeps (``delay=``) or
    raises ``exc`` with a ``[fault-injection]`` message."""
    reg = _registry()
    if reg is _NULL:
        return
    reg.check(site, exc=exc, **ctx)


def enabled() -> bool:
    """Whether any fault site is armed."""
    return _registry() is not _NULL


def fired_count(site: str) -> int:
    """How many times ``site`` has fired in this process (0 when unarmed)."""
    s = _registry().sites.get(site)
    return int(s.fired) if s is not None else 0


def reset() -> None:
    """Drop the parsed registry so the next :func:`check` re-reads
    ``DMT_FAULT`` (tests / long-lived harnesses re-arming a process)."""
    global _REG
    _REG = None


def with_retries(site: str, fn, exc_types=(OSError,),
                 attempts: Optional[int] = None,
                 base_s: Optional[float] = None):
    """Bounded retry-with-backoff for idempotent I/O reads.

    Runs ``fn()`` up to ``attempts`` times (default ``io_retries``),
    sleeping ``base_s · 2^(attempt-1)`` between tries; each retry emits an
    ``io_retry`` event + ``io_retry{site=...}`` counter, and the final
    failure re-raises — callers keep their existing degraded fallbacks
    (rebuild, quarantine) for the persistent case.  Transient failures
    (a NFS blip mid plan-chunk read, hundreds of Lanczos iterations into
    a solve) heal here instead of killing the run."""
    cfg = get_config()
    tries = attempts if attempts is not None else max(int(cfg.io_retries), 1)
    delay = base_s if base_s is not None else float(cfg.io_retry_base_s)
    for attempt in range(1, tries + 1):
        try:
            return fn()
        except exc_types as e:
            if attempt == tries:
                raise
            try:
                from ..obs.events import emit
                from ..obs.metrics import counter

                counter("io_retry", site=site).inc()
                emit("io_retry", site=site, attempt=attempt,
                     error=repr(e))
            except Exception:
                pass
            from .logging import log_warn
            log_warn(f"{site}: transient failure ({e!r}); "
                     f"retry {attempt}/{tries - 1}")
            time.sleep(delay * (2 ** (attempt - 1)))
