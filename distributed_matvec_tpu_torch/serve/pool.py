# Ported from distributed_matvec_tpu/serve/pool.py.
"""Engine pool — warm engines shared across jobs, LRU under a byte budget.

Engine acquisition is the expensive part of a small solve (basis
enumeration, structure build or plan resolution); a resident engine is
free.  The pool holds built engines keyed by :meth:`JobSpec.engine_key`
so every job of a same-basis group shares ONE engine — device-resident
tables and pinned host-RAM plans included — and evicts least-recently-used
engines when the resident bytes exceed the budget (``serve_pool_gb``).

Eviction drops the pool's reference; the engine's tensors are freed when
it is collected.  Every acquire/build/evict emits an ``engine_pool`` event
and refreshes the pool gauges.

Every pool builds on one ``device`` — ``cuda`` unless the caller names
another (the CPU tests pass ``device="cpu"``); without a card the pool
raises at construction, as the engines do, and nothing falls back to the
CPU.

Over ranks (JAX ``EnginePool(mesh=)``): ``EnginePool(group=g)`` builds
every spec as a rank engine ``DistributedEngine(op, group=g,
mode=spec.mode)`` on the group's device, and its live topology is the
group's world size.  Every rank drains the same jobs and must take the
same decisions in the same order — admission, batch packing, LRU
eviction — or a rank is left waiting in a collective; so the bytes the
budget counts are the engine's resident bytes summed over the ranks (one
all-reduce at build and after a re-tune), the same figure on every rank
as the JAX pool reads from its global arrays.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional

import torch

from ..obs import emit as obs_emit
from ..obs import gauge as obs_gauge
from ..utils.config import get_config
from ..utils.device import resolve_device
from .spec import JobSpec

__all__ = ["EnginePool", "build_operator", "build_engine", "engine_bytes"]

_NO_YAML = ("a yaml job spec needs the port's YAML loader "
            "(models/yaml_io.py), which comes with the CLI slice; submit an "
            "inline basis + edges spec instead")


def build_operator(spec: JobSpec):
    """The spec's Hamiltonian: inline Heisenberg (basis + edges, chain
    when ``edges`` is None).  A ``yaml`` spec raises
    ``NotImplementedError``: the port has no YAML loader yet (the
    scheduler records such a job as failed and goes on serving)."""
    if spec.yaml is not None:
        raise NotImplementedError(_NO_YAML)
    from ..models.basis import SpinBasis
    from ..models.lattices import chain_edges, heisenberg_from_edges
    basis = SpinBasis(**spec.basis)
    edges = (list(map(tuple, spec.edges)) if spec.edges is not None
             else chain_edges(int(spec.basis["number_spins"])))
    return heisenberg_from_edges(basis, edges)


def build_engine(spec: JobSpec, live_devices=None, device=None,
                 group=None):
    """One engine for the spec on ``device`` (default ``cuda``, raising
    without one): :class:`~..parallel.engine.LocalEngine` for
    single-device non-streamed jobs, :class:`~..parallel.distributed.
    DistributedEngine` otherwise (its D shards on the one device).  With
    ``group`` (a :class:`~..parallel.mesh.ShardGroup`; JAX ``mesh=``)
    every spec builds a rank engine over the group, on its device.

    ``live_devices`` clamps the spec's requested shard count to the
    CURRENT topology: a spec respooled from a service that ran at D
    devices must still build after a relaunch at D′ < D."""
    op = build_operator(spec)
    from ..parallel.distributed import DistributedEngine
    if group is not None:
        return DistributedEngine(op, group=group, mode=spec.mode)
    dev = resolve_device(device)
    n_devices = int(spec.n_devices or 0)
    if live_devices is not None and n_devices > int(live_devices):
        obs_emit("engine_clamp", job_id=spec.job_id,
                 requested_devices=n_devices,
                 live_devices=int(live_devices))
        n_devices = int(live_devices)
    if n_devices in (0, 1) and spec.mode not in ("streamed", "hybrid"):
        from ..parallel.engine import LocalEngine
        return LocalEngine(op, mode=spec.mode, device=dev)
    return DistributedEngine(op, n_devices=n_devices or 1, mode=spec.mode,
                             device=dev)


def engine_bytes(eng) -> int:
    """Resident footprint the budget counts: device structure tables
    plus the streamed mode's host-RAM plan (encoded bytes).  A rank
    engine holds one shard's share of each, so the figure is all-reduced
    over its group — collective: every rank calls it together."""
    total = 0
    for attr in ("ell_nbytes", "plan_bytes"):
        try:
            total += int(getattr(eng, attr, 0) or 0)
        except (TypeError, ValueError):
            pass
    if getattr(eng, "group", None) is not None:
        total = int(eng.reduce_sum(torch.tensor(
            total, dtype=torch.int64, device=eng.device)))
    return total


class EnginePool:
    """LRU of warm engines keyed by engine fingerprint.

    ``device`` is where every engine is built (default ``cuda``; raises
    without a card unless the caller passes ``device="cpu"``).
    ``live_devices`` (default: the group's world size with ``group``,
    else ``torch.cuda.device_count()`` on the card, 1 on the CPU, at
    acquire time) is the pool's view of the CURRENT topology: a warm
    engine whose shard count no longer fits is dropped on its next
    acquire and rebuilt clamped to the live capacity.  ``group`` (a
    :class:`~..parallel.mesh.ShardGroup`) builds rank engines over it on
    its device (see the module docstring)."""

    def __init__(self, max_bytes: Optional[int] = None,
                 builder: Optional[Callable] = None,
                 live_devices: Optional[int] = None, device=None,
                 group=None):
        self.group = group
        if group is not None:
            if device is not None and resolve_device(device) != group.device:
                raise ValueError(f"device {device}: the pool's group runs "
                                 f"on {group.device}")
            device = group.device
        self.device = resolve_device(device)
        if max_bytes is None:
            max_bytes = int(get_config().serve_pool_gb * 1e9)
        self.max_bytes = int(max_bytes)
        self.live_devices = live_devices
        self._builder = builder or (lambda spec: build_engine(
            spec, live_devices=self.live_device_count(),
            device=self.device, group=self.group))
        self._engines: "OrderedDict[str, object]" = OrderedDict()
        self._bytes: dict = {}
        self.builds = 0
        self.hits = 0
        self.evictions = 0

    def live_device_count(self) -> int:
        """The current topology the pool serves on."""
        if self.live_devices is not None:
            return int(self.live_devices)
        if self.group is not None:
            return int(self.group.world_size)
        if self.device.type == "cuda":
            return int(torch.cuda.device_count())
        return 1

    # -- introspection -----------------------------------------------------

    def total_bytes(self) -> int:
        return sum(self._bytes.values())

    def __len__(self) -> int:
        return len(self._engines)

    def __contains__(self, key: str) -> bool:
        return key in self._engines

    def keys(self):
        return list(self._engines)

    # -- acquire / evict ---------------------------------------------------

    def acquire(self, spec: JobSpec):
        """The warm engine for ``spec`` (LRU-refreshed), building on miss
        and evicting LRU engines past the byte budget.  The just-built
        engine is never evicted by its own insertion — a single engine
        larger than the budget still serves its batch (and is evicted by
        the NEXT insertion)."""
        key = spec.engine_key()
        eng = self._engines.get(key)
        if eng is not None and not self._mesh_ok(eng, spec):
            # the topology changed under a warm engine: its shard count
            # exceeds the live devices, or it was built clamped and the
            # fleet has since regrown — drop and rebuild
            self._engines.pop(key, None)
            freed = self._bytes.pop(key, 0)
            self.evictions += 1
            self._event("evict", key, freed_bytes=int(freed),
                        reason="mesh_mismatch",
                        engine_devices=int(getattr(eng, "n_devices", 1)
                                           or 1),
                        live_devices=self.live_device_count())
            eng = None
        if eng is not None:
            self._engines.move_to_end(key)
            self.hits += 1
            # between jobs is a safe re-key boundary: a live-tuned engine
            # whose drift check proposed new knobs rebuilds its plan HERE,
            # never inside a caller's apply sequence
            retune = getattr(eng, "maybe_retune", None)
            if retune is not None and retune():
                self._bytes[key] = engine_bytes(eng)
                self._evict(keep=key)
            self._event("hit", key)
            return eng
        eng = self._builder(spec)
        self.builds += 1
        self._engines[key] = eng
        self._bytes[key] = engine_bytes(eng)
        self._evict(keep=key)
        self._event("build", key)
        return eng

    def _mesh_ok(self, eng, spec: JobSpec) -> bool:
        """Whether a warm engine's shard count matches what ``spec``
        would be built at TODAY: not above the live devices, and not
        below ``min(spec.n_devices, live)``."""
        live = self.live_device_count()
        have = int(getattr(eng, "n_devices", 1) or 1)
        if have > live:
            return False
        want = int(spec.n_devices or 0)
        return not (want and have < min(want, live))

    def _evict(self, keep: str) -> None:
        while self.total_bytes() > self.max_bytes and len(self._engines) > 1:
            victim = next(k for k in self._engines if k != keep)
            self._engines.pop(victim)
            freed = self._bytes.pop(victim, 0)
            self.evictions += 1
            self._event("evict", victim, freed_bytes=int(freed))

    def _event(self, event: str, key: str, **extra) -> None:
        # gauges mirror the event payload so the exporter and the event
        # stream read the same values
        obs_gauge("engine_pool_bytes").set(self.total_bytes())
        obs_gauge("engine_pool_max_bytes").set(self.max_bytes)
        obs_gauge("engine_pool_engines").set(len(self._engines))
        obs_emit("engine_pool", event=event, engine_key=key,
                 engine_bytes=int(self._bytes.get(key, 0)),
                 pool_bytes=int(self.total_bytes()),
                 pool_max_bytes=int(self.max_bytes),
                 engines=len(self._engines), builds=self.builds,
                 hits=self.hits, evictions=self.evictions, **extra)
