# Ported from distributed_matvec_tpu/models/observables.py.
"""Bound observables — ``<psi|O|psi>`` against engine-layout states.

PyTorch counterpart of ``distributed_matvec_tpu/models/observables.py``.
Every observable becomes its own engine over the solve engine's basis, on
the solve engine's device, so converged or evolved states are consumed in
their own layout: no re-enumeration, no shuffle.

* The bound engines default to ``mode="fused"`` (no structure build — an
  ELL pack per observable would cost more than the expectation value; one
  apply and one dot each), as the JAX function's do.
* Over a ``DistributedEngine`` they are ``DistributedEngine``s with the
  solve engine's shard count, row chunk, exchange capacity, device, rank
  group and hashed layout (shared, not recomputed), in any of its modes but
  ``hybrid``, which needs a split this function does not pass.  On a rank
  engine every rank binds and evaluates together.

State forms handled:

* real state, real-sector O — direct;
* complex state, real-sector O — the 2-column real block
  ``[Re psi, Im psi]``: for real symmetric O the cross terms cancel, so
  the summed batched dot ``Re·O·Re + Im·O·Im`` is the full ``psi†O·psi``;
* complex-sector O — the state promotes to complex128.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

__all__ = ["BoundObservable", "bind_observables", "expectation_value",
           "expectations"]


def _is_distributed(eng) -> bool:
    return hasattr(eng, "from_hashed")


def _complex_native(eng) -> bool:
    """Whether the engine consumes complex states directly (a
    complex-sector engine) rather than via the 2-column real block.  The
    operator's ``effective_is_real`` answers it; the engine dtype is the
    fallback for wrapped engines."""
    op = getattr(eng, "operator", None)
    if op is not None and hasattr(op, "effective_is_real"):
        return not op.effective_is_real
    dt = getattr(eng, "_dtype", None)
    return dt is not None and dt.is_complex


def expectation_value(obs_engine, psi) -> float:
    """``Re <psi|O|psi>`` for a state in ``obs_engine``'s layout.

    ``psi`` may be real or complex; expectation values of Hermitian
    observables are real, so the real part is returned.  The state is
    consumed as-is — callers own normalization.
    """
    psi = torch.as_tensor(psi).to(obs_engine.device)
    two_col = psi.is_complex() and not _complex_native(obs_engine)
    if _is_distributed(obs_engine):
        xh = torch.stack([psi.real, psi.imag], dim=-1) if two_col else psi
        return float(obs_engine.dot(xh, obs_engine.matvec(xh)).real)
    if two_col:
        x = torch.stack([psi.real, psi.imag], dim=-1)
        y = obs_engine.matvec(x)
        return float(torch.sum(x * y))
    y = obs_engine.matvec(psi)
    return float(torch.vdot(psi.to(y.dtype).reshape(-1),
                            y.reshape(-1)).real)


@dataclass
class BoundObservable:
    """One observable bound to a solve engine's basis."""

    name: str
    engine: object          # an engine over the solve engine's basis

    def expectation(self, psi) -> float:
        return expectation_value(self.engine, psi)

    def matvec(self, x):
        """O applied in the shared layout — the handle
        ``solve.kpm.kpm_spectral_function`` takes."""
        return self.engine.matvec(x)


def bind_observables(operators: Sequence, engine,
                     mode: str = "fused") -> List[BoundObservable]:
    """One bound engine per observable operator, on ``engine``'s basis,
    device and (for a ``DistributedEngine``) shards, rank group and hashed
    layout, in ``mode`` (default ``"fused"``).  Observables must commute
    with the basis symmetry group."""
    out = []
    for i, op in enumerate(operators):
        name = getattr(op, "name", None) or f"observable_{i}"
        if _is_distributed(engine):
            from ..parallel.distributed import DistributedEngine
            oeng = DistributedEngine(
                op, n_devices=engine.n_devices,
                batch_size=engine.batch_size, mode=mode,
                device=engine.device,
                all_to_all_capacity_factor=engine.all_to_all_capacity_factor,
                remote_buffer_size=engine.remote_buffer_size,
                layout=engine.layout, group=engine.group)
        else:
            from ..parallel.engine import LocalEngine
            oeng = LocalEngine(op, mode=mode, device=engine.device)
        out.append(BoundObservable(name=name, engine=oeng))
    return out


def expectations(operators: Sequence, engine, psi,
                 mode: str = "fused") -> List[Tuple[str, float]]:
    """``[(name, <psi|O|psi>), ...]`` for every operator — bind + apply
    in one call."""
    return [(b.name, b.expectation(psi))
            for b in bind_observables(operators, engine, mode=mode)]
