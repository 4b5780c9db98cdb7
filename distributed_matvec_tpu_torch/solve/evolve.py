# Ported from distributed_matvec_tpu/solve/evolve.py.
"""Krylov ``exp(-iHt)`` time evolution over the engines.

PyTorch counterpart of ``distributed_matvec_tpu/solve/evolve.py``.  Each
accepted step projects the propagator onto a small Krylov space:
``psi(t + dt) ~= ||psi|| * V_m exp(-i dt T_m) e_1`` with ``V_m`` built by
``m`` engine applies (Lanczos with one full reorthogonalization pass — m
is small, the dots are trivial next to the matvec) and ``T_m`` the m-by-m
real symmetric tridiagonal, exponentiated on the host through its
eigendecomposition.  On a rank engine (one shard per process) every dot
is summed over the ranks through the engine's all-reduce.

Complex states on real-sector engines ride the multi-column apply: a real
Hamiltonian acts on Re and Im independently, so ``psi`` is applied as the
2-column real block ``[Re psi, Im psi]`` — one engine apply per Krylov
vector (for the streamed engine, one pass over the plan).  Complex-sector
engines consume complex states directly.

Adaptive stepping costs no extra applies: the Krylov basis is valid for
any dt, so a rejected step only re-exponentiates the same small T at dt/2;
the residual-based local error estimate ``err(dt) = beta_m *
|[exp(-i dt T)]_{m,1}|`` (Saad '92) prices the step before the state is
committed.  Acceptance is deterministic in the state.

Norm drift ``| ||psi|| - 1 |`` (the propagator is unitary; drift is pure
roundoff) and energy drift ``|E(t) - E(0)|`` (the recurrence's first alpha
is <psi|H|psi> for free) are recorded per step.  Checkpoint/resume, the
preemption latch and tracing of the JAX module are not in the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models.observables import _complex_native
from ..utils.device import start_device
from .lanczos import _rand_like, _vdot, rank_reducer, refuse_checkpoint

__all__ = ["EvolveResult", "krylov_evolve"]

#: breakdown threshold: a residual norm this far below the state scale
#: means the Krylov space closed and exp(-i dt T) is exact ("happy
#: breakdown" — the step is accepted with zero error estimate)
_BREAKDOWN = 1e-14


@dataclass
class EvolveResult:
    psi: torch.Tensor               # final state, engine layout, complex
    times: np.ndarray               # [steps + 1] accepted times (t_0 = 0)
    energies: np.ndarray            # [steps + 1] <psi|H|psi> trajectory
    norm_drift: float               # max | ||psi|| - 1 | over the run
    energy_drift: float             # max |E(t) - E(0)| / max(1, |E(0)|)
    num_steps: int
    num_applies: int
    num_rejects: int = 0
    observables: Optional[dict] = None   # name -> [(t, value), ...]


def krylov_evolve(
    matvec: Callable,
    psi0=None,
    t_final: float = 1.0,
    n: Optional[int] = None,
    dt0: Optional[float] = None,
    krylov_dim: int = 24,
    tol: float = 1e-12,
    seed: int = 0,
    max_steps: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    observables=None,
    obs_every: int = 1,
    device=None,
) -> EvolveResult:
    """Evolve ``psi0`` under ``exp(-i H t)`` to ``t_final``.

    ``psi0`` is a state in the matvec's layout (real or complex; None
    draws a seeded normalized random state: the streamed engine's
    ``random_hashed(seed)``, else a draw of length ``n``).  ``tol`` is the
    local-error budget per unit time: a step of size dt is accepted when
    its Krylov residual estimate is below ``tol * dt``.  ``dt0`` seeds the
    adaptive step (default ``t_final / 16``); accepted steps grow by
    sqrt(2) while the estimate stays an order under budget, rejected steps
    halve and re-exponentiate the same basis.  ``max_steps`` bounds the
    accepted-step count (a budget exit, reported via
    ``times[-1] < t_final``).

    ``observables`` is a list of ``models.observables.BoundObservable``
    (or ``(name, callable)`` pairs) evaluated every ``obs_every`` accepted
    steps.  ``checkpoint_path`` is not supported yet and raises
    ``NotImplementedError``.  ``device`` defaults to the device of
    ``psi0`` when it is a tensor, else to ``cuda`` (raising when there is
    none).
    """
    refuse_checkpoint(checkpoint_path)
    owner = getattr(matvec, "__self__", None)
    red = rank_reducer(matvec)
    t_final = float(t_final)
    if not t_final > 0.0:
        raise ValueError(f"t_final must be > 0, got {t_final}")
    m_cap = max(int(krylov_dim), 2)

    def raw_mv(x):
        y = matvec(x)
        return y[0] if isinstance(y, tuple) else y

    if psi0 is None:
        if owner is not None and hasattr(owner, "random_hashed"):
            psi0 = owner.random_hashed(seed)
        elif n is not None:
            psi0 = _rand_like((n,), np.float64, seed)
        else:
            raise ValueError("pass psi0 or n")
    psi = torch.as_tensor(psi0).to(start_device(psi0, device))
    # a real-sector engine gets the 2-column real block, a complex-sector
    # engine runs native: answered statically for an engine (no probe
    # apply); a bare callable pays one probe
    if owner is not None:
        complex_native = _complex_native(owner)
        napply = 0
    else:
        probe = raw_mv(psi.real if psi.is_complex() else psi)
        complex_native = probe.is_complex()
        napply = 1
        del probe
    cdtype = torch.promote_types(torch.complex128, psi.dtype)
    psi = psi.to(cdtype)

    if complex_native:
        def apply_c(z):
            return raw_mv(z).to(cdtype)
    else:
        def apply_c(z):
            # one engine apply of the 2-column real block [Re z, Im z]
            blk = torch.stack([z.real, z.imag], dim=-1)
            w = raw_mv(blk)
            return torch.complex(w[..., 0], w[..., 1]).to(cdtype)

    nrm0 = float(torch.sqrt(_vdot(psi, psi, red).real))
    if not np.isfinite(nrm0) or nrm0 <= 0.0:
        raise ValueError("psi0 has no norm")
    psi = psi / nrm0

    dt = float(dt0) if dt0 else t_final / 16.0
    dt_max = t_final / 2.0
    t = 0.0
    step = 0
    rejects = 0
    norm_drift = 0.0
    energy_drift = 0.0
    e0_ref: Optional[float] = None
    times: List[float] = [0.0]
    energies: List[float] = []
    obs_vals: dict = {}
    obs_list = []
    for o in (observables or ()):
        if hasattr(o, "expectation"):
            obs_list.append((getattr(o, "name", None) or "observable",
                             o.expectation))
        else:
            obs_list.append((o[0], o[1]))

    def eval_observables():
        for name, fn in obs_list:
            obs_vals.setdefault(name, []).append((t, fn(psi)))

    while t < t_final * (1.0 - 1e-15):
        if max_steps is not None and step >= int(max_steps):
            break
        # -- Krylov basis for this state (valid for any dt) ----------------
        nrm = float(torch.sqrt(_vdot(psi, psi, red).real))
        V = [psi / nrm]
        alph: List[float] = []
        bet: List[float] = []
        breakdown = False
        for jj in range(m_cap):
            w = apply_c(V[jj])
            napply += 1
            a = float(_vdot(V[jj], w, red).real)
            w = w - a * V[jj]
            if jj:
                w = w - bet[jj - 1] * V[jj - 1]
            # one full reorthogonalization pass: the small-T exponential
            # needs an orthonormal basis
            for vi in V:
                w = w - _vdot(vi, w, red) * vi
            alph.append(a)
            b = float(torch.sqrt(_vdot(w, w, red).real))
            if b <= _BREAKDOWN * max(abs(a), 1.0):
                breakdown = True
                bet.append(b)
                break
            bet.append(b)
            V.append(w / b)
        m_eff = len(alph)
        T = np.diag(np.asarray(alph))
        for i in range(m_eff - 1):
            T[i + 1, i] = T[i, i + 1] = bet[i]
        theta, S = np.linalg.eigh(T)
        # energies[i] = <psi|H|psi> at times[i]: the recurrence's first
        # alpha is the energy of the state this step starts from
        if len(energies) < len(times):
            energies.append(alph[0])
            if e0_ref is None:
                e0_ref = alph[0]
                eval_observables()

        # -- adaptive acceptance: rejections re-exponentiate the same T --
        dt_try = min(dt, t_final - t)
        while True:
            u = S @ (np.exp(-1j * dt_try * theta) * S[0, :])
            err = (0.0 if breakdown
                   else abs(bet[m_eff - 1] * u[m_eff - 1]))
            if err <= float(tol) * dt_try or dt_try <= 1e-12 * t_final:
                break
            rejects += 1
            dt_try *= 0.5

        # -- commit ----------------------------------------------------------
        uj = torch.from_numpy(u).to(psi.device, cdtype)
        psi = nrm * sum(uj[i] * V[i] for i in range(m_eff))
        t += dt_try
        step += 1
        nrm_new = float(torch.sqrt(_vdot(psi, psi, red).real))
        norm_drift = max(norm_drift, abs(nrm_new - 1.0))
        e_t = alph[0]           # <psi|H|psi> at the step start
        energy_drift = max(energy_drift,
                           abs(e_t - e0_ref) / max(1.0, abs(e0_ref)))
        times.append(t)
        if obs_list and step % max(int(obs_every), 1) == 0:
            eval_observables()
        # grow only when the estimate is an order under budget (and never
        # past dt_max)
        if not breakdown and err < 0.1 * float(tol) * dt_try:
            dt = min(dt_try * 1.41421356, dt_max)
        else:
            dt = dt_try

    # close the energy trajectory at the final state (one extra apply) so
    # energies aligns with times; this also covers a run that took no step
    if len(energies) < len(times):
        w = apply_c(psi)
        napply += 1
        nrm2 = float(_vdot(psi, psi, red).real)
        e_fin = float(_vdot(psi, w, red).real) / max(nrm2, 1e-300)
        if e0_ref is None:
            e0_ref = e_fin
            eval_observables()
        energies.append(e_fin)
        energy_drift = max(energy_drift,
                           abs(e_fin - e0_ref) / max(1.0, abs(e0_ref)))

    return EvolveResult(
        psi=psi, times=np.asarray(times), energies=np.asarray(energies),
        norm_drift=float(norm_drift), energy_drift=float(energy_drift),
        num_steps=step, num_applies=napply, num_rejects=rejects,
        observables=obs_vals if obs_list else None)
