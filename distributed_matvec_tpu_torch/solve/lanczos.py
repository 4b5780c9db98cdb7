"""Thick-restart Lanczos eigensolver over a matvec closure.

PyTorch counterpart of ``distributed_matvec_tpu/solve/lanczos.py::lanczos``
(the single-vector solver with full reorthogonalization).  The Krylov basis
lives in a fixed ``[rows, N]`` buffer on the device; each iteration is one
matvec, two passes of blocked modified Gram-Schmidt against the live rows,
and the (α, β) recurrence, all on the device.  The host syncs the small
(α, β) arrays every ``check_every`` steps for the convergence test.  Memory
is bounded by thick restarting (TRLan): when the basis reaches
``max_basis_size`` the ``min_restart_size`` lowest Ritz vectors are kept
with the last residual vector, and the projected matrix becomes
arrowhead-plus-tridiagonal.

Vectors are whatever ``matvec`` takes and returns (``[1, M]`` hashed for the
streamed engine); padded slots are zero by engine invariant, so the dots
are exact.  They are float64, or complex128 for a complex-Hermitian
operator: Gram-Schmidt and the norms then use conjugated inner products,
and the projected matrix stays real symmetric.  Checkpointing, the
watchdog, tracing and the selective reorthogonalization policy of the JAX
solver are not in the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from scipy.linalg import eigh

from ..utils.device import resolve_device

__all__ = ["LanczosResult", "lanczos"]

# Gram-Schmidt visits the basis in blocks of this many rows
_GS_BLOCK = 8


@dataclass
class LanczosResult:
    eigenvalues: np.ndarray          # [k] ascending
    eigenvectors: Optional[list]     # k vectors in the matvec's layout
    residual_norms: np.ndarray       # [k] |β_m · s_last| bound
    num_iters: int
    converged: bool


def _projected_matrix(alph, bet, lock_theta, lock_sigma, m):
    """Rayleigh projection T = V†HV in the current basis ``V[:m]``:
    tridiagonal before the first restart, arrowhead (locked Ritz values on
    the diagonal, coupling row σ) plus tridiagonal tail after it."""
    l = len(lock_theta)
    T = np.zeros((m, m))
    if l:
        T[:l, :l] = np.diag(lock_theta)
        T[l, :l] = lock_sigma
        T[:l, l] = lock_sigma
    for i in range(l, m):
        T[i, i] = alph[i]
    for i in range(l, m - 1):
        T[i + 1, i] = T[i, i + 1] = bet[i]
    return T


def _rand_like(shape, dtype, seed):
    """The JAX solver's start vector: a real normal draw, plus ``1j·`` a
    second draw for a complex dtype."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        v = v + 1j * rng.standard_normal(shape)
    return v.astype(dtype)


def _re_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re ⟨a, b⟩ (``a`` conjugated)."""
    return torch.vdot(a, b).real if a.is_complex() else torch.dot(a, b)


def _mgs_pass(w: torch.Tensor, V: torch.Tensor, m: int) -> torch.Tensor:
    """One blocked modified Gram-Schmidt pass of ``w`` against rows
    ``V[0..m]``."""
    for r0 in range(0, m + 1, _GS_BLOCK):
        Vb = V[r0:min(r0 + _GS_BLOCK, m + 1)]
        w = w - (Vb.conj() @ w) @ Vb
    return w


def _run_steps(mv, V, alph, bet, m0: int, nsteps: int) -> None:
    """Advance the recurrence by ``nsteps`` iterations in place: V[m+1],
    α[m], β[m] for m = m0 .. m0+nsteps−1.  No host sync."""
    for m in range(m0, m0 + nsteps):
        vm = V[m]
        w = mv(vm)
        a = _re_dot(vm, w)
        for _ in range(2):
            w = _mgs_pass(w, V, m)
        b = torch.linalg.vector_norm(w)
        V[m + 1] = w / torch.where(b <= 1e-300, torch.ones_like(b), b)
        alph[m] = a
        bet[m] = b


def lanczos(
    matvec: Callable,
    n: Optional[int] = None,
    k: int = 1,
    max_iters: int = 300,
    tol: float = 1e-10,
    seed: int = 0,
    v0=None,
    compute_eigenvectors: bool = False,
    max_basis_size: Optional[int] = None,
    min_restart_size: Optional[int] = None,
    check_every: int = 16,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> LanczosResult:
    """Lowest-``k`` eigenpairs of the Hermitian operator behind ``matvec``.

    ``v0`` (or ``n`` + ``seed``) fixes the start vector; convergence is the
    residual bound ``|β_m s_m,i| < tol·max(1,|θ_i|)`` for the k lowest Ritz
    pairs.  ``max_basis_size``/``min_restart_size`` bound the device
    memory at ``max_basis_size+1`` vectors via thick restarts.  ``device``
    defaults to ``cuda`` and raises when there is none.

    The vectors are ``dtype`` (``torch.float64`` or ``torch.complex128``);
    by default complex128 when ``v0`` is complex or the engine behind
    ``matvec`` has a complex sector (``real`` False), else float64.
    """
    device = resolve_device(device)
    if dtype is None:
        complex_v0 = v0 is not None and (
            v0.is_complex() if isinstance(v0, torch.Tensor)
            else np.iscomplexobj(v0))
        engine_real = getattr(getattr(matvec, "__self__", None), "real",
                              True)
        dtype = torch.complex128 if complex_v0 or engine_real is False \
            else torch.float64
    if dtype not in (torch.float64, torch.complex128):
        raise ValueError(f"dtype {dtype}: the solver runs in float64 or "
                         "complex128")
    if v0 is None:
        if n is None:
            raise ValueError("pass v0 or n")
        v0 = _rand_like(n, np.complex128 if dtype.is_complex
                        else np.float64, seed)
    v = torch.as_tensor(v0).to(device, dtype)
    shape = v.shape
    nflat = v.numel()

    def mv(x):
        y = matvec(x.reshape(shape))
        if y.dtype != dtype:
            raise ValueError(f"matvec returned {y.dtype}; the solver runs "
                             f"in {dtype}")
        return y.reshape(nflat)

    mcap = max_basis_size or min(max(4 * k + 16, 96), max_iters + 1)
    mcap = max(mcap, k + 2)
    l_restart = min_restart_size or max(2 * k + 2, min(mcap // 3, 24))
    l_restart = int(np.clip(l_restart, k, mcap - 2))

    V = torch.zeros((mcap + 1, nflat), dtype=dtype, device=device)
    V[0] = v.reshape(nflat) / torch.linalg.vector_norm(v)
    alph_d = torch.zeros(mcap, dtype=torch.float64, device=device)
    bet_d = torch.zeros(mcap, dtype=torch.float64, device=device)

    lock_theta = np.zeros(0)
    lock_sigma = np.zeros(0)
    m = 0                       # live basis: V[0..m] (m completed steps)
    total_iters = 0
    converged = False
    theta = S = res = None

    while total_iters < max_iters and not converged:
        if m == mcap:
            # thick restart: keep the l lowest Ritz vectors + the residual
            # vector; the projection becomes arrowhead + tridiagonal
            alph = alph_d.cpu().numpy()
            bet = bet_d.cpu().numpy()
            T = _projected_matrix(alph, bet, lock_theta, lock_sigma, m)
            l = l_restart
            theta_all, S_all = eigh(T)
            S_l = torch.from_numpy(np.ascontiguousarray(S_all[:, :l])).to(
                device, dtype)
            Y = S_l.T @ V[:mcap]
            v_last = V[mcap].clone()
            V[:l] = Y
            V[l] = v_last
            lock_theta = theta_all[:l].copy()
            lock_sigma = bet[m - 1] * S_all[m - 1, :l]
            m = l
        nsteps = min(check_every, mcap - m, max_iters - total_iters)
        _run_steps(mv, V, alph_d, bet_d, m, nsteps)
        alph = alph_d.cpu().numpy()
        bet = bet_d.cpu().numpy()
        m += nsteps
        total_iters += nsteps

        # breakdown: a ~zero β means the Krylov space closed at that step;
        # discard the garbage steps after it
        lo = len(lock_theta)
        broke = None
        for i in range(max(lo, m - nsteps), m):
            if bet[i] < 1e-14:
                broke = i
                break
        if broke is not None:
            m = broke + 1

        kk = min(k, m)
        T = _projected_matrix(alph, bet, lock_theta, lock_sigma, m)
        theta, S = eigh(T, subset_by_index=(0, kk - 1))
        res = np.abs(bet[m - 1] * S[m - 1, :])
        if m >= k and np.all(res < tol * np.maximum(1.0, np.abs(theta))):
            converged = True
            break
        if broke is not None:
            break

    kk = min(k, m)
    evecs = None
    if compute_eigenvectors and m:
        Sj = torch.from_numpy(np.ascontiguousarray(S[:, :kk])).to(
            device, dtype)
        E = Sj.T @ V[:m]
        evecs = [(e / torch.linalg.vector_norm(e)).reshape(shape) for e in E]
    return LanczosResult(
        eigenvalues=np.asarray(theta[:kk]) if theta is not None
        else np.zeros(0),
        eigenvectors=evecs,
        residual_norms=np.asarray(res[:kk]) if res is not None
        else np.zeros(0),
        num_iters=total_iters,
        converged=converged,
    )
