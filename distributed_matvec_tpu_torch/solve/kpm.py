# Ported from distributed_matvec_tpu/solve/kpm.py (kernels and reconstruction copied verbatim).
"""Chebyshev / kernel-polynomial spectral densities (KPM) over the engines.

PyTorch counterpart of ``distributed_matvec_tpu/solve/kpm.py``.  The
density of states (and any spectral function) is reconstructed from
Chebyshev moments ``mu_n = Tr[T_n(H~)]`` where ``H~`` is the Hamiltonian
rescaled into (-1, 1); every moment is repeated matvec against a fixed
operator.

* :func:`spectral_bounds` — a short plain Lanczos pass (no
  reorthogonalization, no stored basis) whose extremal Ritz values,
  widened by their residual bounds plus a safety margin, bracket the
  spectrum.  KPM diverges if any eigenvalue maps outside [-1, 1], so the
  margin is applied outward on both ends.
* :func:`kpm_moments` — the three-term recurrence
  ``t_{j+1} = 2 H~ t_j - t_{j-1}`` over a block of ``n_vectors`` seeded
  random columns in the engine's layout (hashed ``[1, M, R]`` for the
  streamed engine, whose multi-column apply streams each plan chunk once
  per moment step).  Moments come in pairs per apply (the doubling
  identities ``mu_{2j} = 2<t_j, t_j> - mu_0``, ``mu_{2j-1} = 2<t_j,
  t_{j-1}> - mu_1``), so ``n_moments`` moments cost ~``n_moments/2``
  applies.  The stochastic-trace estimate is the column mean: for
  normalized isotropic random vectors the averaged moments are the
  normalized moments of a unit-mass density.
* :func:`reconstruct_dos` / :func:`jackson_kernel` /
  :func:`lorentz_kernel` — the kernel-damped Chebyshev series summed on an
  energy grid, host NumPy.

On a rank engine (one shard per process) every dot is summed over the
ranks through the engine's all-reduce, so each rank holds the same moments.
Checkpoint/resume, the preemption latch and tracing of the JAX module are
not in the port; complex sectors run natively in complex128.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..utils.device import start_device
from .lanczos import _rand_like, _vdot, rank_reducer, refuse_checkpoint

__all__ = ["KPMResult", "spectral_bounds", "kpm_moments", "kpm_dos",
           "kpm_spectral_function", "jackson_kernel", "lorentz_kernel",
           "reconstruct_dos", "exact_moments"]


def _mv_fn(matvec: Callable):
    """Tuple-stripping eager apply."""
    def mv(x):
        y = matvec(x)
        return y[0] if isinstance(y, tuple) else y
    return mv


def _col_dots(a: torch.Tensor, b: torch.Tensor, red=None) -> np.ndarray:
    """Per-column Re<a_r, b_r> over layout axes: [R] f64 on the host.  Pad
    slots are zero by engine invariant, so the flat reduction is exact;
    for a complex-Hermitian operator the Chebyshev products are real up to
    roundoff — the real part is the moment.  ``red`` sums over the
    ranks."""
    R = a.shape[-1]
    af = a.reshape(-1, R)
    bf = b.reshape(-1, R)
    v = torch.sum(af.conj() * bf, dim=0).real
    return (v if red is None else red(v)).cpu().numpy()


def spectral_bounds(matvec: Callable, n: Optional[int] = None,
                    v0=None, iters: int = 64, seed: int = 0,
                    margin: float = 0.05, device=None
                    ) -> Tuple[float, float, int]:
    """Safe spectral bracket ``(emin, emax, n_applies)`` via a short
    Lanczos pass.

    Plain three-term recurrence, no reorthogonalization and no stored
    basis (orthogonality loss only duplicates converged extremal Ritz
    values — harmless for a bracket): ``iters`` applies, then the
    tridiagonal eigenvalues.  Each end widens by its residual bound
    ``|beta_m * s_m|`` plus ``margin`` of the Ritz span.

    The start vector is ``v0``, else the engine's ``random_hashed(seed)``
    for the streamed engine, else a seeded draw of length ``n``.
    ``device`` defaults to the start vector's when it is a tensor, else to
    ``cuda`` (raising when there is none).
    """
    from scipy.linalg import eigh_tridiagonal

    mv = _mv_fn(matvec)
    red = rank_reducer(matvec)
    owner = getattr(matvec, "__self__", None)
    if v0 is None:
        if owner is not None and hasattr(owner, "random_hashed"):
            v0 = owner.random_hashed(seed)
        elif n is not None:
            v0 = _rand_like((n,), np.float64, seed)
        else:
            raise ValueError("pass v0 or n")
    v = torch.as_tensor(v0).to(start_device(v0, device))
    nrm = torch.sqrt(_vdot(v, v, red).real)
    w0 = mv(v)                                   # probe fixes the dtype
    dtype = torch.promote_types(v.dtype, w0.dtype)
    v = (v / nrm.to(v.dtype)).to(dtype)
    w0 = (w0 / nrm.to(w0.dtype)).to(dtype)
    v_prev = torch.zeros_like(v)
    alph, bet = [], []
    napply = 0
    for j in range(max(int(iters), 2)):
        w = w0 if j == 0 else mv(v)
        napply += 0 if j == 0 else 1             # probe reused as apply 0
        w0 = None
        a = float(_vdot(v, w, red).real)
        w = w - a * v - (bet[-1] * v_prev if bet else 0.0)
        b = float(torch.sqrt(_vdot(w, w, red).real))
        alph.append(a)
        if b <= 1e-300:                          # Krylov space closed:
            bet.append(0.0)                      # bounds are exact
            break
        bet.append(b)
        v_prev, v = v, (w / b).to(dtype)
    napply += 1
    m = len(alph)
    theta, S = eigh_tridiagonal(np.asarray(alph), np.asarray(bet[:m - 1]))
    res_lo = abs(bet[-1] * S[m - 1, 0])
    res_hi = abs(bet[-1] * S[m - 1, -1])
    span = max(float(theta[-1] - theta[0]), 1e-12)
    emin = float(theta[0] - res_lo - margin * span)
    emax = float(theta[-1] + res_hi + margin * span)
    return emin, emax, napply


@dataclass
class KPMResult:
    moments: np.ndarray            # [n_moments] normalized mu_n (mu_0 = 1)
    moment_stderr: np.ndarray      # [n_moments] stderr over the R columns
    bounds: Tuple[float, float]    # (emin, emax) bracket actually used
    scale: Tuple[float, float]     # (a, b): H~ = (H - b)/a
    n_vectors: int
    num_applies: int               # engine applies (bounds pass included)


def kpm_moments(matvec: Callable, n_moments: int = 256,
                n: Optional[int] = None, n_vectors: int = 4,
                seed: int = 0, V0=None,
                bounds: Optional[Tuple[float, float]] = None,
                bounds_iters: int = 64, margin: float = 0.05,
                checkpoint_path: Optional[str] = None,
                device=None) -> KPMResult:
    """Stochastic-trace Chebyshev moments of the operator behind
    ``matvec``.

    ``V0`` (an engine-layout ``[..., R]`` block of normalized columns)
    overrides the seeded random block — the streamed engine's
    ``random_hashed(seed, cols=n_vectors)``, else ``n_vectors`` seeded
    normalized columns of length ``n``; the spectral-function path passes
    ``O|psi>/||O|psi>||``.  ``bounds`` skips the Lanczos bracket.
    ``checkpoint_path`` is not supported yet and raises
    ``NotImplementedError``.  ``device`` defaults to the device of the
    start block when it is a tensor, else to ``cuda`` (raising when there
    is none).
    """
    if int(n_moments) < 2:
        raise ValueError(f"n_moments must be >= 2, got {n_moments}")
    if V0 is None and int(n_vectors) < 1:
        raise ValueError(f"n_vectors must be >= 1, got {n_vectors}")
    refuse_checkpoint(checkpoint_path)
    n_moments = int(n_moments)
    mv = _mv_fn(matvec)
    red = rank_reducer(matvec)
    owner = getattr(matvec, "__self__", None)

    v0_given = V0 is not None
    if V0 is None:
        if owner is not None and hasattr(owner, "random_hashed"):
            V0 = owner.random_hashed(seed, cols=int(n_vectors))
        elif n is not None:
            V0 = _rand_like((n, int(n_vectors)), np.float64, seed)
            V0 = V0 / np.linalg.norm(V0, axis=0, keepdims=True)
        else:
            raise ValueError("pass V0 or n")
    dev = start_device(V0, device)
    V0 = torch.as_tensor(V0).to(dev)
    R = int(V0.shape[-1])

    # the probe apply is the j = 0 recurrence apply (it fixes the dtype)
    y0 = mv(V0)
    napply = 1
    dtype = torch.promote_types(V0.dtype, y0.dtype)
    t0 = V0.to(dtype)

    if bounds is None:
        # an explicit start block also seeds the bounds pass (its first
        # column), so reruns are deterministic
        bv0 = V0[..., 0] if v0_given else None
        emin, emax, nb = spectral_bounds(
            matvec, n=n, v0=bv0, iters=bounds_iters, seed=seed + 1,
            margin=margin, device=dev)
        napply += nb
    else:
        emin, emax = float(bounds[0]), float(bounds[1])
    if not emax > emin:
        raise ValueError(f"degenerate spectral bounds ({emin}, {emax})")
    a = (emax - emin) / 2.0
    b = (emax + emin) / 2.0
    # per-column moment table on the host; mu_0 = <r|r> = 1 exactly for
    # normalized columns, mu_1 = <r|H~|r>
    mu_cols = np.zeros((n_moments, R))
    t_lo, t_hi = t0, ((y0.to(dtype) - b * t0) / a)
    mu_cols[0] = _col_dots(t_lo, t_lo, red)
    mu_cols[1] = _col_dots(t_lo, t_hi, red)
    # j: highest recurrence index for which t_j is live in `t_hi`
    j = 1
    filled = 2
    del y0

    # each pass: harvest the doubling pair for the current t_j, then
    # advance the recurrence by one apply
    while filled < n_moments:
        # doubling identities at index j (t_lo = t_{j-1}, t_hi = t_j)
        if 2 * j - 1 < n_moments and 2 * j - 1 >= filled:
            mu_cols[2 * j - 1] = 2.0 * _col_dots(t_hi, t_lo, red) \
                - mu_cols[1]
            filled += 1
        if 2 * j < n_moments and 2 * j >= filled:
            mu_cols[2 * j] = 2.0 * _col_dots(t_hi, t_hi, red) - mu_cols[0]
            filled += 1
        if filled < n_moments:
            y = mv(t_hi).to(dtype)
            napply += 1
            t_lo, t_hi = t_hi, (2.0 / a) * y - (2.0 * b / a) * t_hi - t_lo
            j += 1

    mu = mu_cols.mean(axis=1)
    stderr = (mu_cols.std(axis=1) / np.sqrt(max(R, 1))
              if R > 1 else np.zeros(n_moments))
    return KPMResult(moments=mu, moment_stderr=stderr, bounds=(emin, emax),
                     scale=(a, b), n_vectors=R, num_applies=napply)


# -- kernels and reconstruction ---------------------------------------------
# Copied verbatim from distributed_matvec_tpu/solve/kpm.py (host NumPy).

def jackson_kernel(n_moments: int) -> np.ndarray:
    """Jackson damping ``g_n`` — the DOS default: the reconstructed
    density is strictly positive and each delta broadens to a
    near-Gaussian of width ~ pi * a / n_moments (Weisse et al.,
    Rev. Mod. Phys. 78, 275 (2006), Eq. 71)."""
    N = int(n_moments)
    nn = np.arange(N)
    q = np.pi / (N + 1)
    return ((N - nn + 1) * np.cos(q * nn)
            + np.sin(q * nn) / np.tan(q)) / (N + 1)


def lorentz_kernel(n_moments: int, lam: float = 4.0) -> np.ndarray:
    """Lorentz damping — delta functions broaden to Lorentzians (the
    right shape for Green's-function resolvents); ``lam`` trades
    resolution (small) against damping (large)."""
    N = int(n_moments)
    nn = np.arange(N)
    return np.sinh(lam * (1.0 - nn / N)) / np.sinh(lam)


def _kernel(name: str, n_moments: int, lam: float) -> np.ndarray:
    if name == "jackson":
        return jackson_kernel(n_moments)
    if name == "lorentz":
        return lorentz_kernel(n_moments, lam)
    if name in (None, "none"):
        return np.ones(int(n_moments))
    raise ValueError(f"unknown KPM kernel {name!r} "
                     "(use jackson | lorentz | none)")


def reconstruct_dos(moments: np.ndarray, scale: Tuple[float, float],
                    energies: Optional[np.ndarray] = None,
                    npoints: int = 512, kernel: str = "jackson",
                    lam: float = 4.0) -> Tuple[np.ndarray, np.ndarray]:
    """Kernel-damped Chebyshev series → density on an energy grid.

    ``rho(E) = (1 / (pi a sqrt(1 - x^2))) * [g_0 mu_0 + 2 sum_n g_n
    mu_n T_n(x)]`` with ``x = (E - b)/a``.  The default grid is the
    Chebyshev-node grid ``x_k = cos(pi (k + 1/2) / K)`` (uniform
    resolution in the angle variable — the grid KPM results are usually
    quoted on); pass ``energies`` for an explicit grid, which is clipped
    strictly inside the bracket so the ``1/sqrt(1-x^2)`` weight stays
    finite.  Normalized moments (``mu_0 = 1``) integrate to unit mass.
    """
    a, b = float(scale[0]), float(scale[1])
    mu = np.asarray(moments, np.float64)
    N = mu.shape[0]
    g = _kernel(kernel, N, lam)
    coeff = g * mu
    coeff[1:] *= 2.0
    if energies is None:
        k = np.arange(int(npoints))
        x = np.cos(np.pi * (k + 0.5) / int(npoints))[::-1]
    else:
        x = np.clip((np.asarray(energies, np.float64) - b) / a,
                    -1.0 + 1e-12, 1.0 - 1e-12)
    rho_x = np.polynomial.chebyshev.chebval(x, coeff) \
        / (np.pi * np.sqrt(1.0 - x * x))
    return a * x + b, rho_x / a


def exact_moments(eigenvalues, scale: Tuple[float, float],
                  n_moments: int) -> np.ndarray:
    """Normalized Chebyshev moments of a KNOWN spectrum — the reference
    side of broadening-aware DOS comparisons: push these through
    :func:`reconstruct_dos` with the SAME kernel as the stochastic
    moments and the residual is pure trace noise, never resolution
    mismatch."""
    a, b = float(scale[0]), float(scale[1])
    ang = np.arccos(np.clip(
        (np.asarray(eigenvalues, np.float64) - b) / a, -1.0, 1.0))
    return np.array([np.mean(np.cos(k * ang))
                     for k in range(int(n_moments))])


# -- one-call front ends -------------------------------------------------------

def kpm_dos(matvec: Callable, n_moments: int = 256,
            n: Optional[int] = None, n_vectors: int = 4, seed: int = 0,
            npoints: int = 512, kernel: str = "jackson", lam: float = 4.0,
            bounds: Optional[Tuple[float, float]] = None,
            bounds_iters: int = 64, margin: float = 0.05,
            checkpoint_path: Optional[str] = None, device=None):
    """Density of states in one call: moments + reconstruction.
    Returns ``(energies, rho, KPMResult)`` — ``rho`` integrates to 1
    (per-state density; multiply by ``n_states`` for a count density).
    """
    res = kpm_moments(matvec, n_moments, n=n, n_vectors=n_vectors,
                      seed=seed, bounds=bounds, bounds_iters=bounds_iters,
                      margin=margin, checkpoint_path=checkpoint_path,
                      device=device)
    energies, rho = reconstruct_dos(res.moments, res.scale,
                                    npoints=npoints, kernel=kernel,
                                    lam=lam)
    return energies, rho, res


def kpm_spectral_function(matvec: Callable, psi, op_apply: Callable,
                          n_moments: int = 256, npoints: int = 512,
                          kernel: str = "jackson", lam: float = 4.0,
                          bounds: Optional[Tuple[float, float]] = None,
                          bounds_iters: int = 64, margin: float = 0.05):
    """Dynamical structure factor ``S(E) = <psi|O† delta(E - H) O|psi>``.

    ``op_apply`` applies the (bound) observable O in the solve engine's
    layout (``models/observables.bind_observables`` builds such engines).
    The moments are the single-vector Chebyshev moments of
    ``phi = O|psi>`` — start block ``phi/||phi||``, density weighted by
    ``||phi||^2``.  Returns ``(energies, S, KPMResult, weight)``; the
    solve runs on ``phi``'s device.
    """
    phi = op_apply(psi)
    phi = phi[0] if isinstance(phi, tuple) else phi
    phi = torch.as_tensor(phi)
    w2 = float(_vdot(phi, phi, rank_reducer(matvec)).real)
    if w2 <= 0.0:
        raise ValueError("O|psi> vanishes: no spectral weight")
    V0 = (phi / np.sqrt(w2))[..., None]
    res = kpm_moments(matvec, n_moments, V0=V0, bounds=bounds,
                      bounds_iters=bounds_iters, margin=margin)
    energies, rho = reconstruct_dos(res.moments, res.scale,
                                    npoints=npoints, kernel=kernel,
                                    lam=lam)
    return energies, w2 * rho, res, w2
