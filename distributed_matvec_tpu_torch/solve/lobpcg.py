# Ported from distributed_matvec_tpu/solve/lobpcg.py; _lobpcg_standard and its helpers copied from jax/experimental/sparse/linalg.py (JAX 0.9.0).
#
# The LOBPCG iteration below (``_svqb``, ``_project_out``,
# ``_orthonormalize``, ``_rayleigh_ritz_orth``, ``_extend_basis``,
# ``_check_inputs`` and ``_lobpcg_standard``) is a PyTorch translation of
# ``jax.experimental.sparse.linalg.lobpcg_standard``, which carries this
# notice:
#
#   Copyright 2022 The JAX Authors.
#
#   Licensed under the Apache License, Version 2.0 (the "License");
#   you may not use this file except in compliance with the License.
#   You may obtain a copy of the License at
#
#       https://www.apache.org/licenses/LICENSE-2.0
#
#   Unless required by applicable law or agreed to in writing, software
#   distributed under the License is distributed on an "AS IS" BASIS,
#   WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
#   See the License for the specific language governing permissions and
#   limitations under the License.
"""Block eigensolver: LOBPCG over the engine's batched matvec.

PyTorch counterpart of ``distributed_matvec_tpu/solve/lobpcg.py``.  The
iteration is the JAX package's ``lobpcg_standard`` (JAX's own
implementation, translated here op for op rather than swapped for
``torch.lobpcg``, a different variant): it computes the *largest*
eigenvalues, so the spectrum is flipped with ``σ·I − H``, σ a 1.05×
power-iteration estimate of ‖H‖.

For the streamed engine the whole iteration runs in the engine's hashed
space: block columns are flat ``[D·M, m]`` views of the hashed layout and
every matvec is one multi-column apply.  Pad slots start at zero
(``to_hashed`` zero-fills) and stay zero — H maps them to 0 and every
LOBPCG update is a linear combination — so the flat space behaves as the
n-dimensional physical one.  Eigenvectors come back in block (sorted)
order.

Real sectors only (the JAX solver's (re, im) pair form is not ported);
multi-process runs and checkpoint/resume are not in the port.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..models.observables import _complex_native
from ..utils.device import start_device
from .lanczos import refuse_checkpoint, refuse_rank_engine

__all__ = ["lobpcg"]


# -- the LOBPCG iteration (translated from jax.experimental.sparse.linalg) ---

def _norms(X: torch.Tensor) -> torch.Tensor:
    """Column 2-norms, ``[1, k]``."""
    return torch.linalg.vector_norm(X, dim=0, keepdim=True)


def _eigh_ascending(A):
    # (the name is JAX's; the order it returns is descending)
    w, V = torch.linalg.eigh(A)
    return w.flip(0), V.flip(1)


def _svqb(X):
    """Derives a truncated orthonormal basis for ``X``: SVQB squares the
    matrix ``C = XᵀX`` and orthonormalizes through its eigenbasis;
    directions whose eigenvalue falls below ``eps·max`` are zeroed out."""
    norms = _norms(X)
    X = X / torch.where(norms == 0, 1.0, norms)

    inner = X.T @ X

    w, V = _eigh_ascending(inner)

    # if an eigenvalue is less than max eigvalue * eps, consider that
    # direction degenerate
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)

    # note the tau == 0 edge case where X was all zeros
    sqrted = torch.where(tau > 0, padded, 1.0) ** (-0.5)

    # XᵀX = V diag(w) Vᵀ, so W = X V diag(w)^(-1/2) gives WᵀW = I
    scaledV = V * sqrted[None, :]
    orthoX = X @ scaledV

    keep = ((w > tau) & (torch.diag(inner) > 0.0))[None, :]
    orthoX = orthoX * keep.to(orthoX.dtype)
    norms = _norms(orthoX)
    keep = keep & (norms > 0.0)
    orthoX = orthoX / torch.where(keep, norms, 1.0)
    return orthoX


def _project_out(basis, U):
    """The component of ``U`` in the orthogonal complement of the
    orthonormal (zero columns allowed) ``basis``, orthonormalized, with
    suspicious columns zeroed: orthogonality to ``basis`` is favoured over
    the rank of ``U`` ("twice is enough", Kahan / Parlett §6.9)."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)

    # it is crucial to end on a subtraction of the original basis: near
    # convergence the orthonormalization can reintroduce (X, P) components
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    normU = _norms(U)
    U = U * (normU >= 0.99).to(U.dtype)
    return U


def _orthonormalize(basis):
    # twice is enough, again
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _rayleigh_ritz_orth(A, S):
    """Eigenpairs of ``A`` projected onto the orthonormal (zero columns
    allowed) subspace ``S``, in descending order."""
    SAS = S.T @ A(S)
    return _eigh_ascending(SAS)


def _extend_basis(X, m):
    """Extend the orthonormal ``X`` [n, k] by ``m`` orthonormal columns,
    through block Householder reflectors (deterministic, and never
    overlapping ``X``)."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(Xupper)

    # adding U Vᵀ to Xupper lifts its singular values by 1
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)

    # H(w) = I − 2 w wᵀ with 2 w wᵀ = y (v diag(1+s)^(-1) vᵀ) yᵀ maps
    # vstack(0, eye(n − k)) onto an orthogonal extension of X
    other = torch.cat(
        [torch.eye(m, dtype=X.dtype, device=X.device),
         torch.zeros((n - k - m, m), dtype=X.dtype, device=X.device)],
        dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** (-1 / 2))[None, :])
    h = -2 * torch.linalg.multi_dot([w, w[k:, :].T, other])
    h[k:] += other
    return h


def _check_inputs(A, X):
    n, k = X.shape
    dt = X.dtype

    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")

    if k * 5 >= n:
        raise ValueError(
            f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")

    test_output = A(torch.zeros((n, 1), dtype=X.dtype, device=X.device))

    if test_output.dtype != dt:
        raise ValueError(
            f"A, X must have same dtypes (were {test_output.dtype}, {dt})")

    if tuple(test_output.shape) != (n, 1):
        s = tuple(test_output.shape)
        raise ValueError(f"A must be ({n}, {n}) matrix A, got output {s}")


def _lobpcg_standard(A: Callable, X: torch.Tensor, m: int,
                     tol: Optional[float] = None):
    """Top-``k`` eigenpairs of the Hermitian operator ``A`` from the start
    block ``X`` [n, k] (``5k < n``): ``(theta [k], U [n, k], iterations)``.

    An eigenpair converges when its residual ``|A v − λ v|`` is below
    ``tol · 10 · n · (λ + |A v|)``; the iteration stops when all k have,
    or after ``m`` iterations.  ``tol`` defaults to the dtype's epsilon.
    """
    n, k = X.shape
    _check_inputs(A, X)

    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)

    X = _orthonormalize(X)
    P = _extend_basis(X, X.shape[1])

    # X: the current best eigenvectors, P: the search direction, R: the
    # residuals, kept orthonormal (R and P columns may be 0 after basis
    # truncation, X columns never)
    AX = A(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X

    i = 0
    converged = 0
    while i < m and converged < k:
        # residual basis selection
        R = _project_out(torch.cat((X, P), dim=1), R)
        XPR = torch.cat((X, P, R), dim=1)

        # projected eigensolve
        theta_all, Q = _rayleigh_ritz_orth(A, XPR)

        # eigenvector X extraction
        B = Q[:, :k]
        B = B / _norms(B)
        X = XPR @ B
        X = X / _norms(X)

        # difference terms P: concat(0, Q[k:, :k]) orthogonalized against
        # Q[:, :k] in the standard basis before mapping with XPR, so the
        # directions come out orthonormal
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        diff_rayleigh_ortho = Q[:, k:] @ q
        P = XPR @ diff_rayleigh_ortho
        normP = _norms(P)
        P = P / torch.where(normP == 0, 1.0, normP)

        # new residuals
        AX = A(X)
        R = AX - theta_all[None, :k] * X
        resid_norms = torch.linalg.vector_norm(R, dim=0)

        # convergence by self-consistency of the eigenpair: the residual
        # against the floating-point error of computing it
        reltol = torch.linalg.vector_norm(AX, dim=0) + theta_all[:k]
        reltol = reltol * n
        reltol = reltol * 10
        converged = int(torch.sum(resid_norms < tol * reltol))

        i += 1
        theta = theta_all[None, :k]

    return theta[0, :], X, i


# -- the solver ----------------------------------------------------------------

def _norm_estimate(matvec: Callable, n: int, device, iters: int = 20,
                   seed: int = 3) -> float:
    """Power-iteration estimate of ‖H‖₂ (upper-bounded by ×1.05)."""
    v = torch.from_numpy(
        np.random.default_rng(seed).standard_normal(n)).to(device)
    v = v / torch.linalg.vector_norm(v)
    lam = 0.0
    for _ in range(iters):
        w = matvec(v)
        if isinstance(w, tuple):
            w = w[0]
        lam = float(torch.linalg.vector_norm(w))
        v = w / lam
    return 1.05 * lam


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def lobpcg(matvec: Callable, n: int, k: int = 1, max_iters: int = 200,
           tol: float = 1e-9, seed: int = 0, X0=None,
           checkpoint_path: Optional[str] = None, device=None
           ) -> Tuple[np.ndarray, torch.Tensor, int]:
    """Lowest-``k`` eigenpairs via spectrum-flipped LOBPCG.

    Returns (eigenvalues [k] ascending, eigenvectors [n, k] in block
    order as a tensor on the solve's device, iterations).  ``matvec`` may
    be a ``LocalEngine``'s (``[n, m]`` blocks) or the streamed engine's
    (hashed ``[1, M, m]`` blocks, through the flat hashed space).  ``X0``
    is the start block: ``[n, k]`` for a local solve, up to k warm-start
    columns ``[n, j]`` (the rest random) for the streamed engine.

    ``tol`` is ``lobpcg_standard``'s: relative to ``10·n·(λ + |Av|)``, so
    large sectors need a smaller one for the same eigenvalue accuracy.
    ``checkpoint_path`` is not supported yet and raises
    ``NotImplementedError``.  ``device`` defaults to the streamed engine's
    device, else to the device of a tensor ``X0``, else to ``cuda``
    (raising when there is none).  A rank engine raises
    ``NotImplementedError``.
    """
    refuse_checkpoint(checkpoint_path)
    refuse_rank_engine(matvec, "lobpcg")
    owner = getattr(matvec, "__self__", None)
    if owner is not None and _complex_native(owner):
        raise ValueError(
            "lobpcg runs real sectors only (the JAX solver's (re, im) "
            "pair form is not ported); use lanczos or lanczos_block for a "
            "complex sector")
    dist = owner is not None and hasattr(owner, "from_hashed")
    dev = owner.device if dist and device is None \
        else start_device(X0, device)

    def raw_mv(x):
        y = matvec(x)
        return y[0] if isinstance(y, tuple) else y

    def run_flipped(mv, dim_, U0):
        """σ estimate, spectrum-flipped LOBPCG, ascending (evals, columns,
        iterations)."""
        sigma = _norm_estimate(mv, dim_, dev)

        def flip(X):
            return sigma * X - mv(X)

        U0q, _ = np.linalg.qr(_host(U0))
        X = torch.from_numpy(U0q).to(dev)
        theta, U, it = _lobpcg_standard(flip, X, m=max_iters, tol=tol)
        evals = sigma - theta.cpu().numpy()
        order = np.argsort(evals)
        return evals[order], U[:, torch.from_numpy(order).to(dev)], int(it)

    if not dist:
        if X0 is None:
            X0 = np.random.default_rng(seed).standard_normal((n, k))
        return run_flipped(raw_mv, n, X0)

    # -- hashed flat space adapters ------------------------------------
    D, M = owner.n_devices, owner.shard_size

    def to_flat(Xh):
        return Xh.reshape(D * M, Xh.shape[2])

    def from_flat(U):
        return U.reshape(D, M, U.shape[1])

    def mv_flat(U):
        if U.dim() == 1:                       # norm-estimate probe
            return mv_flat(U[:, None])[:, 0]
        return to_flat(raw_mv(from_flat(U)))

    rng = np.random.default_rng(seed)
    Xb = rng.standard_normal((n, k))
    if X0 is not None:
        W = _host(X0)
        if W.ndim != 2 or W.shape[0] != n or W.shape[1] > k:
            raise ValueError(
                f"X0 must be [n, j] with j <= k={k}, got {W.shape}")
        Xb[:, : W.shape[1]] = W
    evals, U, iters = run_flipped(mv_flat, D * M,
                                  to_flat(owner.to_hashed(Xb)))
    V = owner.from_hashed(from_flat(U))               # [n, k] block order
    return evals, torch.from_numpy(V).to(dev), iters
