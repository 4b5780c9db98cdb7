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

For the hash-sharded engine the whole iteration runs in the engine's
hashed space: block columns are flat ``[D·M, m]`` views of the hashed
layout and every matvec is one multi-column apply.  Pad slots start at
zero (``to_hashed`` zero-fills) and stay zero — H maps them to 0 and every
LOBPCG update is a linear combination — so the flat space behaves as the
n-dimensional physical one.  Eigenvectors come back in block (sorted)
order.

On a rank engine (one shard per process) each rank holds its ``[M, m]``
rows of the flat space (:class:`_Rows`): every Gram matrix, column norm
and column sum is all-reduced, so the small projected problems are the
same bits on every rank; the start block and the norm estimate's vector
are drawn whole on every rank, which keeps its rows; and the basis
extension gathers the few leading rows of the global space it reads.

Real sectors only (the JAX solver's (re, im) pair form is not ported);
checkpoint/resume is not in the port.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..models.observables import _complex_native
from ..utils.device import start_device
from .lanczos import rank_owner, refuse_checkpoint

__all__ = ["lobpcg"]


# -- where the rows live -------------------------------------------------------

class _Rows:
    """The rows of the iteration's ``[n, ·]`` blocks held here: all ``n``
    of them (``red`` None), or ``n_local`` rows from global row ``row0``
    on, with ``red`` summing a tensor over the ranks and ``gather``
    stacking one from every rank (``[W, …]``, rank order)."""

    def __init__(self, n: int, n_local: Optional[int] = None, red=None,
                 gather=None, row0: int = 0):
        self.n = n
        self.n_local = n if n_local is None else n_local
        self.red, self.gather, self.row0 = red, gather, row0

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.red is None else self.red(t)

    def dot(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        """``AᵀB`` over the global rows."""
        return self._sum(A.T @ B)

    def col_sums(self, X: torch.Tensor) -> torch.Tensor:
        """Column sums, ``[1, k]``."""
        return self._sum(torch.sum(X, dim=0, keepdim=True))

    def norms(self, X: torch.Tensor) -> torch.Tensor:
        """Column 2-norms, ``[1, k]`` (the 2-norm of a vector)."""
        if self.red is None:
            return torch.linalg.vector_norm(X, dim=0, keepdim=X.dim() > 1)
        return torch.sqrt(self.red(torch.sum(X * X, dim=0,
                                             keepdim=X.dim() > 1)))

    def head(self, X: torch.Tensor, r: int) -> torch.Tensor:
        """The global rows ``[0, r)`` of ``X``, on every rank: rank q
        holds global rows ``q·n_local …``, so every rank's first
        ``min(n_local, r)`` rows are gathered and the leading r picked."""
        if self.gather is None:
            return X[:r]
        M = self.n_local
        G = self.gather(X[:min(M, r)].contiguous())
        g = torch.arange(r, device=X.device)
        return G[g // M, g % M]

    def local_rows(self, X: np.ndarray) -> np.ndarray:
        """This rank's rows of a global ``[n, …]`` host array."""
        return X[self.row0:self.row0 + self.n_local]


# -- the LOBPCG iteration (translated from jax.experimental.sparse.linalg) ---


def _eigh_ascending(A):
    # (the name is JAX's; the order it returns is descending)
    w, V = torch.linalg.eigh(A)
    return w.flip(0), V.flip(1)


def _svqb(X, rows: _Rows):
    """Derives a truncated orthonormal basis for ``X``: SVQB squares the
    matrix ``C = XᵀX`` and orthonormalizes through its eigenbasis;
    directions whose eigenvalue falls below ``eps·max`` are zeroed out."""
    norms = rows.norms(X)
    X = X / torch.where(norms == 0, 1.0, norms)

    inner = rows.dot(X, X)

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
    norms = rows.norms(orthoX)
    keep = keep & (norms > 0.0)
    orthoX = orthoX / torch.where(keep, norms, 1.0)
    return orthoX


def _project_out(basis, U, rows: _Rows):
    """The component of ``U`` in the orthogonal complement of the
    orthonormal (zero columns allowed) ``basis``, orthonormalized, with
    suspicious columns zeroed: orthogonality to ``basis`` is favoured over
    the rank of ``U`` ("twice is enough", Kahan / Parlett §6.9)."""
    for _ in range(2):
        U = U - basis @ rows.dot(basis, U)
        U = _orthonormalize(U, rows)

    # it is crucial to end on a subtraction of the original basis: near
    # convergence the orthonormalization can reintroduce (X, P) components
    for _ in range(2):
        U = U - basis @ rows.dot(basis, U)
    normU = rows.norms(U)
    U = U * (normU >= 0.99).to(U.dtype)
    return U


def _orthonormalize(basis, rows: _Rows):
    # twice is enough, again
    for _ in range(2):
        basis = _svqb(basis, rows)
    return basis


def _rayleigh_ritz_orth(A, S, rows: _Rows):
    """Eigenpairs of ``A`` projected onto the orthonormal (zero columns
    allowed) subspace ``S``, in descending order."""
    SAS = rows.dot(S, A(S))
    return _eigh_ascending(SAS)


def _extend_basis(X, m, rows: _Rows):
    """Extend the orthonormal ``X`` [n, k] by ``m`` orthonormal columns,
    through block Householder reflectors (deterministic, and never
    overlapping ``X``).  Only the global rows ``[0, k + m)`` enter the
    small algebra (on ranks they are gathered, and every rank computes it
    from the same bits); the rest is row by row."""
    n_loc, k = X.shape
    u, s, vt = torch.linalg.svd(rows.head(X, k))
    g = rows.row0 + torch.arange(n_loc, device=X.device)   # global rows

    # adding U Vᵀ to Xupper lifts its singular values by 1
    up = g < k
    y = X.clone()
    y[up] = X[up] + (u @ vt)[g[up]]

    # H(w) = I − 2 w wᵀ with 2 w wᵀ = y (v diag(1+s)^(-1) vᵀ) yᵀ maps
    # vstack(0, eye(n − k)) onto an orthogonal extension of X; of wᵀ's
    # product with vstack(eye(m), 0) only w's rows k … k+m−1 remain
    w = y @ (vt.T * ((2 * (1 + s)) ** (-1 / 2))[None, :])
    h = -2 * (w @ rows.head(w, k + m)[k:].T)
    mid = (g >= k) & (g < k + m)
    h[mid, g[mid] - k] += 1
    return h


def _check_inputs(A, X, rows: _Rows):
    n, k = rows.n, X.shape[1]
    dt = X.dtype

    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")

    if k * 5 >= n:
        raise ValueError(
            f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")

    n_loc = rows.n_local
    test_output = A(torch.zeros((n_loc, 1), dtype=X.dtype, device=X.device))

    if test_output.dtype != dt:
        raise ValueError(
            f"A, X must have same dtypes (were {test_output.dtype}, {dt})")

    if tuple(test_output.shape) != (n_loc, 1):
        s = tuple(test_output.shape)
        raise ValueError(f"A must be ({n}, {n}) matrix A, got output {s}")


def _lobpcg_standard(A: Callable, X: torch.Tensor, m: int,
                     tol: Optional[float] = None,
                     rows: Optional[_Rows] = None):
    """Top-``k`` eigenpairs of the Hermitian operator ``A`` from the start
    block ``X`` [n, k] (``5k < n``): ``(theta [k], U [n, k], iterations)``.
    ``rows`` says where the rows of ``X`` live (default: all here).

    An eigenpair converges when its residual ``|A v − λ v|`` is below
    ``tol · 10 · n · (λ + |A v|)``; the iteration stops when all k have,
    or after ``m`` iterations.  ``tol`` defaults to the dtype's epsilon.
    """
    rows = rows or _Rows(X.shape[0])
    n, k = rows.n, X.shape[1]
    _check_inputs(A, X, rows)

    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)

    X = _orthonormalize(X, rows)
    P = _extend_basis(X, X.shape[1], rows)

    # X: the current best eigenvectors, P: the search direction, R: the
    # residuals, kept orthonormal (R and P columns may be 0 after basis
    # truncation, X columns never)
    AX = A(X)
    theta = rows.col_sums(X * AX)
    R = AX - theta * X

    i = 0
    converged = 0
    while i < m and converged < k:
        # residual basis selection
        R = _project_out(torch.cat((X, P), dim=1), R, rows)
        XPR = torch.cat((X, P, R), dim=1)

        # projected eigensolve
        theta_all, Q = _rayleigh_ritz_orth(A, XPR, rows)

        # eigenvector X extraction
        B = Q[:, :k]
        B = B / torch.linalg.vector_norm(B, dim=0, keepdim=True)
        X = XPR @ B
        X = X / rows.norms(X)

        # difference terms P: concat(0, Q[k:, :k]) orthogonalized against
        # Q[:, :k] in the standard basis before mapping with XPR, so the
        # directions come out orthonormal
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        diff_rayleigh_ortho = Q[:, k:] @ q
        P = XPR @ diff_rayleigh_ortho
        normP = rows.norms(P)
        P = P / torch.where(normP == 0, 1.0, normP)

        # new residuals
        AX = A(X)
        R = AX - theta_all[None, :k] * X
        resid_norms = rows.norms(R)[0]

        # convergence by self-consistency of the eigenpair: the residual
        # against the floating-point error of computing it
        reltol = rows.norms(AX)[0] + theta_all[:k]
        reltol = reltol * n
        reltol = reltol * 10
        converged = int(torch.sum(resid_norms < tol * reltol))

        i += 1
        theta = theta_all[None, :k]

    return theta[0, :], X, i


# -- the solver ----------------------------------------------------------------

def _norm_estimate(matvec: Callable, rows: _Rows, device, iters: int = 20,
                   seed: int = 3) -> float:
    """Power-iteration estimate of ‖H‖₂ (upper-bounded by ×1.05), from a
    vector drawn whole (this rank keeping its rows)."""
    v = torch.from_numpy(rows.local_rows(
        np.random.default_rng(seed).standard_normal(rows.n))).to(device)
    v = v / rows.norms(v)
    lam = 0.0
    for _ in range(iters):
        w = matvec(v)
        if isinstance(w, tuple):
            w = w[0]
        lam = float(rows.norms(w))
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
    be a ``LocalEngine``'s (``[n, m]`` blocks) or a ``DistributedEngine``'s
    (hashed ``[D, M, m]`` blocks, through the flat hashed space; on a rank
    engine this rank's ``[1, M, m]``, every rank calling together).
    ``X0`` is the start block: ``[n, k]`` for a local solve, up to k
    warm-start columns ``[n, j]`` (the rest random) for a
    ``DistributedEngine``.

    ``tol`` is ``lobpcg_standard``'s: relative to ``10·n·(λ + |Av|)``, so
    large sectors need a smaller one for the same eigenvalue accuracy.
    ``checkpoint_path`` is not supported yet and raises
    ``NotImplementedError``.  ``device`` defaults to the engine's device
    for a ``DistributedEngine``, else to the device of a tensor ``X0``,
    else to ``cuda`` (raising when there is none).
    """
    refuse_checkpoint(checkpoint_path)
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

    def run_flipped(mv, X, rows):
        """σ estimate, spectrum-flipped LOBPCG from the orthonormal start
        ``X`` (this process's rows), ascending (evals, columns,
        iterations)."""
        sigma = _norm_estimate(mv, rows, dev)

        def flip(X):
            return sigma * X - mv(X)

        theta, U, it = _lobpcg_standard(flip, X, m=max_iters, tol=tol,
                                        rows=rows)
        evals = sigma - theta.cpu().numpy()
        order = np.argsort(evals)
        return evals[order], U[:, torch.from_numpy(order).to(dev)], int(it)

    if not dist:
        if X0 is None:
            X0 = np.random.default_rng(seed).standard_normal((n, k))
        U0q, _ = np.linalg.qr(_host(X0))
        return run_flipped(raw_mv, torch.from_numpy(U0q).to(dev), _Rows(n))

    # -- hashed flat space adapters ------------------------------------
    D, M = owner.n_devices, owner.shard_size
    ranks = rank_owner(matvec)
    lead = 1 if ranks is not None else D         # hashed rows held here
    rows = _Rows(D * M) if ranks is None else _Rows(
        D * M, M, red=ranks.reduce_sum, gather=ranks.group.all_gather,
        row0=ranks.group.rank * M)

    def mv_flat(U):
        if U.dim() == 1:                       # norm-estimate probe
            return mv_flat(U[:, None])[:, 0]
        return raw_mv(U.reshape(lead, M, U.shape[1])).reshape(
            lead * M, U.shape[1])

    rng = np.random.default_rng(seed)
    Xb = rng.standard_normal((n, k))
    if X0 is not None:
        W = _host(X0)
        if W.ndim != 2 or W.shape[0] != n or W.shape[1] > k:
            raise ValueError(
                f"X0 must be [n, j] with j <= k={k}, got {W.shape}")
        Xb[:, : W.shape[1]] = W
    # the whole hashed start block on every rank: a hashed layout is a row
    # permutation plus zero pad, so its QR is the block's, and each rank
    # keeps its rows of Q
    U0q, _ = np.linalg.qr(owner.layout.to_hashed(Xb, fill=0).reshape(
        D * M, k))
    evals, U, iters = run_flipped(
        mv_flat, torch.from_numpy(rows.local_rows(U0q)).to(dev), rows)
    V = owner.from_hashed(U.reshape(lead, M, k))       # [n, k] block order
    return evals, torch.from_numpy(V).to(dev), iters
