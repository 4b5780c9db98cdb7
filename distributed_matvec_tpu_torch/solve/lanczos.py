# Ported from distributed_matvec_tpu/solve/lanczos.py (lanczos, lanczos_block, _OmegaTracker).
"""Thick-restart Lanczos eigensolvers over a matvec closure.

PyTorch counterpart of ``distributed_matvec_tpu/solve/lanczos.py``.

:func:`lanczos` is the single-vector solver.  The Krylov basis lives in a
fixed ``[rows, N]`` buffer on the device; each iteration is one matvec, the
reorthogonalization and the (α, β) recurrence, all on the device.  The host
syncs the small (α, β) arrays every ``check_every`` steps for the
convergence test.  Memory is bounded by thick restarting (TRLan): when the
basis reaches ``max_basis_size`` the ``min_restart_size`` lowest Ritz
vectors are kept with the last residual vector, and the projected matrix
becomes arrowhead-plus-tridiagonal.  Reorthogonalization is ``"full"`` (two
passes of blocked modified Gram-Schmidt against every live row) or
``"selective"`` (the default, as in the JAX package): each step projects
only against a window of the last few rows while the accumulated
ω-recurrence estimate of orthogonality loss (:class:`_OmegaTracker`) stays
below √ε; a block that crosses it is discarded and redone with the full
sweep.

:func:`lanczos_block` is the block solver: each step applies H to a whole
``[n, p]`` block in one engine call, with full reorthogonalization, QR
between steps, thick restarts and per-target column exits.  It drives the
streamed engine through its ``[1, M, p]`` multi-column apply, which streams
each plan chunk once per block (in column groups of 4 beyond four).

Vectors are whatever ``matvec`` takes and returns (``[1, M]`` hashed for the
streamed engine); padded slots are zero by engine invariant, so the dots
are exact.  They are float64, or complex128 for a complex-Hermitian
operator: Gram-Schmidt and the norms then use conjugated inner products,
and the projected matrix stays real symmetric.  Each solve is one
``solve`` span with an ``iteration`` span per check block (the engine
applies nest inside as ``apply`` spans), registers its Krylov workspace in
the memory ledger, and runs the JAX package's watchdog (:class:`_Watchdog`:
orthogonality loss from the ω estimate, a nonfinite residual, Ritz
stagnation, an unconverged β breakdown) as ``solver_health`` events through
``obs/health.py``.  Every block boundary is the ``solver_block`` fault site
(``utils/faults.py``) beside the preemption safe point.  Checkpointing and
the (re, im) pair form of the JAX solvers are not in the port.

The solvers find the engine behind ``matvec`` through
:func:`engine_owner` (the bound method's ``__self__``), which gives them a
rank engine's sum over ranks and a quantized tier's reorthogonalization
rule.  A wrapped matvec hides the engine, so every solver checks its first
apply against the engine that ran it (:func:`guard_engine`, reading
``parallel/engine_obs.APPLYING``): a rank engine or an ``f32``/``bf16``
streamed or hybrid engine it was not given raises ``ValueError`` — on every
rank alike, after that one apply — instead of returning a wrong value.

On a rank engine (``DistributedEngine(group=…)``, one shard per process)
each rank holds its row of every vector, and every dot and norm is summed
through the engine's all-reduce (:func:`rank_reducer`): the reduced
scalars are the same bits on every rank, so the host-side projections and
every branch of the recurrence agree across the ranks.  ``lanczos_block``
reduces its block inner products the same way, and QRs its ``[M, p]`` row
blocks by TSQR (:func:`_tsqr`), whose small factor every rank computes
from the same gathered bits.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from scipy.linalg import eigh

from ..obs import health as obs_health
from ..obs import memory as obs_memory
from ..obs import trace as obs_trace
from ..obs.events import emit as obs_emit
from ..obs.events import obs_enabled
from ..parallel.engine_obs import APPLYING
from ..utils import faults, preempt
from ..utils.config import get_config
from ..utils.device import start_device

__all__ = ["LanczosResult", "lanczos", "lanczos_block", "rank_reducer",
           "engine_owner", "guard_engine"]

# the ledger handles of the solve in progress (see ``solve_scope``)
_WORKSPACES: contextvars.ContextVar = contextvars.ContextVar(
    "dmt_solve_workspaces", default=None)

# Gram-Schmidt visits the basis in blocks of this many rows
_GS_BLOCK = 8

# Selective reorthogonalization: the trailing window a step projects
# against (the recurrence pair plus two rows of slack), and the ω level at
# which a window block is redone with the full sweep — √ε, Simon's
# semiorthogonality bound (the JAX package's ``OMEGA_WARN``)
_W_ROWS = 4
_OMEGA_SQRT_EPS = 1e-8

_NO_CHECKPOINT = ("checkpoint_path: solver checkpoint/resume writes HDF5 and "
                  "is not in the port yet (it comes with the CLI slice: "
                  "apps and io/hdf5.py)")


def engine_owner(matvec: Callable):
    """The object ``matvec`` is a bound method of (the engine, for
    ``eng.matvec``), or None for any other callable."""
    return getattr(matvec, "__self__", None)


def quantized_engine(eng) -> bool:
    """Whether ``eng`` is a streamed or hybrid engine with quantized
    (``f32``/``bf16``) coefficients: Hermitian only to that rounding."""
    return (getattr(eng, "mode", None) in ("streamed", "hybrid")
            and getattr(eng, "stream_compress", None) in ("f32", "bf16"))


def guard_engine(matvec: Callable, solver: str) -> Callable:
    """``matvec``, checked at its first call against the engine whose apply
    ran (the engines name themselves in the list it opens in
    ``APPLYING`` for that call only): when that is a rank
    engine or a quantized streamed/hybrid engine other than
    :func:`engine_owner` of ``matvec``, the solver could not see it — it
    would sum over this rank's shard only, or skip the quantized tier's
    full reorthogonalization — so the call raises ``ValueError``.  Every
    rank makes the same first apply and raises alike; no collective is
    left waiting."""
    owner = engine_owner(matvec)
    checked = []

    def run(*args, **kwargs):
        if checked:
            return matvec(*args, **kwargs)
        box = []
        tok = APPLYING.set(box)
        try:
            y = matvec(*args, **kwargs)
        finally:
            APPLYING.reset(tok)
        checked.append(True)
        hidden = [e for e in box if e is not owner and (
            getattr(e, "group", None) is not None or quantized_engine(e))]
        del box
        if hidden:
            ran = hidden[0]
            what = (f"a rank engine (world size {ran.group.world_size})"
                    if getattr(ran, "group", None) is not None
                    else f"a stream_compress={ran.stream_compress!r} "
                         f"{ran.mode} engine")
            raise ValueError(
                f"{solver}: the matvec ran {type(ran).__name__} "
                f"(mode={ran.mode!r}), {what}, through a wrapper the solver "
                "cannot see the engine behind — pass the bound eng.matvec "
                "(the solver then sums over the ranks and takes the "
                "quantized tier's reorthogonalization)")
        return y

    return run


@contextlib.contextmanager
def solve_scope(name: str, **attrs):
    """One ``solve`` span (JAX ``obs_trace.span(name, kind="solve", …)``).
    The workspaces that :func:`track_workspace` registers inside it are
    released when it closes, however the solve ends: a raise
    (``Preempted``, an injected fault, ``HealthError``, an OOM) leaves no
    entry in the ledger."""
    handles = []
    tok = _WORKSPACES.set(handles)
    try:
        with obs_trace.span(name, kind="solve", **attrs):
            yield
    finally:
        _WORKSPACES.reset(tok)
        for h in handles:
            h.release()


def solve_span(name: str, k_arg: bool = True):
    """Run the decorated solver inside one :func:`solve_scope`; ``k`` is
    read from the call as the JAX wrappers read it (the second positional
    argument after ``matvec``, or the keyword)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(matvec, *args, **kwargs):
            attrs = {}
            if k_arg:
                attrs["k"] = int(kwargs.get("k", args[1] if len(args) > 1
                                            else 1))
            with solve_scope(name, **attrs):
                return fn(matvec, *args, **kwargs)
        return wrapped
    return deco


def track_workspace(solver: str, name: str, nbytes: int, **meta):
    """Register a solve's workspace in the memory ledger as
    ``solver/<solver>:<i>/<name>`` (the JAX paths); returns the handle the
    solver releases where JAX does.  The enclosing :func:`solve_scope`
    releases it too, so a solve that raises leaves no entry behind."""
    if not obs_enabled():
        return obs_memory.NULL_HANDLE
    h = obs_memory.track(
        f"solver/{obs_memory.next_instance(solver)}/{name}", int(nbytes),
        **meta)
    scope = _WORKSPACES.get()
    if scope is not None:
        scope.append(h)
    return h


def rank_owner(matvec: Callable):
    """The rank engine behind ``matvec`` (``DistributedEngine(group=…)``),
    or None."""
    owner = engine_owner(matvec)
    return owner if getattr(owner, "group", None) is not None else None


def rank_reducer(matvec: Callable) -> Optional[Callable]:
    """The sum over ranks of the rank engine behind ``matvec``, or None
    when the engine holds every shard itself and a local dot is already
    whole."""
    owner = rank_owner(matvec)
    return None if owner is None else owner.reduce_sum


def _tsqr(X: torch.Tensor, group) -> tuple:
    """Reduced QR of the ``[n, p]`` block whose rows lie one ``[M, p]``
    block per rank of ``group``, in rank order (TSQR): each rank QRs its
    rows, the W small R factors are all-gathered, every rank QRs the
    stacked ``[W·r, p]`` on the host from the same bits, and Q is this
    rank's rows times its slice.  R's diagonal is made real and
    non-negative (Q's columns scaled to match), so R is the same bits on
    every rank.  Householder twice over: as stable as one QR of the
    whole block."""
    Q1, R1 = torch.linalg.qr(X)                  # [M, r], [r, p]
    Rs = group.all_gather(R1).cpu().numpy()      # [W, r, p]
    W, r, p = Rs.shape
    Q2, R = np.linalg.qr(Rs.reshape(W * r, p))
    d = np.diag(R)
    ph = np.where(d == 0, 1.0, d / np.where(d == 0, 1.0, np.abs(d)))
    Q2 = Q2 * ph[None, :]
    R = ph.conj()[:, None] * R
    i = group.rank
    Q = Q1 @ torch.from_numpy(np.ascontiguousarray(
        Q2[i * r:(i + 1) * r])).to(X.device, X.dtype)
    return Q, torch.from_numpy(R).to(X.device, X.dtype)


def refuse_checkpoint(checkpoint_path) -> None:
    """Raise ``NotImplementedError`` for a checkpoint path: the port's
    solvers do not checkpoint yet."""
    if checkpoint_path is not None:
        raise NotImplementedError(_NO_CHECKPOINT)


class _Watchdog:
    """Per-solve health state: Ritz-stagnation tracking plus the ω and
    breakdown checks, reported as ``solver_health`` events through
    :mod:`obs.health` (warn = log only; critical = one ``[Warn]`` line,
    or a :class:`~obs.health.HealthError` under ``DMT_HEALTH=strict``)."""

    #: consecutive convergence checks without a ≥1% residual improvement
    #: before a stagnation warning (restart plateaus are normal — one flat
    #: check is not a stall)
    STALL_CHECKS = 5

    def __init__(self, solver: str):
        self.solver = solver
        self.best_res = np.inf
        self.stalled = 0

    def report_omega(self, omega: Optional[float], it: int) -> None:
        """Threshold a precomputed ω estimate.  Called only on checks that
        did NOT converge: a solve that just met its tolerance must not be
        failed (strict mode) by the same tiny β that delivered it."""
        if omega is None or not obs_health.probes_enabled():
            return
        if omega >= obs_health.OMEGA_CRITICAL:
            obs_health.record("orthogonality_loss", "critical",
                              solver=self.solver, iter=int(it),
                              omega=float(omega))
        elif omega >= obs_health.OMEGA_WARN:
            obs_health.record("orthogonality_loss", "warn",
                              solver=self.solver, iter=int(it),
                              omega=float(omega))

    def check_stagnation(self, res, it: int) -> None:
        if not obs_health.probes_enabled():
            return
        cur = float(np.max(np.atleast_1d(res)))
        if not np.isfinite(cur):
            obs_health.record("nonfinite_residual", "critical",
                              solver=self.solver, iter=int(it), residual=cur)
            return
        if cur < 0.99 * self.best_res:
            self.best_res = cur
            self.stalled = 0
            return
        self.stalled += 1
        if self.stalled >= self.STALL_CHECKS:
            obs_health.record("ritz_stagnation", "warn", solver=self.solver,
                              iter=int(it), residual=cur,
                              checks_without_progress=self.stalled)
            self.stalled = 0

    def breakdown(self, it: int, beta: float, converged: bool) -> None:
        """β-breakdown: the Krylov space closed.  Converged closure is the
        happy path (exact invariant subspace — no event); an UNCONVERGED
        breakdown means the solve cannot reach the tolerance and is
        critical."""
        if not obs_health.probes_enabled() or converged:
            return
        obs_health.record("beta_breakdown", "critical", solver=self.solver,
                          iter=int(it), beta=float(beta))


class _OmegaTracker:
    """Accumulated ω-recurrence (Paige/Simon) across selective-reorth blocks.

    Tracks the table ω_{j,i} ≈ |⟨v_j, v_i⟩| across iterations that ran
    with window-only reorthogonalization, so the host loop can escalate to
    a full sweep *before* semiorthogonality (max ω ≤ √ε, Simon '84) is
    lost.  A full-reorth block (or a thick restart, which rebuilds the
    basis from Ritz combinations) resets the table to roundoff via
    :meth:`reset`.
    """

    def __init__(self, eps: float = 2.0 ** -52):
        self.eps = eps
        self.reset(0)

    def reset(self, m: int) -> None:
        self.m = int(m)
        # w_curr[i] = ω_{m,i} for i <= m (1 on the diagonal); w_prev the
        # m-1 row.  Baseline ε: the basis was just (re)orthogonalized.
        # w_prev's own diagonal (ω_{m-1,m-1} = 1) matters: the recurrence's
        # −β_{j−1}·ω_{j−1,i} term must cancel the β_{i}·ω_{j,i+1} term at
        # i = j−1, and an ε there instead of 1 leaves an O(1) residue that
        # falsely trips the √ε gate on the first window block after every
        # full sweep.
        self.w_curr = np.full(self.m + 1, self.eps)
        self.w_curr[-1] = 1.0
        self.w_prev = np.full(max(self.m, 1), self.eps)
        if self.m >= 1:
            self.w_prev[-1] = 1.0

    def advance(self, alph: np.ndarray, bet: np.ndarray, m_new: int
                ) -> float:
        """Evolve the table through steps ``self.m .. m_new-1`` using the
        recorded (α, β) and return the max off-pair estimate at m_new.

        Signed arithmetic, exactly the Paige recurrence: an absolute-value
        upper bound compounds ~(Σβ)/β per step and saturates √ε within one
        block; the signed form keeps the cancellation that makes real loss
        grow only as Ritz pairs converge.
        """
        a = np.asarray(alph, np.float64)
        b = np.asarray(bet, np.float64)
        worst = 0.0
        for j in range(self.m, int(m_new)):
            bj = max(float(b[j]), 1e-300)
            w, wp = self.w_curr, self.w_prev
            new = np.empty(j + 2)
            if j:
                i = np.arange(j)
                up = b[i] * w[i + 1]
                mid = (a[i] - a[j]) * w[i]
                dn = np.zeros(j)
                dn[1:] = b[i[1:] - 1] * w[i[1:] - 1]
                back = b[j - 1] * wp[i]
                # ϑ ≈ ε(β_i + β_j): the local roundoff injected per step
                new[:j] = (up + mid + dn - back
                           + self.eps * (b[i] + bj)) / bj
            new[j] = self.eps          # fresh adjacent pair (ψ term)
            new[j + 1] = 1.0
            self.w_prev = w
            self.w_curr = new
            if j:
                worst = max(worst, float(np.max(np.abs(new[:j]))))
        self.m = int(m_new)
        return worst


@dataclass
class LanczosResult:
    eigenvalues: np.ndarray          # [k] ascending
    eigenvectors: Optional[list]     # k vectors in the matvec's layout
    residual_norms: np.ndarray       # [k] |β_m · s_last| bound
    num_iters: int
    converged: bool
    #: thick (memory-bounding) restarts taken by a ``max_basis_size``-
    #: capped ``lanczos_block`` solve (narrowing restarts not counted)
    restarts: int = 0
    #: blocks of ``check_every`` steps that ran the full Gram-Schmidt
    #: sweep (every block under ``reorth="full"``; under ``"selective"``
    #: the first block after a restart, short remainders, and window
    #: blocks redone because ω crossed √ε)
    full_sweeps: int = 0
    #: per-target results of a ``column_targets`` batch solve, aligned
    #: with the targets list; None for ordinary solves
    column_results: Optional[list] = None


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


def _vdot(a: torch.Tensor, b: torch.Tensor, red=None) -> torch.Tensor:
    """⟨a, b⟩ over every axis (``a`` conjugated), a 0-d tensor; ``red``
    sums it over the ranks."""
    v = torch.vdot(a.reshape(-1), b.reshape(-1))
    return v if red is None else red(v)


def _re_dot(a: torch.Tensor, b: torch.Tensor, red=None) -> torch.Tensor:
    """Re ⟨a, b⟩ (``a`` conjugated)."""
    v = torch.vdot(a, b).real if a.is_complex() else torch.dot(a, b)
    return v if red is None else red(v)


def _norm(w: torch.Tensor, red=None) -> torch.Tensor:
    """‖w‖, a 0-d tensor."""
    if red is None:
        return torch.linalg.vector_norm(w)
    return torch.sqrt(red(torch.vdot(w.reshape(-1), w.reshape(-1)).real))


def _project(w: torch.Tensor, Vb: torch.Tensor, red=None) -> torch.Tensor:
    """``w`` less its projection on the rows of ``Vb``."""
    if red is None:
        return w - (Vb.conj() @ w) @ Vb
    return w - red(Vb.conj() @ w) @ Vb


def _mgs_pass(w: torch.Tensor, V: torch.Tensor, m: int,
              red=None) -> torch.Tensor:
    """One blocked modified Gram-Schmidt pass of ``w`` against rows
    ``V[0..m]``."""
    for r0 in range(0, m + 1, _GS_BLOCK):
        w = _project(w, V[r0:min(r0 + _GS_BLOCK, m + 1)], red)
    return w


def _store_step(V, alph, bet, m, a, w, red=None) -> torch.Tensor:
    """β = ‖w‖, V[m+1] = w/β, and (α, β) into step ``m``; returns the new
    row."""
    b = _norm(w, red)
    V[m + 1] = w / torch.where(b <= 1e-300, torch.ones_like(b), b)
    alph[m] = a
    bet[m] = b
    return V[m + 1]


def _run_steps(mv, V, alph, bet, m0: int, nsteps: int, red=None) -> None:
    """Advance the recurrence by ``nsteps`` iterations in place, with two
    full Gram-Schmidt passes per step: V[m+1], α[m], β[m] for
    m = m0 .. m0+nsteps−1.  No host sync."""
    for m in range(m0, m0 + nsteps):
        vm = V[m]
        w = mv(vm)
        a = _re_dot(vm, w, red)
        for _ in range(2):
            w = _mgs_pass(w, V, m, red)
        _store_step(V, alph, bet, m, a, w, red)


def _run_window(mv, V, alph, bet, m0: int, nsteps: int, red=None) -> None:
    """Like :func:`_run_steps`, but each step makes one projection pass
    against the trailing ``_W_ROWS`` rows only (the selective policy).
    Writes only rows above ``m0``, so a block can be redone with the full
    sweep from the same state."""
    r0 = max(m0 - (_W_ROWS - 1), 0)
    W = V[r0:r0 + _W_ROWS].clone()
    # rows above m0 can be stale (a short thick restart leaves old basis
    # rows beyond l): zero them, zero rows project to nothing; then roll
    # so v_{m0} sits in the last row
    W[m0 - r0 + 1:] = 0
    W = torch.roll(W, (_W_ROWS - 1) - (m0 - r0), dims=0)
    for m in range(m0, m0 + nsteps):
        vm = W[-1]
        w = mv(vm)
        a = _re_dot(vm, w, red)
        w = _project(w, W, red)
        vnew = _store_step(V, alph, bet, m, a, w, red)
        W = torch.cat([W[1:], vnew[None]])


@solve_span("lanczos")
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
    reorth: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> LanczosResult:
    """Lowest-``k`` eigenpairs of the Hermitian operator behind ``matvec``.

    ``v0`` (or ``n`` + ``seed``) fixes the start vector; convergence is the
    residual bound ``|β_m s_m,i| < tol·max(1,|θ_i|)`` for the k lowest Ritz
    pairs.  ``max_basis_size``/``min_restart_size`` bound the device
    memory at ``max_basis_size+1`` vectors via thick restarts.

    ``reorth`` is ``"selective"`` (window passes gated by the ω estimate,
    redone with the full sweep when it crosses √ε; the first block after a
    restart and remainders shorter than half a block are always full) or
    ``"full"`` (two full passes every step); None takes the config's
    ``lanczos_reorth`` (``DMT_LANCZOS_REORTH``, default selective).
    ``checkpoint_path`` is not supported yet and raises
    ``NotImplementedError``.  A set preemption latch stops the solve after
    the next convergence-check block with ``Preempted("lanczos", iters,
    None)``.

    ``device`` defaults to the device of ``v0`` when that is a tensor, else
    to ``cuda``, raising when there is none.  The vectors are ``dtype``
    (``torch.float64`` or ``torch.complex128``); by default complex128
    when ``v0`` is complex or the engine behind ``matvec`` has a complex
    sector (``real`` False), else float64.  On a rank engine pass this
    rank's row as ``v0`` (``eng.random_hashed(seed)``) and call on every
    rank together.
    """
    refuse_checkpoint(checkpoint_path)
    red = rank_reducer(matvec)
    ranks = rank_owner(matvec)
    owner = engine_owner(matvec)
    quantized = quantized_engine(owner)
    if reorth is None:
        # a quantized dictionary rounds the coefficients, so the operator
        # is Hermitian only to that rounding: the ω estimate assumes an
        # exactly Hermitian one and misses the loss of orthogonality
        reorth = "full" if quantized else get_config().lanczos_reorth
    if reorth not in ("selective", "full"):
        raise ValueError(
            f"unknown reorth policy {reorth!r} (use selective | full)")
    if quantized and reorth == "selective":
        raise ValueError(
            f"reorth='selective' on a stream_compress={owner.stream_compress!r}"
            " engine: the tier rounds the coefficients, so the operator is "
            "Hermitian only to that rounding and the selective scheme's ω "
            "estimate misses the loss of orthogonality (it converges to a "
            "spurious eigenvalue) — use reorth='full' (the default on such "
            "an engine) or solve.lanczos_block")
    device = start_device(v0, device)
    if dtype is None:
        complex_v0 = v0 is not None and (
            v0.is_complex() if isinstance(v0, torch.Tensor)
            else np.iscomplexobj(v0))
        engine_real = getattr(owner, "real", True)
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
    guarded = guard_engine(matvec, "lanczos")

    def mv(x):
        y = guarded(x.reshape(shape))
        if y.dtype != dtype:
            raise ValueError(f"matvec returned {y.dtype}; the solver runs "
                             f"in {dtype}")
        return y.reshape(nflat)

    mcap = max_basis_size or min(max(4 * k + 16, 96), max_iters + 1)
    mcap = max(mcap, k + 2)
    l_restart = min_restart_size or max(2 * k + 2, min(mcap // 3, 24))
    l_restart = int(np.clip(l_restart, k, mcap - 2))

    V = torch.zeros((mcap + 1, nflat), dtype=dtype, device=device)
    V[0] = v.reshape(nflat) / _norm(v, red)
    alph_d = torch.zeros(mcap, dtype=torch.float64, device=device)
    bet_d = torch.zeros(mcap, dtype=torch.float64, device=device)
    # the Krylov workspace in the memory ledger (what an OOM report shows)
    mem_h = track_workspace(
        "lanczos", "krylov_basis",
        V.numel() * V.element_size() + 16 * mcap, rows=mcap + 1)
    watchdog = _Watchdog("lanczos")

    lock_theta = np.zeros(0)
    lock_sigma = np.zeros(0)
    m = 0                       # live basis: V[0..m] (m completed steps)
    total_iters = 0
    converged = False
    theta = S = res = None
    selective = reorth == "selective"
    omega_tr = _OmegaTracker() if selective else None
    # the first block after a thick restart runs the full sweep: the
    # arrowhead coupling row must be projected out against every locked row
    pending_full = False
    full_sweeps = 0
    preempt.ensure_installed()

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
            pending_full = True
        nsteps = min(check_every, mcap - m, max_iters - total_iters)
        used_full = (not selective or pending_full
                     or nsteps < max(check_every // 2, 1))
        pending_full = False
        # iteration span: one convergence-check block of nsteps steps (the
        # engine applies nest inside as apply spans)
        with obs_trace.span("iteration", kind="iteration",
                            solver="lanczos", iter=int(total_iters),
                            steps=int(nsteps)):
            if used_full:
                _run_steps(mv, V, alph_d, bet_d, m, nsteps, red)
            else:
                _run_window(mv, V, alph_d, bet_d, m, nsteps, red)
                om = omega_tr.advance(alph_d.cpu().numpy(),
                                      bet_d.cpu().numpy(), m + nsteps)
        if not used_full and om >= _OMEGA_SQRT_EPS:
            # semiorthogonality is no longer guaranteed; the window block
            # wrote only rows above m, so redo it from the same state with
            # the full sweep (iterations count once).  Level "info": the
            # scheme working as Ritz pairs converge, not a health problem
            obs_emit("solver_health", check="selective_reorth_fallback",
                     level="info", solver="lanczos",
                     iter=int(total_iters + nsteps), omega=float(om))
            with obs_trace.span("iteration", kind="iteration",
                                solver="lanczos", iter=int(total_iters),
                                steps=int(nsteps), redo=True):
                _run_steps(mv, V, alph_d, bet_d, m, nsteps, red)
            used_full = True
        full_sweeps += used_full
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
        if selective and used_full:
            # every new vector is orthogonal to the whole live basis: the
            # ω table restarts at roundoff
            omega_tr.reset(m)

        kk = min(k, m)
        T = _projected_matrix(alph, bet, lock_theta, lock_sigma, m)
        theta, S = eigh(T, subset_by_index=(0, kk - 1))
        res = np.abs(bet[m - 1] * S[m - 1, :])
        omega = obs_health.omega_estimate(alph, bet, max(lo, m - nsteps),
                                          m) \
            if obs_health.probes_enabled() else None
        if m >= k and np.all(res < tol * np.maximum(1.0, np.abs(theta))):
            converged = True
            break
        watchdog.report_omega(omega, total_iters)
        if broke is not None:
            # the Krylov space closed without meeting the tolerance
            watchdog.breakdown(total_iters, float(bet[broke]),
                               converged=False)
            break
        watchdog.check_stagnation(res, total_iters)
        # chaos site at the block boundary (inert unless DMT_FAULT arms
        # it; delay= stretches a solve so a kill lands mid-iteration)
        faults.check("solver_block", exc=RuntimeError, solver="lanczos",
                     iter=int(total_iters))
        # safe point: the recurrence state is host-consistent and no
        # collective is in flight; ranks agree on the latch first
        preempt.safe_point("lanczos", total_iters,
                           ranks.group if ranks is not None else None)

    kk = min(k, m)
    evecs = None
    if compute_eigenvectors and m:
        Sj = torch.from_numpy(np.ascontiguousarray(S[:, :kk])).to(
            device, dtype)
        E = Sj.T @ V[:m]
        evecs = [(e / _norm(e, red)).reshape(shape) for e in E]
    mem_h.release()
    return LanczosResult(
        eigenvalues=np.asarray(theta[:kk]) if theta is not None
        else np.zeros(0),
        eigenvectors=evecs,
        residual_norms=np.asarray(res[:kk]) if res is not None
        else np.zeros(0),
        num_iters=total_iters,
        converged=converged,
        full_sweeps=full_sweeps,
    )


@solve_span("lanczos_block")
def lanczos_block(
    matvec: Callable,
    n: Optional[int] = None,
    k: int = 1,
    block_size: Optional[int] = None,
    max_iters: int = 200,
    tol: float = 1e-10,
    seed: int = 0,
    V0=None,
    compute_eigenvectors: bool = False,
    column_targets=None,
    max_basis_size: Optional[int] = None,
    min_restart_size: Optional[int] = None,
    device=None,
) -> LanczosResult:
    """Lowest-``k`` eigenpairs via *block* Lanczos over the batched matvec.

    Each step applies H to a whole ``[n, p]`` block in one engine call.
    Block recurrence with full reorthogonalization (two MGS passes against
    every kept block) and QR between steps; the projected matrix is block
    tridiagonal ``[A_0 B_0ᵀ; B_0 A_1 …]``, and the residual bound for a
    Ritz pair (θ, s) is ``‖B_j · s[last p rows]‖``.  ``max_iters`` counts
    individual matvec columns (p per block step).

    **Thick restarts** (``max_basis_size``): whenever the next step would
    exceed the cap, the ``min_restart_size`` (default ``max(p, 2k+2)``)
    lowest Ritz vectors become a locked block, the recurrence continues
    from the next Krylov block, and the exact coupling of that block to
    the locked one rides the arrowhead of every later projection, so every
    residual stays an exact recurrence residual.

    **Column targets** (``column_targets``): a list of ``{"k", "tol",
    "max_iters", "job_id"}`` mappings, one per batched job.  Each target is
    judged every step against its own (k, tol) on the shared Ritz pairs;
    a converged (or budget-spent) target is snapshotted and its column
    exits through a compression restart at the narrower width.  Results
    land in :attr:`LanczosResult.column_results`.

    **Hashed blocks**: with the streamed engine's own ``matvec``, pass
    ``V0`` of shape ``[1, M, p]``, or neither ``V0`` nor ``n`` and the
    start block is ``owner.random_hashed(seed, cols=p)``.  Each step is
    then one multi-column apply, which streams each plan chunk once per
    block; eigenvectors come back in the hashed layout.

    **Rank engines**: on ``DistributedEngine(group=…)`` each rank holds
    its ``[1, M, p]`` rows (start block ``owner.random_hashed(seed,
    cols=p)``), the block inner products and norms are all-reduced, the QRs
    are TSQR, and every rank calls together; the small projected problems
    are the same bits on every rank.

    ``device`` defaults to the device of the start block when it is a
    tensor, else to ``cuda`` (raising when there is none).  A set
    preemption latch stops the solve at the next block boundary with
    ``Preempted("lanczos_block", columns so far, None)``.
    """
    owner = engine_owner(matvec)
    ranks = rank_owner(matvec)
    red = None if ranks is None else ranks.reduce_sum

    def qr(X):
        if ranks is None:
            return torch.linalg.qr(X)
        return _tsqr(X, ranks.group)

    def gram(a, b):
        """``a†b`` over the global rows."""
        g = a.conj().T @ b
        return g if red is None else red(g)

    targets = None
    if column_targets is not None:
        targets = [{"k": int(t.get("k", 1)), "tol": float(t.get("tol", tol)),
                    "max_iters": int(t["max_iters"])
                    if t.get("max_iters") else None,
                    "job_id": t.get("job_id")} for t in column_targets]
        if not targets:
            raise ValueError("column_targets must be a non-empty sequence")
        k = max(int(k), max(t["k"] for t in targets))
    p = int(block_size or max(k, 2,
                              len(targets) if targets is not None else 0))
    if p < 1:
        raise ValueError(f"block_size must be >= 1, got {p}")
    if targets is not None and len(targets) > p:
        raise ValueError(f"{len(targets)} column targets need a block of "
                         f"at least that many columns, got {p}")
    mcap = l_thick = None
    if max_basis_size is not None:
        # restart width: by default max(width, 2k+2) — keeping only the k
        # targets starves the restarted epoch near convergence; the cap
        # must leave the restart block room to grow by two steps
        l_thick = max(int(min_restart_size) if min_restart_size
                      else max(p, 2 * k + 2), k, 1)
        mcap = max(int(max_basis_size), l_thick + 2 * p)

    hashed_owner = (owner is not None and hasattr(owner, "shard_size")
                    and hasattr(owner, "random_hashed"))
    if V0 is None:
        if n is None:
            if not hashed_owner:
                raise ValueError("pass V0 or n")
            V0 = owner.random_hashed(seed, cols=p)      # [1, M, p]
        else:
            V0 = _rand_like((n, p), np.float64, seed)
    dev = start_device(V0, device)
    V0 = torch.as_tensor(V0).to(dev)
    vec_shape = None         # non-None: hashed [D, M] engine layout
    lead = None if not hashed_owner else (
        1 if ranks is not None else owner.n_devices)   # hashed rows here
    if (hashed_owner and V0.dim() == 3
            and tuple(V0.shape[:2]) == (lead, owner.shard_size)):
        vec_shape = tuple(V0.shape[:2])
        V0 = V0.reshape(-1, V0.shape[2])   # flat [D·M, p] for the algebra
    if V0.dim() != 2:
        raise ValueError(f"V0 must be [n, p] (or hashed [D, M, p] for a "
                         f"distributed engine), got shape "
                         f"{tuple(V0.shape)}")
    n, p = V0.shape
    guarded = guard_engine(matvec, "lanczos_block")

    def mv(X):
        # hashed engines take and give [D, M, p]; the dense algebra runs
        # on the flat [D·M, p] view (pad slots are zero by engine
        # invariant).  Width read off X: a column-target solve narrows
        pc = int(X.shape[1])
        Y = guarded(X.reshape(vec_shape + (pc,))) if vec_shape \
            else guarded(X)
        Y = Y[0] if isinstance(Y, tuple) else Y
        return Y.reshape(-1, pc) if vec_shape else Y

    # the probe apply of the QR'd first block fixes the dtype (a
    # complex-Hermitian operator promotes a real block) and is reused as
    # step 0's apply
    Q, _ = qr(V0)
    W0 = mv(Q)
    dtype = torch.promote_types(V0.dtype, W0.dtype)
    Q = Q.to(dtype)
    blocks = [Q]                     # each [n, w_i], mutually orthonormal
    A_list: list = []                # diagonal blocks   [w_i, w_i] (host)
    B_list: list = []                # subdiagonal blocks [w_{i+1}, w_i]
    widths: list = []                # per-step block widths
    theta = S = res = None
    converged = False
    total = 0
    p_cur = p
    n_restarts = 0
    # thick-restart lock state: locked Ritz values, their orthonormal
    # basis block, and the residual coupling of the first active block to
    # them (the block arrowhead).  Locked vectors are never fed back
    # through H.
    lock_theta = np.zeros(0)
    lock_Y = None                       # [n, l] locked Ritz block
    lock_C = None                       # [widths[0], l] coupling row

    def _ritz_block(S_cols, m_rows):
        """[n, c] Ritz combinations over the kept basis covering the
        first ``m_rows`` rows — locked rows first, then the active
        blocks."""
        l0 = int(lock_theta.shape[0])
        Sj = torch.as_tensor(np.ascontiguousarray(S_cols)).to(dev, dtype)
        offs = np.concatenate(([0], np.cumsum(widths))).astype(int)
        nb = int(np.searchsorted(offs, m_rows - l0))
        out = sum(blocks[i] @ Sj[l0 + offs[i]: l0 + offs[i + 1]]
                  for i in range(nb))
        if l0:
            out = lock_Y @ Sj[:l0] + out
        return out

    def _assemble(S_cols, m_rows):
        """Normalized Ritz vectors in the matvec's layout."""
        E = _ritz_block(np.asarray(S_cols), m_rows)
        out = []
        for i in range(np.asarray(S_cols).shape[1]):
            e = E[:, i]
            e = e / _norm(e, red)
            out.append(e.reshape(vec_shape) if vec_shape else e)
        return out

    # the block basis in the memory ledger, re-pointed as it grows
    mem_h = track_workspace("lanczos_block", "block_basis",
                            Q.numel() * Q.element_size(), block_size=int(p))
    watchdog = _Watchdog("lanczos_block")
    a_seq: list = []        # scalarized per-step (α, β) for the ω estimate
    b_seq: list = []
    preempt.ensure_installed()
    j = 0
    while True:
        # chaos site and safe point between block steps (the JAX
        # solver's, without its checkpoint): a preempted solve stops at a
        # block boundary
        faults.check("solver_block", exc=RuntimeError,
                     solver="lanczos_block", iter=int(total))
        preempt.safe_point("lanczos_block", total,
                           ranks.group if ranks is not None else None)
        # iteration span: one block step (p_cur matvec columns + the
        # block recurrence); the engine apply nests inside
        with obs_trace.span("iteration", kind="iteration",
                            solver="lanczos_block", iter=int(total),
                            block=j):
            Qj = blocks[-1]
            # step 0 reuses the probe's apply
            W = (W0 if j == 0 else mv(Qj)).to(dtype)
            W0 = None
            A = gram(Qj, W)
            W = W - Qj @ A
            if B_list:          # empty right after a narrowing restart
                W = W - blocks[-2] @ torch.as_tensor(
                    B_list[-1]).to(dev, dtype).conj().T
            # full reorthogonalization, two passes, locked block included
            for _ in range(2):
                for Qi in (() if lock_Y is None else (lock_Y,)) \
                        + tuple(blocks):
                    W = W - Qi @ gram(Qi, W)
            Qn, B = qr(W)
        A_list.append(A.cpu().numpy())
        B_list.append(B.cpu().numpy())
        widths.append(p_cur)
        total += p_cur
        l0 = int(lock_theta.shape[0])
        m = l0 + sum(widths)

        # projected matrix (A is Hermitian only to roundoff: symmetrize):
        # block tridiagonal, preceded after a thick restart by the
        # arrowhead of locked Ritz values and the coupling row
        T = np.zeros((m, m), dtype=np.result_type(
            *(A_list + ([lock_C] if lock_C is not None else []))))
        if l0:
            T[:l0, :l0] = np.diag(lock_theta)
            w0 = widths[0]
            T[l0: l0 + w0, :l0] = lock_C
            T[:l0, l0: l0 + w0] = lock_C.conj().T
        off = l0
        for i, Ai in enumerate(A_list):
            w = widths[i]
            T[off: off + w, off: off + w] = (Ai + Ai.conj().T) / 2
            off += w
        off = l0
        for i, Bi in enumerate(B_list[:-1]):
            w0, w1 = widths[i], widths[i + 1]
            T[off + w0: off + w0 + w1, off: off + w0] = Bi
            T[off: off + w0, off + w0: off + w0 + w1] = Bi.conj().T
            off += w0
        kk = min(k, m)
        theta, S = eigh(T, subset_by_index=(0, kk - 1))
        res = np.linalg.norm(B_list[-1] @ S[m - widths[-1]:, :], axis=0)
        mem_h.set(mem_h.paths[0] if mem_h.paths else "",
                  sum(b.numel() * b.element_size() for b in blocks)
                  + (0 if lock_Y is None
                     else lock_Y.numel() * lock_Y.element_size()))
        # the JAX estimate: scalarized per-step (α, β) of the block
        # recurrence, the last step's one-step amplification
        a_seq.append(float(np.max(np.abs(A_list[-1]))))
        b_seq.append(float(np.min(np.abs(np.diag(B_list[-1])))))
        omega = obs_health.omega_estimate(
            np.asarray(a_seq), np.asarray(b_seq),
            len(b_seq) - 1, len(b_seq)) \
            if obs_health.probes_enabled() else None
        newly_done = 0
        if targets is None:
            if m >= k and np.all(res < tol * np.maximum(1.0,
                                                        np.abs(theta))):
                converged = True
                break
        else:
            # every unfinished target judged against its own (k, tol); a
            # target whose own column budget is spent exits unconverged
            for t in targets:
                if t.get("done"):
                    continue
                kt = min(t["k"], kk)
                ok = m >= t["k"] and np.all(
                    res[:kt] < t["tol"]
                    * np.maximum(1.0, np.abs(theta[:kt])))
                spent = (not ok and t["max_iters"] is not None
                         and total >= t["max_iters"])
                if not ok and not spent:
                    continue
                t["done"] = True
                t["snapshot"] = {
                    "theta": np.asarray(theta[:kt]).copy(),
                    "res": np.asarray(res[:kt]).copy(),
                    "S": np.asarray(S[:, :kt]).copy(),
                    "m": int(m), "iters": int(total),
                    "converged": bool(ok)}
                newly_done += 1
            if all(t.get("done") for t in targets):
                converged = all(t["snapshot"]["converged"]
                                for t in targets)
                break
        watchdog.report_omega(omega, total)
        # breakdown: the Krylov space closed (rank-deficient new block)
        rdiag = np.abs(np.diag(B_list[-1]))
        if rdiag.min() < 1e-12 * max(rdiag.max(), 1.0):
            watchdog.breakdown(total, float(rdiag.min()), converged=False)
            break
        if total + p_cur > max_iters:
            break
        watchdog.check_stagnation(res, total)
        if newly_done:
            remaining = [t for t in targets if not t.get("done")]
            p_new = max(len(remaining),
                        max(t["k"] for t in remaining), 1)
            if p_new < p_cur:
                # column exit via a compression restart: the basis is
                # compressed to the p_new lowest Ritz vectors and the
                # recurrence restarts at the narrower width (dropping
                # columns of Qn would break the residual bound).
                # Finished targets' eigenvectors are materialized first.
                if compute_eigenvectors:
                    for t in targets:
                        snap = t.get("snapshot")
                        if snap is not None and "vecs" not in snap:
                            snap["vecs"] = _assemble(snap["S"], snap["m"])
                _, S_r = eigh(T, subset_by_index=(0, p_new - 1))
                Q0, _ = qr(_ritz_block(S_r, m))
                blocks = [Q0.to(dtype)]
                A_list, B_list, widths = [], [], []
                a_seq, b_seq = [], []      # ω table resets with the basis
                lock_theta = np.zeros(0)
                lock_Y = lock_C = None
                p_cur = p_new
                j += 1
                continue
        if mcap is not None and m + p_cur > mcap:
            # thick restart (TRLan in block form): the l_thick lowest Ritz
            # vectors become the locked block, the recurrence continues
            # from Qn, and C = B·S[last rows] couples them exactly
            if compute_eigenvectors and targets:
                for t in targets:
                    snap = t.get("snapshot")
                    if snap is not None and "vecs" not in snap:
                        snap["vecs"] = _assemble(snap["S"], snap["m"])
            ll = min(int(l_thick), m - 1)
            theta_all, S_all = eigh(T)
            Y_new = _ritz_block(S_all[:, :ll], m).to(dtype)
            lock_C = B_list[-1] @ S_all[m - widths[-1]:, :ll]
            lock_theta = np.asarray(theta_all[:ll])
            lock_Y = Y_new
            blocks = [Qn]
            A_list, B_list, widths = [], [], []
            a_seq, b_seq = [], []      # ω table resets with the basis
            n_restarts += 1
            j += 1
            continue
        blocks.append(Qn)
        j += 1

    mem_h.release()
    m_fin = int(lock_theta.shape[0]) + sum(widths)
    kk = min(k, m_fin) if m_fin else 0

    evecs = None
    if compute_eigenvectors and theta is not None:
        evecs = _assemble(np.asarray(S[:, :kk]), m_fin)

    column_results = None
    if targets is not None:
        column_results = []
        for t in targets:
            snap = t.get("snapshot")
            if snap is None and theta is not None:
                # unfinished target: its reading at the final basis size
                kt = min(t["k"], kk)
                snap = {"theta": np.asarray(theta[:kt]),
                        "res": np.asarray(res[:kt]),
                        "S": np.asarray(S[:, :kt]),
                        "m": int(m_fin), "iters": int(total),
                        "converged": False}
            entry = {"job_id": t.get("job_id"), "k": int(t["k"]),
                     "tol": float(t["tol"]),
                     "converged": bool(snap and snap["converged"]),
                     "eigenvalues": np.asarray(snap["theta"])
                     if snap else np.zeros(0),
                     "residuals": np.asarray(snap["res"])
                     if snap else np.zeros(0),
                     "iters": int(snap["iters"]) if snap else 0,
                     "basis_size": int(snap["m"]) if snap else 0}
            if compute_eigenvectors and snap is not None:
                entry["eigenvectors"] = snap.get("vecs") \
                    or _assemble(np.asarray(snap["S"]), snap["m"])
            column_results.append(entry)

    return LanczosResult(
        eigenvalues=np.asarray(theta[:kk]) if theta is not None
        else np.zeros(0),
        eigenvectors=evecs,
        residual_norms=np.asarray(res[:kk]) if res is not None
        else np.zeros(0),
        num_iters=total,
        converged=converged,
        restarts=n_restarts,
        column_results=column_results,
    )
