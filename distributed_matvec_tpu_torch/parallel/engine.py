# Ported from distributed_matvec_tpu/parallel/engine.py (LocalEngine; the host helpers copied).
"""Single-device matvec engine: y = H·x over the representative basis.

PyTorch counterpart of ``distributed_matvec_tpu/parallel/engine.py``'s
``LocalEngine``.  The (projected) Hamiltonian is Hermitian, so the engine
applies it in *gather* form

    y[i] = d(i)·x[i] + Σ_t A[i, j(i,t)] · x[j(i,t)],    A_ij = conj(A_ji)

which is gathers, a multiply and a row reduction: no scatter, no atomics.

Three modes (``mode=``):

* ``"ell"`` (default): one pass of the operator kernels precomputes the
  sparse structure, int32 column indices and f64/c128 coefficients in a
  transposed ELL layout ``[T0, N_pad]`` plus a tail over the S rows wider
  than T0; every apply is then a per-term gather·multiply·add.  When the
  full-width ``[T, N_pad]`` tables would pass ``build_budget_gb`` the
  two-pass low-memory build packs each chunk straight into the final
  tables.
* ``"compact"``: real sectors with a single off-diagonal magnitude W: each
  entry stores only a sign-tagged index ``±(idx+1)`` and the apply derives
  ``A[i, j] = W·s·n(j)/n(i)``.
* ``"fused"``: no table; every apply re-runs the kernels per row chunk.

Out-of-sector targets are checked once at build time in ``ell`` and
``compact`` mode, and on the first apply in ``fused`` mode.

With the obs layer on every apply emits ``matvec_apply`` (bytes 0: no
exchange) and the ``matvec_apply_ms`` series, and with ``phases`` on an
``apply_phases`` event whose structural counts equal the JAX engine's
(``_phase_counts``); the wall then covers the apply to its end on the
device (one synchronization at the apply's end on the card).  Each apply
runs in an ``apply`` span, drains the health probes queued by earlier
applies and queues its own every ``health_every``-th apply
(``obs/health.py``: no synchronization), samples a memory watermark every
``memory_every``-th apply, and runs inside a ``torch.profiler`` window
every ``profile_every``-th apply under ``DMT_PROFILE=sampled``.  The
construction emits ``engine_init``, registers the tables in the memory
ledger, and a device out-of-memory failure in the build or an apply is
raised as ``obs.memory.OomError`` with its forensics report.  With obs off
the apply takes no timing at all.

The JAX engine's artifact and structure caches, the split-gather table and
the (re, im) pair form are not carried over: Hopper gathers f64 and
complex128 natively.  Everything here is plain PyTorch.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..models.operator import Operator
from ..obs import health as obs_health
from ..obs import memory as obs_memory
from ..obs import phases as obs_phases
from ..obs import profile as obs_profile
from ..obs import trace as obs_trace
from ..obs.events import emit, obs_enabled
from ..obs.metrics import histogram
from ..ops import kernels as K
from ..ops.bits import build_sorted_lookup, state_index_bucketed
from ..utils import u64
from ..utils.config import get_config
from ..utils.device import resolve_device
from ..utils.timers import TreeTimer
from .distributed import SENTINEL_STATE as _SENTINEL_BITS
from .engine_obs import (emit_engine_init, note_applying, oom_reraise,
                         register_engine_memory)

__all__ = ["LocalEngine", "pad_to_multiple", "SENTINEL_STATE",
           "choose_ell_split", "compact_magnitude", "compact_magnitudes"]

# Sentinel for padded representative slots: max u64 sorts after any real state.
SENTINEL_STATE = np.uint64(0xFFFFFFFFFFFFFFFF)

_OUT_OF_BASIS = ("generated matrix elements map outside the basis — "
                 "operator does not preserve the chosen sector")


def pad_to_multiple(n: int, b: int) -> int:
    return ((n + b - 1) // b) * b


def _chunk_structure_ops(tables, lk_pair, lk_dir, alphas, norms_a,
                         shift: int, probes: int):
    """One row chunk: kernels → basis lookup → masking.  Returns
    (idx [B, T] int64, coeff [B, T], invalid count)."""
    betas, cf = K.gather_coefficients(tables, alphas, norms_a)
    idx, found = state_index_bucketed(
        lk_pair, lk_dir, betas.reshape(-1), shift=shift, probes=probes)
    return K.mask_structure(
        cf, idx.reshape(betas.shape), found.reshape(betas.shape),
        alphas != _SENTINEL_BITS)


def _live_first(dead: torch.Tensor) -> torch.Tensor:
    """Per column of a [T, b] mask, the row order that puts the live
    entries first, each group in its original order: the JAX engine's
    ``argsort(dead, axis=0, stable=True)``, sorted on an integer key."""
    return torch.argsort(dead.to(torch.uint8), dim=0, stable=True)


def _nonzero_padded(mask: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=0)[0]`` as int32: the
    first ``size`` set positions, padded with 0."""
    out = torch.zeros(size, dtype=torch.int32, device=mask.device)
    nz = torch.nonzero(mask).reshape(-1)[:size]
    out[:nz.numel()] = nz
    return out


# Copied from distributed_matvec_tpu/parallel/engine.py (host NumPy).
def choose_ell_split(hist: np.ndarray, n_rows: int, T: int,
                     real_rows: int | None = None):
    """Pick the two-level ELL split point from a row-nnz histogram.

    Returns ``(T0, S, Tmax)``: main-table width, number of tail rows, and
    the widest actual row.  ``T0`` minimizes ``n_rows·t + 2·S(t)·(Tmax−t)``
    — tail entries are scatter-accumulated, hence the 2× weight — subject to
    ``S(t) ≤ real_rows/4`` so the scatter stays a small fraction of the
    *actual* basis (``n_rows`` counts padded rows too — they cost gather
    slots in the main table but must not widen the tail budget); ``t = Tmax``
    (pure truncation, empty tail) always qualifies, so the domain is never
    empty.  Splits saving < 15% of the full-width ``n_rows·T`` entries are
    rejected as ``(T, 0, Tmax)``.
    """
    if n_rows == 0 or T == 0 or not hist.any():
        return T, 0, 0
    if real_rows is None:
        real_rows = n_rows
    Tmax = int(np.nonzero(hist)[0].max())
    # rows_gt[t] = number of rows with nnz > t
    rows_gt = hist[::-1].cumsum()[::-1]
    rows_gt = np.concatenate([rows_gt[1:], [0]])
    ts = np.arange(Tmax + 1)
    cost = n_rows * ts + 2.0 * rows_gt[: Tmax + 1] * (Tmax - ts)
    cost = np.where(rows_gt[: Tmax + 1] <= real_rows // 4, cost, np.inf)
    T0 = int(np.argmin(cost))
    S = int(rows_gt[T0])
    if (n_rows * T - cost[T0]) < 0.15 * n_rows * T:
        T0, S = T, 0
    return T0, S, Tmax


# Copied from distributed_matvec_tpu/parallel/engine.py (host NumPy).
def compact_magnitude(operator, sample_size: int = 4096,
                      sample_states=None) -> float:
    """The single off-diagonal magnitude W compact mode assumes, derived from
    a sample of rows *strided across the whole basis* (not just its head —
    an operator whose anisotropy only shows up deep in the basis should be
    refused here, cheaply, rather than after a long count/pack pass).
    Correctness never depends on this: every entry is re-validated against W
    during the pack."""
    vals = compact_magnitudes(operator, sample_size, sample_states)
    if vals.size != 1:
        raise ValueError(
            f"compact mode needs a single off-diagonal magnitude, "
            f"found {vals[:5]}; use mode='ell'")
    return float(vals[0])


# Copied from distributed_matvec_tpu/parallel/engine.py (host NumPy).
def compact_magnitudes(operator, sample_size: int = 4096,
                       sample_states=None) -> np.ndarray:
    """The distinct off-diagonal magnitudes over the sampled rows (sorted;
    possibly empty) — the non-raising core of :func:`compact_magnitude`."""
    if sample_states is not None:
        sample = np.asarray(sample_states, np.uint64)
    else:
        reps = operator.basis.representatives
        n = reps.shape[0]
        if n <= sample_size:
            sample = reps
        else:
            sample = reps[np.linspace(0, n - 1, sample_size).astype(np.int64)]
    if sample.size == 0:
        return np.zeros(0)
    _, amps = operator.apply_off_diag(np.ascontiguousarray(sample))
    return np.unique(np.abs(amps[amps != 0]))


# Copied from distributed_matvec_tpu/parallel/engine.py (host NumPy).
def _padded_basis_arrays(reps: np.ndarray, norms: np.ndarray, n_pad: int):
    pad = n_pad - reps.size
    alphas = np.concatenate([reps, np.full(pad, SENTINEL_STATE, np.uint64)])
    nrm = np.concatenate([norms, np.ones(pad)])
    return alphas, nrm


def _tail_layout(nnz: torch.Tensor, T0: int, S: int, Tmax: int):
    """Tail bookkeeping of the chunked pack loops (low-memory ELL and
    compact builds), from the ``[C, b]`` row-nnz counts.

    Tail slabs are written sequentially with one fixed capacity ``Ct``:
    chunk k writes at host offset ``offs[k] = Σ_{j<k} real_j``, so a slab's
    garbage rows beyond its real count are exactly covered by chunk k+1's
    slab (same capacity, offset advanced by real_k), and the final chunk's
    garbage lies in [S, S+Ct) — sliced off by the caller.  After the sweep,
    positions [0, S) hold exactly the real tail rows.  Returns
    ``(Tw, Ct, offs)``.
    """
    C = nnz.shape[0]
    if not S:
        return 0, 0, np.zeros(C + 1, np.int64)
    tail_counts = (nnz > T0).sum(dim=1).cpu().numpy()
    offs = np.concatenate([[0], np.cumsum(tail_counts)])
    return Tmax - T0, int(tail_counts.max()), offs


def ell_terms(y: torch.Tensor, x: torch.Tensor, idx: torch.Tensor,
              coeff: torch.Tensor) -> torch.Tensor:
    """``y += Σ_t coeff[t]·x[idx[t]]`` term by term, gathering along the
    last (state) axis of ``x``; ``idx``/``coeff`` are ``[T, n]``."""
    for t in range(idx.shape[0]):
        y += coeff[t] * torch.index_select(x, -1, idx[t])
    return y


def compact_terms(acc: torch.Tensor, tags: torch.Tensor, x: torch.Tensor,
                  norms: torch.Tensor) -> torch.Tensor:
    """``acc += Σ_t s·n(j)·x(j)`` over sign-tagged indices ``±(j+1)``
    (``tags`` ``[T, n]``), gathering along the last axis of ``x`` and from
    ``norms``."""
    for t in range(tags.shape[0]):
        v = tags[t]
        i = (v.abs() - 1).clamp_(min=0)
        w = torch.sign(v).to(torch.float64) * torch.index_select(norms, 0, i)
        acc += w * torch.index_select(x, -1, i)
    return acc


class LocalEngine:
    """Single-device matvec over a built basis.

    Usage::

        eng = LocalEngine(operator)        # builds the tables on the card
        y = eng.matvec(x)                  # f64, or c128 in a complex sector
        Y = eng.matvec(X)                  # batch: X of shape [N, k]

    ``mode='ell'`` precomputes the sparse structure (fast apply, O(N·T)
    device memory), ``'compact'`` stores 4 bytes per entry for real
    single-magnitude operators, and ``'fused'`` recomputes the structure
    on every apply (low memory); the default is the config's
    ``matvec_mode`` (``DMT_MATVEC_MODE``, ``'ell'``).  ``batch_size`` is
    the row chunk (default: the config's ``matvec_batch_size``, 65536);
    the one-pass ELL build is taken while 1.6× its full-width tables fit
    ``build_budget_gb`` (default: the config's ``ell_build_budget_gb``,
    12).  ``device`` defaults to ``cuda`` and raises when there is none.
    """

    def __init__(self, operator: Operator, batch_size: Optional[int] = None,
                 mode: Optional[str] = None,
                 build_budget_gb: Optional[float] = None, device=None):
        self.device = resolve_device(device)
        cfg = get_config()
        mode = mode or cfg.matvec_mode
        if build_budget_gb is None:
            build_budget_gb = cfg.ell_build_budget_gb
        if mode in ("streamed", "hybrid"):
            raise ValueError(
                f"mode={mode!r} lives on DistributedEngine (the plan "
                "stream reuses its exchange machinery) — use "
                f"DistributedEngine(op, n_devices=1, mode={mode!r}) for "
                "a single-device engine")
        if mode not in ("ell", "fused", "compact"):
            raise ValueError(f"unknown engine mode {mode!r}")
        if not operator.is_hermitian:
            raise ValueError(
                "the gather-form engine requires a Hermitian operator "
                "(as does the reference's eigensolver)")
        basis = operator.basis
        if not basis.is_built:
            basis.build()
        self.operator = operator
        self.mode = mode
        self.real = operator.effective_is_real
        self._dtype = torch.float64 if self.real else torch.complex128
        self.build_budget_gb = build_budget_gb
        n = basis.number_states
        b = min(batch_size or cfg.matvec_batch_size, max(n, 1))
        n_pad = pad_to_multiple(n, b)
        self.n_states = n
        self.n_padded = n_pad
        self.batch_size = b
        self.num_chunks = n_pad // b
        #: (T0, S, Tmax) of the ELL or compact tables; None in fused mode
        self.ell_split = None
        #: True when the ELL tables came from the two-pass build
        self.low_memory_build = False
        #: the construction's and the applies' timing tree
        self.timer = TreeTimer("LocalEngine")
        t_init = time.perf_counter()
        # pre-build watermark: the delta against the post-init sample is
        # the construction's device footprint
        obs_memory.sample_watermark("engine_init_start/local")
        try:
            self._construct(operator, mode)
        except Exception as e:
            oom_reraise(e, engine="local", mode=mode, phase="init",
                        n_states=int(n))
        emit_engine_init(self, "local", init_s=time.perf_counter() - t_init)
        register_engine_memory(self, "local")
        self.timer.report()    # the tree, printed with display_timings on

    def _construct(self, operator: Operator, mode: str) -> None:
        """Lookup, tables, diagonal and the mode's structure build."""
        dev, basis = self.device, operator.basis
        n_pad, b = self.n_padded, self.batch_size
        reps, norms = basis.representatives, basis.norms
        alphas, nrm = _padded_basis_arrays(reps, norms, n_pad)
        pair, dir_tab, self._lk_shift, self._lk_probes = build_sorted_lookup(
            reps, basis.number_bits)
        with self.timer.scope("transfer"):
            self._lk_pair = torch.from_numpy(pair.astype(np.int64)).to(dev)
            self._lk_dir = torch.from_numpy(dir_tab).to(dev)
            self._alphas = u64.from_numpy(alphas, dev)        # [N_pad]
            self._norms = torch.from_numpy(nrm).to(dev)       # [N_pad]
            self.tables = K.device_tables(operator, dev)
        self.num_terms = int(self.tables.off.x.shape[0])
        # by row chunk: one [N_pad, K] pass would hold several [N_pad, K]
        # int64 temporaries at once, more than the ELL tables themselves
        with self.timer.scope("diag"):
            self._diag = torch.empty(n_pad, dtype=torch.float64, device=dev)
            for s in range(0, n_pad, b):
                self._diag[s:s + b] = K.apply_diag(self.tables.diag,
                                                   self._alphas[s:s + b])

        with self.timer.scope("build_structure"):
            if mode == "ell":
                self._build_ell()
            elif mode == "compact":
                self._build_compact()
        # ell and compact were validated at build time
        self._checked = mode != "fused"
        self._apply_idx = 0
        self._phase_count_cache: Dict[tuple, dict] = {}

    # -- structure build -----------------------------------------------------

    def _chunk_structure(self, ci: int):
        s = ci * self.batch_size
        e = s + self.batch_size
        return _chunk_structure_ops(
            self.tables, self._lk_pair, self._lk_dir, self._alphas[s:e],
            self._norms[s:e], self._lk_shift, self._lk_probes)

    def _build_ell(self) -> None:
        """One pass of the kernels into full-width transposed ``[T, N_pad]``
        idx/coeff tables, then the two-level split.  Peak memory is about
        1.6× the full-width tables; past ``build_budget_gb`` the two-pass
        build runs instead."""
        b, T, n_pad = self.batch_size, self.num_terms, self.n_padded
        cf_item = 8 if self.real else 16
        full_bytes = n_pad * T * (4 + cf_item)
        if 1.6 * full_bytes > self.build_budget_gb * 1e9:
            self.low_memory_build = True
            return self._build_ell_lowmem()

        # every column is written below, chunk by chunk
        idx_buf = torch.empty((T, n_pad), dtype=torch.int32,
                              device=self.device)
        coeff_buf = torch.empty((T, n_pad), dtype=self._dtype,
                                device=self.device)
        bad = self._zeros((), torch.int64)
        for ci in range(self.num_chunks):
            idx, cf, invalid = self._chunk_structure(ci)
            idx_buf[:, ci * b:(ci + 1) * b] = idx.T
            coeff_buf[:, ci * b:(ci + 1) * b] = cf.T
            bad += invalid
        if int(bad):
            raise RuntimeError(f"{int(bad)} {_OUT_OF_BASIS}")
        self._split_ell(idx_buf, coeff_buf)

    def _split_ell(self, idx_buf, coeff_buf) -> None:
        """Pack each row's nonzeros left and split the table in two levels:
        a width-``T0`` main table over every row plus a ``[Tmax−T0, S]``
        tail over the S rows with nnz > T0 (see :func:`choose_ell_split`).
        """
        T, n_pad, b = self.num_terms, self.n_padded, self.batch_size
        if n_pad == 0:
            self.ell_split = (T, 0, 0)
            self._ell_idx, self._ell_coeff = idx_buf, coeff_buf
            self._ell_tail = None
            return
        nnz = (coeff_buf != 0).sum(dim=0)
        hist = torch.bincount(nnz, minlength=T + 1).cpu().numpy()
        T0, S, Tmax = choose_ell_split(hist, n_pad, T,
                                       real_rows=self.n_states)
        self.ell_split = (T0, S, Tmax)
        if T0 == T:
            self._ell_idx, self._ell_coeff = idx_buf, coeff_buf
            self._ell_tail = None
            return
        out_idx = torch.empty((T0, n_pad), dtype=torch.int32,
                              device=self.device)
        out_cf = torch.empty((T0, n_pad), dtype=self._dtype,
                             device=self.device)
        for ci in range(self.num_chunks):
            s, e = ci * b, (ci + 1) * b
            cf_c = coeff_buf[:, s:e]
            order = _live_first(cf_c == 0)[:T0]
            out_idx[:, s:e] = idx_buf[:, s:e].gather(0, order)
            out_cf[:, s:e] = cf_c.gather(0, order)
        self._ell_idx, self._ell_coeff = out_idx, out_cf
        if S == 0:
            self._ell_tail = None
            return
        # the stable order is deterministic per column, so recomputing it
        # on the gathered columns continues exactly where the pack stopped
        rows = _nonzero_padded(nnz > T0, S)
        idx_r, cf_r = idx_buf[:, rows.long()], coeff_buf[:, rows.long()]
        order = _live_first(cf_r == 0)[T0:Tmax]
        self._ell_tail = (rows, idx_r.gather(0, order),
                          cf_r.gather(0, order))

    def _count_row_nnz(self):
        """Counting pass of the low-memory builds: the ``[C, b]`` row-nnz
        counts and the global histogram.  Raises on out-of-basis targets
        (the build-time halt)."""
        T = self.num_terms
        nnz = self._zeros((self.num_chunks, self.batch_size), torch.int64)
        bad = self._zeros((), torch.int64)
        for ci in range(self.num_chunks):
            _, cf, invalid = self._chunk_structure(ci)
            nnz[ci] = (cf != 0).sum(dim=1)
            bad += invalid
        if int(bad):
            raise RuntimeError(f"{int(bad)} {_OUT_OF_BASIS}")
        hist = torch.bincount(nnz.reshape(-1), minlength=T + 1)
        return nnz, hist.cpu().numpy()

    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _build_ell_lowmem(self) -> None:
        """Two-pass ELL build bounded by the *packed* table size: pass 1
        keeps only per-row nnz counts, pass 2 re-runs the kernels and packs
        each chunk's nonzeros straight into the final ``[T0, N_pad]``
        tables and the sequentially assembled tail (:func:`_tail_layout`).
        """
        b, T, n_pad = self.batch_size, self.num_terms, self.n_padded
        nnz, hist = self._count_row_nnz()
        T0, S, Tmax = choose_ell_split(hist, n_pad, T,
                                       real_rows=self.n_states)
        self.ell_split = (T0, S, Tmax)
        Tw, Ct, offs = _tail_layout(nnz, T0, S, Tmax)
        del nnz

        out_idx = torch.empty((T0, n_pad), dtype=torch.int32,
                              device=self.device)
        out_cf = torch.empty((T0, n_pad), dtype=self._dtype,
                             device=self.device)
        # tail slabs, at least one slot each
        slab = (max(Tw, 1), max(S + Ct, 1))
        t_rows = self._zeros(slab[1], torch.int32)
        t_idx = self._zeros(slab, torch.int32)
        t_cf = self._zeros(slab, self._dtype)
        for ci in range(self.num_chunks):
            s = ci * b
            idx, cf, _ = self._chunk_structure(ci)
            dead = cf.T == 0
            order = _live_first(dead)
            idx_p = idx.T.to(torch.int32).gather(0, order)
            cf_p = cf.T.gather(0, order)
            out_idx[:, s:s + b] = idx_p[:T0]
            out_cf[:, s:s + b] = cf_p[:T0]
            if Ct:
                tr = _nonzero_padded((~dead).sum(dim=0) > T0, Ct).long()
                o = int(offs[ci])
                t_rows[o:o + Ct] = tr + s
                t_idx[:, o:o + Ct] = idx_p[T0:Tmax][:, tr]
                t_cf[:, o:o + Ct] = cf_p[T0:Tmax][:, tr]
        self._ell_idx, self._ell_coeff = out_idx, out_cf
        self._ell_tail = None if S == 0 else (
            t_rows[:S], t_idx[:, :S].contiguous(),
            t_cf[:, :S].contiguous())

    def _build_compact(self) -> None:
        """4-bytes-per-entry structure for real sectors with one off-diagonal
        magnitude W (isotropic Heisenberg: every ⟨β|H|α⟩ is ±2J).  The
        projected coefficient is ``A[i, j] = W·s·n(j)/n(i)`` with s = ±1, so
        each entry stores only ``±(idx+1)`` (0 = no element).  W comes from
        a sample and every entry is validated against it during the pack.
        """
        if not self.real:
            raise ValueError(
                "compact mode requires a real sector (use mode='ell' for "
                "complex-character momentum sectors)")
        b, T, n_pad = self.batch_size, self.num_terms, self.n_padded
        W = compact_magnitude(self.operator)
        self._c_W = W

        nnz, hist = self._count_row_nnz()
        T0, S, Tmax = choose_ell_split(hist, n_pad, T,
                                       real_rows=self.n_states)
        self.ell_split = (T0, S, Tmax)
        Tw, Ct, offs = _tail_layout(nnz, T0, S, Tmax)
        del nnz

        out_idx = torch.empty((T0, n_pad), dtype=torch.int32,
                              device=self.device)
        slab = (max(Tw, 1), max(S + Ct, 1))
        t_rows = self._zeros(slab[1], torch.int32)
        t_idx = self._zeros(slab, torch.int32)
        bad_ratio = self._zeros((), torch.int64)
        for ci in range(self.num_chunks):
            s = ci * b
            idx, cf, _ = self._chunk_structure(ci)
            nz = cf != 0
            # validate coeff == ±W·n(j)/n(i) for every nonzero entry (the
            # targets are basis rows, so the padded norms serve)
            nb = self._norms[idx]
            ratio = cf.abs() * self._norms[s:s + b, None] / torch.where(
                nb > 0, nb, torch.ones_like(nb))
            bad_ratio += torch.sum(nz & ((ratio - W).abs() > 1e-9 * W))
            tag = torch.where(cf >= 0, 1, -1).to(torch.int32) * (
                idx.to(torch.int32) + 1)
            tag_t = tag.masked_fill(~nz, 0).T             # [T, b]
            tag_p = tag_t.gather(0, _live_first(tag_t == 0))
            out_idx[:, s:s + b] = tag_p[:T0]
            if Ct:
                tr = _nonzero_padded((tag_t != 0).sum(dim=0) > T0, Ct).long()
                o = int(offs[ci])
                t_rows[o:o + Ct] = tr + s
                t_idx[:, o:o + Ct] = tag_p[T0:Tmax][:, tr]
        if int(bad_ratio):
            raise RuntimeError(
                f"{int(bad_ratio)} matrix elements violate the "
                f"±W·n(j)/n(i) form (W={W}); the operator does not qualify "
                "for compact mode — use mode='ell'")
        self._c_idx = out_idx
        self._c_tail = None if S == 0 else (t_rows[:S],
                                            t_idx[:, :S].contiguous())
        inv_n = np.ones(n_pad)
        inv_n[:self.n_states] = 1.0 / np.asarray(self.operator.basis.norms)
        self._c_inv_n = torch.from_numpy(inv_n).to(self.device)

    # -- applies ---------------------------------------------------------------

    def _apply_ell(self, x: torch.Tensor) -> torch.Tensor:
        """``y = diag·x``, then term by term ``y += coeff[t]·x[idx[t]]``, then
        the tail's rows (unique, so the add is deterministic).  The state
        axis of ``x`` is its last: ``[N]`` or a batch ``[k, N]``."""
        n = self.n_states
        T0 = self.ell_split[0]
        y = ell_terms(self._diag[:n].to(self._dtype) * x, x,
                      self._ell_idx[:T0, :n], self._ell_coeff[:T0, :n])
        if self._ell_tail is not None:
            rows, idx_t, cf_t = self._ell_tail
            acc = ell_terms(self._zeros(x.shape[:-1] + rows.shape,
                                        self._dtype), x, idx_t, cf_t)
            y[..., rows.long()] += acc
        return y

    def _apply_compact(self, x: torch.Tensor) -> torch.Tensor:
        """Sign-tagged gathers: ``acc = Σ_t s·n(j)·x(j)``, then
        ``y = diag·x + W/n(i)·acc``, and the tail's rows alike.  The state
        axis of ``x`` is its last, as in :meth:`_apply_ell`."""
        n, T0, W = self.n_states, self.ell_split[0], self._c_W
        acc = self._zeros(x.shape[:-1] + (self.n_padded,), torch.float64)
        acc = compact_terms(acc, self._c_idx[:T0], x, self._norms)[..., :n]
        y = self._diag[:n] * x + (W * self._c_inv_n[:n]) * acc
        if self._c_tail is not None:
            rows, idx_t = self._c_tail
            acc_t = self._zeros(x.shape[:-1] + rows.shape, torch.float64)
            acc_t = compact_terms(acc_t, idx_t, x, self._norms)
            rows = rows.long()
            y[..., rows] += (W * self._c_inv_n[rows]) * acc_t
        return y

    def _apply_fused(self, x: torch.Tensor):
        """Per row chunk: re-run the structure, gather, multiply, sum the
        row.  Returns (y, out-of-basis count)."""
        n, b = self.n_states, self.batch_size
        col = (slice(None),) + (None,) * (x.ndim - 1)
        y = torch.empty((self.n_padded,) + x.shape[1:], dtype=self._dtype,
                        device=self.device)
        bad = self._zeros((), torch.int64)
        for ci in range(self.num_chunks):
            idx, coeff, invalid = self._chunk_structure(ci)
            g = x[idx]                               # [b, T] + x.shape[1:]
            cb = coeff[..., None] if x.ndim == 2 else coeff
            torch.sum(cb * g, dim=1, out=y[ci * b:(ci + 1) * b])
            bad += invalid
        return y[:n] + self._diag[:n].to(self._dtype)[col] * x, bad

    # -- public API ------------------------------------------------------------

    def matvec(self, x, check: Optional[bool] = None) -> torch.Tensor:
        """y = H·x, or H·X for an [N, k] batch.  ``x`` is a tensor or a
        NumPy array; ``y`` is a tensor on the engine's device, f64 in a
        real sector and complex128 otherwise.

        In fused mode the first call (or ``check=True``) verifies that no
        nonzero matrix element targets a state outside the basis — the
        engine-level halt of the reference (DistributedMatrixVector.chpl
        :113-118); ``check=False`` skips it.  In ell and compact mode that
        check ran at build time.
        """
        x = torch.as_tensor(x).to(self.device, self._dtype)
        if x.ndim not in (1, 2) or x.shape[0] != self.n_states:
            raise ValueError(f"expected [{self.n_states}] or "
                             f"[{self.n_states}, k], got {tuple(x.shape)}")
        note_applying(self)
        try:
            if not obs_enabled():
                return self._matvec_body(x, check)
            return self._matvec_observed(x, check)
        except Exception as e:
            oom_reraise(e, engine="local", mode=self.mode, phase="apply",
                        n_states=int(self.n_states))

    def _matvec_observed(self, x: torch.Tensor, check: Optional[bool]
                         ) -> torch.Tensor:
        """:meth:`_matvec_body` in its ``apply`` span and sampled profile
        window, with the health probes, the watermark and the telemetry
        events (JAX ``_matvec_impl``/``_matvec_inner``)."""
        idx = self._apply_idx
        self._apply_idx += 1
        with obs_trace.span("apply", kind="apply", engine="local",
                            mode=self.mode, apply=idx), \
                obs_profile.sample_window("local", idx, mode=self.mode):
            return self._matvec_inner(x, check, idx)

    def _matvec_inner(self, x: torch.Tensor, check: Optional[bool],
                      idx: int) -> torch.Tensor:
        phases = obs_phases.phases_enabled()
        t0 = time.perf_counter()
        with self.timer.scope("matvec"):
            y = self._matvec_body(x, check)
        # health: fold in the probes earlier applies queued (their copies
        # have landed; nothing waits), then queue this apply's
        obs_health.drain()
        if obs_health.probe_due(idx):
            obs_health.probe_apply("local", y, idx)
        if obs_memory.watermark_due(idx):
            obs_memory.sample_watermark("apply/local", apply=idx)
        if phases and self.device.type == "cuda":
            # the apply's one synchronization: the wall covers its work
            torch.cuda.current_stream(self.device).synchronize()
        dt_ms = (time.perf_counter() - t0) * 1e3
        # the distributed engine's event (bytes = 0: no exchange), so a
        # report reads every engine's applies alike
        emit("matvec_apply", engine="local", apply=idx,
             wall_ms=round(dt_ms, 4), bytes=0)
        if phases:
            k = int(x.shape[1]) if x.ndim == 2 else 1
            obs_phases.emit_apply_phases(
                "local", self.mode, idx, dt_ms, self._phase_counts(k),
                chunks=self.num_chunks if self.mode == "fused" else 1,
                columns=k)
        histogram("matvec_apply_ms", engine="local").observe(dt_ms)
        return y

    def _matvec_body(self, x: torch.Tensor, check: Optional[bool]
                     ) -> torch.Tensor:
        if self.mode in ("ell", "compact"):
            # a batch runs columns-first: gathering a term's entries from
            # [k, N] is k contiguous gathers; gathering k-wide rows of
            # [N, k] made the chain_32_symm apply at k = 4 take 23× the
            # k = 1 time on an H100
            xc = x.T.contiguous() if x.ndim == 2 else x.contiguous()
            apply = self._apply_ell if self.mode == "ell" \
                else self._apply_compact
            y = apply(xc)
            return y.T.contiguous() if x.ndim == 2 else y
        y, bad = self._apply_fused(x.contiguous())
        if check or (check is None and not self._checked):
            self._validate_counter(int(bad))
            self._checked = True
        return y

    def _phase_counts(self, columns: int) -> dict:
        """Structural per-apply counts per phase (``obs/phases.py``) — the
        JAX engine's ``_phase_counts``, equal to its counts for the same
        operator, mode and columns; cached per (mode, columns):

        * ``compute``   one x gather per structure slot (ELL padding
          included: the gather runs for every slot) plus the streamed
          coefficient; fused mode adds the orbit-scan operations;
        * ``accumulate`` the tail rows (ell/compact); zero in fused mode.
        """
        got = self._phase_count_cache.get((self.mode, columns))
        if got is not None:
            return got
        k = max(int(columns), 1)
        cplx = not self.real
        vb = 16 if cplx else 8            # one vector value
        fmul = 8 if cplx else 2           # multiply-add flops per column
        c = obs_phases.zero_counts()
        if self.mode in ("ell", "compact"):
            if self.mode == "ell":
                tail = self._ell_tail
                cfb = 16 if cplx else 8   # the f64/c128 coefficient
            else:
                tail = self._c_tail
                cfb = 4 + 8               # sign-tagged i32 + gathered norm
            T0 = self.ell_split[0]
            g_main = T0 * self.n_padded
            g_tail = int(tail[1].shape[0] * tail[1].shape[1]) if tail else 0
            rows_t = int(tail[0].shape[0]) if tail else 0
            g = g_main + g_tail
            c["compute"] = {"bytes": g * (vb * k + cfb), "gathers": g,
                            "flops": g * k * fmul}
            c["accumulate"] = {"bytes": rows_t * vb * k, "gathers": rows_t,
                               "flops": rows_t * k * (2 if cplx else 1)}
        else:                             # fused: scan + route per apply
            grp = getattr(self.operator.basis, "group", None)
            G = max(len(grp), 1) if grp is not None else 1
            g = self.n_padded * self.num_terms
            c["compute"] = {"bytes": g * vb * k, "gathers": g,
                            "flops": g * (k * fmul
                                          + G * obs_phases.ORBIT_OPS)}
        self._phase_count_cache[(self.mode, columns)] = c
        return c

    def _validate_counter(self, bad: int) -> None:
        if bad != 0:
            raise RuntimeError(
                f"{bad} generated amplitudes map outside the basis "
                "— operator does not preserve the chosen sector")

    def __call__(self, x):
        return self.matvec(x)

    def memory_arrays(self) -> Dict[str, object]:
        """Every resident tensor group by ledger name (the JAX engine's
        names): the operator term tables, the basis lookup, the padded
        representative/norm rows, the diagonal, and the mode's structure
        tables."""
        out = {"operator_tables": self.tables,
               "lookup": (self._lk_pair, self._lk_dir),
               "basis_rows": (self._alphas, self._norms),
               "diag": self._diag}
        for name, arrs in self.structure_arrays().items():
            out[f"structure/{name}"] = arrs
        return out

    def structure_arrays(self) -> Dict[str, torch.Tensor]:
        """The precomputed-structure tensors by name (empty in fused
        mode): ``idx``/``coeff`` and the tail's ``tail_rows``/``tail_idx``/
        ``tail_coeff`` in ell mode; ``idx``, ``inv_n`` and the tail's
        ``tail_rows``/``tail_idx`` in compact mode."""
        if self.mode == "ell":
            out = {"idx": self._ell_idx, "coeff": self._ell_coeff}
            if self._ell_tail is not None:
                rows, t_idx, t_cf = self._ell_tail
                out.update(tail_rows=rows, tail_idx=t_idx, tail_coeff=t_cf)
            return out
        if self.mode == "compact":
            out = {"idx": self._c_idx, "inv_n": self._c_inv_n}
            if self._c_tail is not None:
                rows, t_idx = self._c_tail
                out.update(tail_rows=rows, tail_idx=t_idx)
            return out
        return {}

    @property
    def ell_nbytes(self) -> int:
        """Device memory held by the precomputed structure (0 in fused
        mode): the summed bytes of :meth:`structure_arrays`."""
        return sum(a.numel() * a.element_size()
                   for a in self.structure_arrays().values())
