"""The ELL apply's wrapper (``ops/ell_apply.py``) on the CPU: its plain
version against the engines' former columns-first arithmetic and the
operator's host matvec, and every operand the CUDA kernel does not take.

The tables are ``LocalEngine``'s, over ``test_operator.CONFIGS`` at
``batch_size=61`` (so ``N_pad > n`` and the ``[:T0, :n]`` slices are read
in place), real as built and complexified with random phases; the tail is
the engine's own or, to make sure one is there, a synthetic one (unique
random rows, random terms).

Tolerances: in a real sector the wrapper equals the former arithmetic bit
for bit (``torch.equal``: the same products in the same order); complex
products within rtol 1e-14 / atol 1e-13 (values of order 10), because the
CPU's complex multiply rounds differently in its vectorized loop and in
the broadcast one that the columns-first layout took; against the host
matvec atol 1e-14 / rtol 1e-12, the reference's tolerance.  The kernel
itself runs only on a card: ``tests/test_torch_cuda.py``.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_matvec_tpu_torch import LocalEngine
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)
from distributed_matvec_tpu_torch.ops.ell_apply import (ell_apply,
                                                        ell_apply_plain)

from test_operator import CONFIGS, build_heisenberg

B = 61


@functools.lru_cache(maxsize=None)
def _engine(case: int):
    op_j = build_heisenberg(*CONFIGS[case])
    op_j.basis.build()
    op = operator_from_reference(operator_arrays(op_j))
    return LocalEngine(op, batch_size=B, mode="ell", device="cpu")


def _ell_terms(y, x, idx, coeff):
    """The engines' former apply: ``y += Σ_t coeff[t]·x[idx[t]]`` term by
    term, gathering along the last (state) axis of ``x``."""
    for t in range(idx.shape[0]):
        y += coeff[t] * torch.index_select(x, -1, idx[t])
    return y


def _former(x, diag, idx, coeff, tail):
    """``ell_terms`` plus the tail, columns-first as the engines ran it,
    on a state-major ``x``; returns ``y`` state-major."""
    xc = x if x.ndim == 1 else x.T.contiguous()
    n = idx.shape[1]
    y = _ell_terms(diag.to(x.dtype) * xc[..., :n], xc, idx, coeff)
    if tail is not None:
        rows, t_idx, t_cf = tail
        acc = _ell_terms(torch.zeros(xc.shape[:-1] + rows.shape,
                                     dtype=x.dtype), xc, t_idx, t_cf)
        y[..., rows.long()] += acc
    return y if x.ndim == 1 else y.T.contiguous()


def _same(y, want):
    """Bit for bit where real; see the module's note on complex."""
    if y.is_complex():
        torch.testing.assert_close(y, want, rtol=1e-14, atol=1e-13)
    else:
        assert torch.equal(y, want)


def _operands(eng, rng, cplx, R, tail, extra_rows=0):
    """The engine's tables (complexified where ``cplx``), a state-major
    ``x`` of ``n + extra_rows`` rows and ``R`` columns (``[n]`` at
    ``R = 0``), and the tail: None, the engine's own, or synthetic."""
    n, T0 = eng.n_states, eng.ell_split[0]
    idx = eng._ell_idx[:T0, :n]
    coeff = eng._ell_coeff[:T0, :n]
    dtype = torch.complex128 if cplx or not eng.real else torch.float64
    if coeff.dtype != dtype:
        phase = torch.from_numpy(np.exp(1j * rng.uniform(0, 2 * np.pi,
                                                         coeff.shape)))
        coeff = coeff.to(dtype) * phase
    rows_x = n + extra_rows
    shape = (rows_x,) if R == 0 else (rows_x, R)
    x = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    if dtype == torch.complex128:
        x = x + 1j * torch.from_numpy(rng.standard_normal(shape))
    if extra_rows:
        # some terms gather from the rows past n, as a shard's [x; R] does
        hit = torch.from_numpy(rng.random(idx.shape) < 0.3)
        idx = torch.where(hit, torch.from_numpy(rng.integers(
            n, rows_x, idx.shape)).to(torch.int32), idx)
    if tail == "engine":
        t = eng._ell_tail
        if t is not None and t[2].dtype != dtype:
            t = (t[0], t[1], t[2].to(dtype))
    elif tail == "synthetic":
        S, Tw = max(1, n // 5), 3
        rows = torch.from_numpy(np.sort(rng.choice(n, S, replace=False))
                                ).to(torch.int32)
        t_idx = torch.from_numpy(rng.integers(0, rows_x, (Tw, S))
                                 ).to(torch.int32)
        t_cf = torch.from_numpy(rng.standard_normal((Tw, S))).to(dtype)
        t = (rows, t_idx, t_cf)
    else:
        t = None
    return x, eng._diag[:n], idx, coeff, t


@pytest.mark.parametrize("tail", [None, "synthetic"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("R", [1, 3, 4])
@pytest.mark.parametrize("case", range(len(CONFIGS)))
def test_wrapper_equals_former_apply(case, R, cplx, tail):
    eng = _engine(case)
    rng = np.random.default_rng(100 * case + 10 * R + cplx)
    args = _operands(eng, rng, cplx, R, tail)
    y = ell_apply(*args)
    assert y.shape == (eng.n_states, R) and y.dtype == args[0].dtype
    _same(y, _former(*args))
    assert torch.equal(y, ell_apply_plain(*args))


@pytest.mark.parametrize("R", [0, 1, 3, 4])
@pytest.mark.parametrize("case", range(len(CONFIGS)))
def test_wrapper_is_the_operator(case, R):
    """The engine's own tables and tail, column by column against the
    host matvec of the operator (``R = 0``: a rank-1 ``x``)."""
    eng = _engine(case)
    rng = np.random.default_rng(case + 7 * R)
    x, *rest = _operands(eng, rng, False, R, "engine")
    y = ell_apply(x, *rest)
    assert y.shape == x.shape
    cols = [x] if R == 0 else list(x.T)
    ys = [y] if R == 0 else list(y.T)
    for xc, yc in zip(cols, ys):
        ref = eng.operator.matvec_host(xc.numpy())
        np.testing.assert_allclose(yc.numpy(), ref, atol=1e-14, rtol=1e-12)


@pytest.mark.parametrize("R", [1, 4])
def test_wrapper_gathers_past_n(R):
    """``x`` with rows beyond ``n`` (a shard's ``[x; received]``): the
    diagonal reads ``x[:n]``, the terms and the tail gather anywhere."""
    eng = _engine(len(CONFIGS) - 1)
    rng = np.random.default_rng(R)
    args = _operands(eng, rng, False, R, "synthetic", extra_rows=9)
    y = ell_apply(*args)
    assert y.shape == (eng.n_states, R)
    _same(y, _former(*args))


def test_engine_tail_is_exercised():
    """One of the configurations has an engine tail, so the ``engine``
    cases above cover a real split."""
    assert any(_engine(c)._ell_tail is not None for c in range(len(CONFIGS)))


def test_cpu_apply_launches_nothing():
    eng = _engine(3)
    before = ell_apply.launches
    eng.matvec(np.ones(eng.n_states))
    eng.matvec(np.ones((eng.n_states, 4)))
    assert ell_apply.launches == before


def _refusals():
    """Name → a change to the good operands that the kernel does not take,
    and the words of the error."""
    def x_(f):
        return lambda a: (f(a[0]),) + a[1:]

    def at(i, f):
        return lambda a: a[:i] + (f(a[i]),) + a[i + 1:]

    return {
        "x_float32": (x_(lambda x: x.to(torch.float32)), "float64"),
        "x_int64": (x_(lambda x: x.to(torch.int64)), "float64"),
        "x_columns_first": (x_(lambda x: x.T.contiguous().T), "contiguous"),
        "x_strided": (x_(lambda x: torch.cat([x, x], 1)[:, ::2]),
                      "contiguous"),
        "x_3d": (x_(lambda x: x[None]), "contiguous"),
        "x_short": (x_(lambda x: x[:-1].contiguous()), "rows"),
        "idx_int64": (at(2, lambda i: i.to(torch.int64)), "idx"),
        "idx_transposed": (at(2, lambda i: i.T.contiguous().T), "idx"),
        "idx_1d": (at(2, lambda i: i[0]), "idx"),
        "coeff_float32": (at(3, lambda c: c.to(torch.float32)), "coeff"),
        "coeff_complex": (at(3, lambda c: c.to(torch.complex128)),
                          "coeff"),
        "coeff_fewer_terms": (at(3, lambda c: c[:-1]), "terms"),
        "coeff_narrow": (at(3, lambda c: c[:, :-1]), "coeff"),
        "diag_float32": (at(1, lambda d: d.to(torch.float32)), "diag"),
        "diag_short": (at(1, lambda d: d[:-1]), "diag"),
        "tail_rows_int64": (at(4, lambda t: (t[0].long(),) + t[1:]),
                            "tail rows"),
        "tail_idx_int64": (at(4, lambda t: (t[0], t[1].long(), t[2])),
                           "tail idx"),
        "tail_coeff_mismatch": (at(4, lambda t: t[:2] + (t[2][:, :-1],)),
                                "tail coeff"),
        "tail_coeff_float32": (at(4, lambda t: t[:2] + (
            t[2].to(torch.float32),)), "tail coeff"),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_wrapper_refuses(name):
    eng = _engine(len(CONFIGS) - 1)
    good = _operands(eng, np.random.default_rng(0), False, 4, "synthetic")
    ell_apply(*good)
    change, words = _refusals()[name]
    with pytest.raises(ValueError, match=words):
        ell_apply(*change(good))
