"""The port's ``LocalEngine`` and complex-Hermitian Lanczos against the JAX
package, on the CPU, from identical representatives and tables.

Tolerances:
* structure tables of a real sector (``structure_arrays()`` and the split
  point T0): bit-exact, for the one-pass and the low-memory ELL build and
  for compact mode — both packages run the same integer lookup, the same
  stable left-pack and the same coefficient products in the same order;
* complex-sector tables: indices bit-exact, coefficients within 1e-15
  absolute (XLA's and torch's complex products need not round alike);
* matvec: atol 1e-14 / rtol 1e-12, the reference's tolerance
  (TestMatrixVectorProduct.chpl:15-16);
* ground-state energies: 1e-10 against the JAX ``lanczos`` on the same
  operator.
"""

import numpy as np
import pytest
import torch

import distributed_matvec_tpu.parallel.engine as JE
from distributed_matvec_tpu.solve import lanczos as jax_lanczos
from distributed_matvec_tpu.solve.lanczos import _rand_like as jax_rand_like
from distributed_matvec_tpu.utils.config import get_config, update_config
import distributed_matvec_tpu_torch.parallel.engine as TE
from distributed_matvec_tpu_torch import LocalEngine, lanczos
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)
from distributed_matvec_tpu_torch.entry import entry
from distributed_matvec_tpu_torch.solve.lanczos import _rand_like

from test_operator import CONFIGS, build_heisenberg

ATOL, RTOL = 1e-14, 1e-12
B = 61                                   # chunking and padding engage

_T10 = [*range(1, 10), 0]
_T12 = [*range(1, 12), 0]
_R12 = list(range(11, -1, -1))

#: structure cases: name → (n, hw, inv, syms)
STRUCTURE = {
    # the hamming sector: skewed rows, so the split and the tail engage
    "chain_16_hw8": (16, 8, None, ()),
    "chain_12_symm": (12, 6, 1, [(_T12, 0), (_R12, 0)]),
}
COMPLEX = {
    "chain_10_k1": (10, 5, None, [(_T10, 1)]),
    "chain_12_k2": (12, 6, None, [(_T12, 2)]),
}


def _ops(n, hw, inv, syms):
    op_j = build_heisenberg(n, hw, inv, syms)
    op_j.basis.build()
    return op_j, operator_from_reference(operator_arrays(op_j))


def _jax_engine(op_j, budget=None, **kw):
    prev = get_config().ell_build_budget_gb
    if budget is not None:
        update_config(ell_build_budget_gb=budget)
    try:
        return JE.LocalEngine(op_j, batch_size=B, **kw)
    finally:
        update_config(ell_build_budget_gb=prev)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# -- structure tables ---------------------------------------------------------

@pytest.mark.parametrize("budget", [None, 1e-9], ids=["one_pass", "lowmem"])
@pytest.mark.parametrize("case", sorted(STRUCTURE))
def test_ell_structure_bit_exact(case, budget):
    op_j, op_t = _ops(*STRUCTURE[case])
    e_j = _jax_engine(op_j, budget, mode="ell")
    e_t = LocalEngine(op_t, batch_size=B, mode="ell", device="cpu",
                      **({} if budget is None else
                         {"build_budget_gb": budget}))
    assert e_t.low_memory_build == (budget is not None)
    assert e_t.ell_split[0] == e_j._ell_T0
    want, got = e_j.structure_arrays(), e_t.structure_arrays()
    assert sorted(got) == sorted(want)
    for k in want:
        assert _np(got[k]).dtype == _np(want[k]).dtype, k
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)
    if case == "chain_16_hw8":
        T0, S, Tmax = e_t.ell_split
        assert T0 < e_t.num_terms and S > 0 and "tail_rows" in got
        assert e_t.ell_nbytes == 12 * (T0 * e_t.n_padded + S * (Tmax - T0)) \
            + 4 * S


@pytest.mark.parametrize("budget", [None, 1e-9], ids=["one_pass", "lowmem"])
@pytest.mark.parametrize("case", sorted(COMPLEX))
def test_complex_structure_matches(case, budget):
    op_j, op_t = _ops(*COMPLEX[case])
    e_j = _jax_engine(op_j, budget, mode="ell")
    assert not e_j.pair
    e_t = LocalEngine(op_t, batch_size=B, mode="ell", device="cpu",
                      **({} if budget is None else
                         {"build_budget_gb": budget}))
    assert not e_t.real and e_t.ell_split[0] == e_j._ell_T0
    want, got = e_j.structure_arrays(), e_t.structure_arrays()
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = _np(got[k]), _np(want[k])
        assert g.dtype == w.dtype, k
        if g.dtype == np.complex128:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-15, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("case", sorted(STRUCTURE))
def test_compact_structure_bit_exact(case):
    op_j, op_t = _ops(*STRUCTURE[case])
    e_j = _jax_engine(op_j, mode="compact")
    e_t = LocalEngine(op_t, batch_size=B, mode="compact", device="cpu")
    assert e_t.ell_split[0] == e_j._ell_T0
    want, got = e_j.structure_arrays(), e_t.structure_arrays()
    want.pop("n_parts")                  # the split-gather table, not ported
    assert sorted(got) == sorted(want)
    for k in want:
        assert _np(got[k]).dtype == _np(want[k]).dtype, k
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)
    if case == "chain_16_hw8":
        assert "tail_rows" in got


@pytest.mark.parametrize("seed", range(6))
def test_choose_ell_split_matches_jax(seed):
    rng = np.random.default_rng(seed)
    T = int(rng.integers(1, 40))
    hist = rng.integers(0, 1000, T + 1) * (rng.random(T + 1) < 0.6)
    hist[0] += int(rng.integers(0, 3000))            # padded rows
    n_rows = int(hist.sum())
    real_rows = n_rows - int(hist[0]) + int(rng.integers(0, hist[0] + 1))
    for rr in (None, real_rows):
        assert TE.choose_ell_split(hist, n_rows, T, rr) == \
            JE.choose_ell_split(hist, n_rows, T, rr)


# -- matvec -------------------------------------------------------------------

def _modes(cfg):
    real = not any(s for _, s in cfg[3])
    return ["ell", "fused"] + (["compact"] if real else [])


@pytest.mark.parametrize("n,hw,inv,syms,mode", [
    (*cfg, mode) for cfg in CONFIGS for mode in _modes(cfg)])
def test_matvec_matches_jax(n, hw, inv, syms, mode):
    op_j, op_t = _ops(n, hw, inv, syms)
    e_j = _jax_engine(op_j, mode=mode)
    e_t = LocalEngine(op_t, batch_size=B, mode=mode, device="cpu")
    assert e_t.real == op_j.effective_is_real
    N = op_j.basis.number_states
    rng = np.random.default_rng(n)
    x = rng.random(N) - 0.5
    X = rng.random((N, 3)) - 0.5
    if not e_t.real:
        x = x + 1j * (rng.random(N) - 0.5)
        X = X + 1j * (rng.random((N, 3)) - 0.5)
    for v in (x, X):
        got = e_t.matvec(v)
        assert isinstance(got, torch.Tensor) and got.shape == v.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(e_j.matvec(v)),
                                   atol=ATOL, rtol=RTOL)
    # a tensor in gives the same as NumPy in
    np.testing.assert_array_equal(e_t(torch.from_numpy(x)).numpy(),
                                  e_t.matvec(x).numpy())


def test_entry_matches_jax():
    import __graft_entry__ as ge

    step_j, (x_j,) = ge.entry()
    step_t, (x_t,) = entry(device="cpu")
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    np.testing.assert_allclose(step_t(x_t).numpy(), np.asarray(step_j(x_j)),
                               atol=ATOL, rtol=RTOL)


# -- refusals -----------------------------------------------------------------

def _sector_violation():
    from distributed_matvec_tpu.models.basis import SpinBasis
    from distributed_matvec_tpu.models.operator import Operator

    basis = SpinBasis(6, 3)
    op_j = Operator.from_expressions(basis, [("σˣ₀", [[0], [1]])])
    basis.build()
    return op_j, operator_from_reference(operator_arrays(op_j))


@pytest.mark.parametrize("mode", ["ell", "compact"])
def test_out_of_basis_raises_at_build(mode):
    op_j, op_t = _sector_violation()
    for make in (lambda: JE.LocalEngine(op_j, mode=mode),
                 lambda: LocalEngine(op_t, mode=mode, device="cpu")):
        with pytest.raises(RuntimeError, match="outside the basis"):
            make()
    with pytest.raises(RuntimeError, match="outside the basis"):
        LocalEngine(op_t, mode=mode, build_budget_gb=1e-9, device="cpu")


def test_out_of_basis_raises_on_first_fused_call():
    op_j, op_t = _sector_violation()
    x = np.ones(op_j.basis.number_states)
    e_t = LocalEngine(op_t, mode="fused", device="cpu")
    e_t.matvec(x, check=False)                 # the check can be skipped
    with pytest.raises(RuntimeError, match="outside the basis"):
        e_t.matvec(x)
    with pytest.raises(RuntimeError, match="outside the basis"):
        JE.LocalEngine(op_j, mode="fused").matvec(x)


def test_compact_refusals(monkeypatch):
    from distributed_matvec_tpu.models.basis import SpinBasis
    from distributed_matvec_tpu.models.lattices import (chain_edges,
                                                        heisenberg_from_edges)

    b = SpinBasis(8, 4)
    aniso = heisenberg_from_edges(b, chain_edges(8)) + 0.44 * \
        heisenberg_from_edges(b, [(i, (i + 2) % 8) for i in range(8)])
    b.build()
    op_j, op_t = _ops(*COMPLEX["chain_10_k1"])
    for op, match in ((aniso, "single off-diagonal magnitude"),
                      (op_j, "real sector")):
        port_op = operator_from_reference(operator_arrays(op))
        for make in (lambda: JE.LocalEngine(op, mode="compact"),
                     lambda: LocalEngine(port_op, mode="compact",
                                         device="cpu")):
            with pytest.raises(ValueError, match=match):
                make()
    # entries that break the ±W·n(j)/n(i) form: a wrong W fails the pack
    op_j, op_t = _ops(*STRUCTURE["chain_12_symm"])
    monkeypatch.setattr(JE, "compact_magnitude", lambda op: 3.0)
    monkeypatch.setattr(TE, "compact_magnitude", lambda op: 3.0)
    for make in (lambda: JE.LocalEngine(op_j, mode="compact"),
                 lambda: LocalEngine(op_t, mode="compact", device="cpu")):
        with pytest.raises(RuntimeError, match="violate the ±W"):
            make()


def test_non_hermitian_and_mode_refusals():
    from distributed_matvec_tpu.models.basis import SpinBasis
    from distributed_matvec_tpu.models.operator import Operator

    basis = SpinBasis(4, 2)
    op_j = Operator.from_expressions(basis, [("σ⁺₀ σ⁻₁", [[0, 1]])])
    basis.build()
    op_t = operator_from_reference(operator_arrays(op_j))
    assert not op_t.is_hermitian
    with pytest.raises(ValueError, match="Hermitian"):
        LocalEngine(op_t, device="cpu")
    _, op_t = _ops(8, 4, None, ())
    with pytest.raises(ValueError, match="DistributedEngine"):
        LocalEngine(op_t, mode="streamed", device="cpu")
    with pytest.raises(ValueError, match="unknown engine mode"):
        LocalEngine(op_t, mode="dense", device="cpu")


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, op_t = _ops(8, 4, None, ())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalEngine(op_t)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lanczos(lambda v: v, n=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    assert LocalEngine(op_t, device="cpu").device.type == "cpu"


# -- Lanczos ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_start_vector_is_the_jax_one(dtype):
    np.testing.assert_array_equal(_rand_like(37, dtype, 5),
                                  jax_rand_like((37,), dtype, 5))


LANCZOS = {
    "chain_16_symm": (16, 8, 1, [([*range(1, 16), 0], 0),
                                 (list(range(15, -1, -1)), 0)]),
    "chain_12_k1": (12, 6, None, [(_T12, 1)]),
}


@pytest.mark.parametrize("case", sorted(LANCZOS))
def test_lanczos_matches_jax(case):
    op_j, op_t = _ops(*LANCZOS[case])
    n = op_j.basis.number_states
    want = jax_lanczos(JE.LocalEngine(op_j).matvec, n, k=1, tol=1e-11)
    eng = LocalEngine(op_t, device="cpu")
    got = lanczos(eng.matvec, n, k=1, tol=1e-11, device="cpu")
    assert got.converged and want.converged
    assert abs(got.eigenvalues[0] - want.eigenvalues[0]) < 1e-10


@pytest.mark.parametrize("case", sorted(LANCZOS))
def test_lanczos_two_pairs_with_eigenvectors(case):
    op_j, op_t = _ops(*LANCZOS[case])
    n = op_j.basis.number_states
    want = jax_lanczos(JE.LocalEngine(op_j).matvec, n, k=2, tol=1e-11)
    eng = LocalEngine(op_t, mode="fused", device="cpu")
    got = lanczos(eng.matvec, n, k=2, tol=1e-11, device="cpu",
                  compute_eigenvectors=True, max_basis_size=16)
    assert got.converged and want.converged
    assert got.num_iters > 16                    # thick restarts ran
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues,
                               rtol=0, atol=1e-10)
    want_dtype = torch.float64 if eng.real else torch.complex128
    for lam, v in zip(got.eigenvalues, got.eigenvectors):
        assert v.dtype == want_dtype and v.shape == (n,)
        assert abs(float(torch.linalg.vector_norm(v)) - 1.0) < 1e-12
        assert float(torch.linalg.vector_norm(eng.matvec(v) - lam * v)) \
            < 1e-8


def test_lanczos_dtype_follows_v0_or_argument():
    _, op_t = _ops(*COMPLEX["chain_10_k1"])
    eng = LocalEngine(op_t, mode="ell", device="cpu")
    n = eng.n_states
    base = lanczos(eng.matvec, n, k=1, device="cpu")
    v0 = _rand_like(n, np.complex128, 0)
    for kw in ({"v0": v0}, {"v0": torch.from_numpy(v0)},
               {"n": n, "dtype": torch.complex128}):
        res = lanczos(eng.matvec, k=1, device="cpu", **kw)
        assert res.num_iters == base.num_iters
        assert res.eigenvalues[0] == base.eigenvalues[0]
    # a real solver on a complex operator is refused, not truncated
    with pytest.raises(ValueError, match="complex128"):
        lanczos(eng.matvec, n, k=1, device="cpu", dtype=torch.float64)
