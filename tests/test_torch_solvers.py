"""The port's eigensolvers and the streamed engine's multi-column apply
against the JAX package, on the CPU, from identical representatives and
tables.

Tolerances:
* multi-column streamed apply: atol 1e-14 / rtol 1e-12 against the JAX
  streamed engine (the reference's matvec tolerance,
  TestMatrixVectorProduct.chpl:15-16); every column bit-equal to the
  port's rank-1 apply (the same decode and the same ``index_add_`` order);
  ``random_hashed(seed, cols=3)`` within 1e-15 of JAX's (the same draws,
  normalized by another reduction);
* ``lanczos_block``: eigenvalues within 1e-10 of JAX ``lanczos_block`` at
  the same seed, k, block size and basis cap; matvec columns within one
  block step (QR and the dots round differently, so a convergence check
  may fall one step apart);
* selective ``lanczos``: E0 within 1e-10 of JAX ``lanczos(reorth=
  "selective")``, iterations within ``check_every``;
* ``lobpcg``: eigenvalues within 1e-8 of JAX ``lobpcg`` and of dense
  ``eigh``, eigenvector residuals below 1e-6, iterations within 10 % of
  JAX's (the same algorithm, other rounding).
"""

import functools
import importlib
import os

import numpy as np
import pytest
import torch

import distributed_matvec_tpu.parallel.engine as JE
from distributed_matvec_tpu.parallel.distributed import \
    DistributedEngine as JaxStreamed
from distributed_matvec_tpu.solve import lanczos as jax_lanczos
from distributed_matvec_tpu.solve import lanczos_block as jax_lanczos_block
from distributed_matvec_tpu.solve import lobpcg as jax_lobpcg
from distributed_matvec_tpu.utils.config import get_config, update_config
import distributed_matvec_tpu_torch as port
from distributed_matvec_tpu_torch import (DistributedEngine, LocalEngine,
                                          kpm_moments, krylov_evolve,
                                          lanczos, lanczos_block, lobpcg)
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)

from test_operator import build_heisenberg, dense_effective_matrix

SYMS_12 = [([*range(1, 12), 0], 0), ([*reversed(range(12))], 0)]
SYMS_16 = [([*range(1, 16), 0], 0), ([*reversed(range(16))], 0)]
B = 64                                   # several plan chunks


def jax_streamed(op_j):
    prev = get_config().stream_compress
    update_config(stream_compress="lossless")
    try:
        return JaxStreamed(op_j, n_devices=1, mode="streamed", batch_size=B)
    finally:
        update_config(stream_compress=prev)


class Case:
    """One operator in both packages with its engines: ``jl``/``tl`` the
    JAX and port ``LocalEngine`` (ell), ``js``/``ts`` the streamed
    engines, ``h`` the dense effective matrix."""

    def __init__(self, n, hw, inv, syms, streamed=True):
        self.op_j = build_heisenberg(n, hw, inv, syms)
        self.op_j.basis.build()
        self.op_t = operator_from_reference(operator_arrays(self.op_j))
        self.n = self.op_j.basis.number_states
        self.h = dense_effective_matrix(self.op_j)
        self.jl = JE.LocalEngine(self.op_j)
        self.tl = LocalEngine(self.op_t, device="cpu")
        if streamed:
            self.js = jax_streamed(self.op_j)
            self.ts = DistributedEngine(self.op_t, batch_size=B,
                                        device="cpu",
                                        mode="streamed",
                                        stream_compress="lossless")


@pytest.fixture(scope="module")
def chain12():
    return Case(12, 6, 1, SYMS_12)


@pytest.fixture(scope="module")
def chain16():
    return Case(16, 8, 1, SYMS_16)


@pytest.fixture(scope="module")
def chain10():
    return Case(10, 5, None, (), streamed=False)


@pytest.fixture(scope="module")
def ring14_k1():
    """A complex-Hermitian sector (momentum k = 1 of the 14-ring): the
    solvers run natively in complex128."""
    return Case(14, 7, None, [([*range(1, 14), 0], 1)], streamed=False)


# -- the streamed engine's multi-column apply ---------------------------------

@pytest.mark.parametrize("case", ["chain12", "chain16"])
def test_block_apply_matches_jax(case, request):
    c = request.getfixturevalue(case)
    X = np.random.default_rng(3).random((c.n, 3)) - 0.5
    want = np.asarray(c.js.matvec(c.js.to_hashed(X)))
    xh = c.ts.to_hashed(X)
    assert tuple(xh.shape) == (1, c.ts.shard_size, 3)
    got = c.ts.matvec(xh)
    assert tuple(got.shape) == (1, c.ts.shard_size, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-14, rtol=1e-12)
    np.testing.assert_array_equal(c.ts.from_hashed(got),
                                  c.js.from_hashed(got.numpy()))


@pytest.mark.parametrize("case", ["chain12", "chain16"])
def test_block_apply_columns_equal_rank1(case, request):
    c = request.getfixturevalue(case)
    X = c.ts.random_hashed(5, cols=4)
    Y = c.ts.matvec(X)
    for r in range(4):
        assert torch.equal(Y[..., r], c.ts.matvec(X[..., r].contiguous()))


@pytest.mark.parametrize("mode", ["ell", "compact", "fused"])
def test_local_block_apply_columns_equal_rank1(chain16, mode):
    """The block solvers' [N, k] applies on ``LocalEngine``: each column
    bit-equal to the rank-1 apply (ell and compact run the batch
    columns-first), and within 1e-14 of the JAX engine's batch apply."""
    c = chain16
    eng = c.tl if mode == "ell" else LocalEngine(c.op_t, mode=mode,
                                                 batch_size=61,
                                                 device="cpu")
    X = np.random.default_rng(4).random((c.n, 4)) - 0.5
    Y = eng.matvec(X)
    assert Y.is_contiguous() and tuple(Y.shape) == (c.n, 4)
    for r in range(4):
        assert torch.equal(Y[:, r], eng.matvec(X[:, r]))
    np.testing.assert_allclose(Y.numpy(), np.asarray(c.jl.matvec(X)),
                               atol=1e-14, rtol=1e-12)


def test_random_hashed_cols_matches_jax(chain12):
    c = chain12
    got = c.ts.random_hashed(7, cols=3).numpy()
    np.testing.assert_allclose(got, np.asarray(c.js.random_hashed(7, cols=3)),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(np.linalg.norm(got, axis=(0, 1)), 1.0,
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(c.ts.random_hashed(7).numpy(),
                               np.asarray(c.js.random_hashed(7)),
                               rtol=0, atol=1e-15)
    x = c.ts.random_hashed(1)
    y = c.ts.matvec(x)
    assert float(c.ts.dot(x, y)) == pytest.approx(
        float(np.asarray(c.js.dot(x.numpy(), y.numpy()))), abs=1e-14)


def test_block_apply_refuses_other_shapes(chain12):
    ts = chain12.ts
    with pytest.raises(ValueError, match=r"\[1, 128, R\]"):
        ts.matvec(torch.zeros(1, ts.shard_size, 2, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="float64"):
        ts.matvec(torch.zeros(1, ts.shard_size, 2, dtype=torch.float32))


# -- lanczos_block --------------------------------------------------------------

@pytest.mark.parametrize("case,k,p,cap", [
    ("chain12", 2, 2, None), ("chain12", 3, 3, 14), ("chain16", 2, 3, None),
    ("chain16", 1, 2, 12), ("ring14_k1", 2, 2, None)])
def test_lanczos_block_local_matches_jax(case, k, p, cap, request):
    c = request.getfixturevalue(case)
    kw = dict(k=k, block_size=p, max_iters=400, tol=1e-11, seed=3,
              max_basis_size=cap)
    want = jax_lanczos_block(c.jl.matvec, c.n, **kw)
    got = lanczos_block(c.tl.matvec, c.n, compute_eigenvectors=True,
                        device="cpu", **kw)
    # chain_12's 35 states: the Krylov space may close before the bound
    # meets tol, in both packages alike
    assert got.converged == want.converged
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(got.eigenvalues,
                               np.linalg.eigvalsh(c.h)[:k], rtol=0,
                               atol=1e-9)
    assert abs(got.num_iters - want.num_iters) <= p
    assert got.restarts == want.restarts
    if cap is not None:
        assert got.restarts > 0
    for lam, v in zip(got.eigenvalues, got.eigenvectors):
        assert float(torch.linalg.vector_norm(c.tl.matvec(v) - lam * v)) \
            < 1e-8


@pytest.mark.parametrize("cap", [None, 12])
def test_lanczos_block_streamed_matches_jax(chain16, cap):
    c = chain16
    kw = dict(k=2, block_size=2, max_iters=400, tol=1e-11, seed=4,
              max_basis_size=cap)
    want = jax_lanczos_block(c.js.matvec, **kw)
    before = c.ts.n_applies
    got = lanczos_block(c.ts.matvec, compute_eigenvectors=True, **kw)
    assert got.converged and want.converged
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=0,
                               atol=1e-10)
    assert abs(got.num_iters - want.num_iters) <= 2
    # one multi-column apply per block step
    assert c.ts.n_applies - before == got.num_iters // 2
    v = got.eigenvectors[0]
    assert tuple(v.shape) == (1, c.ts.shard_size)
    r = c.ts.matvec(v) - got.eigenvalues[0] * v
    assert float(torch.linalg.vector_norm(r)) < 1e-8


def test_lanczos_block_column_targets_match_jax(chain16):
    c = chain16
    targets = [{"k": 1, "tol": 1e-6, "job_id": "a"},
               {"k": 2, "tol": 1e-11, "job_id": "b"},
               {"k": 1, "tol": 1e-10, "max_iters": 12, "job_id": "c"}]
    kw = dict(block_size=3, max_iters=400, seed=5)
    want = jax_lanczos_block(c.jl.matvec, c.n, column_targets=targets, **kw)
    got = lanczos_block(c.tl.matvec, c.n, column_targets=targets,
                        compute_eigenvectors=True, device="cpu", **kw)
    assert got.converged == want.converged
    for g, w in zip(got.column_results, want.column_results):
        assert (g["job_id"], g["k"], g["converged"]) == \
            (w["job_id"], w["k"], w["converged"])
        np.testing.assert_allclose(g["eigenvalues"], w["eigenvalues"],
                                   rtol=0, atol=1e-10)
        assert abs(g["iters"] - w["iters"]) <= 3
        assert len(g["eigenvectors"]) == g["k"]


# -- selective lanczos ----------------------------------------------------------

@pytest.mark.parametrize("case,k,cap", [
    ("chain16", 1, None), ("chain16", 3, 20), ("chain10", 2, None),
    ("chain10", 1, 18), ("ring14_k1", 1, None)])
def test_lanczos_selective_matches_jax(case, k, cap, request):
    c = request.getfixturevalue(case)
    kw = dict(k=k, max_iters=400, tol=1e-11, seed=2, max_basis_size=cap)
    want = jax_lanczos(c.jl.matvec, c.n, reorth="selective", **kw)
    got = lanczos(c.tl.matvec, c.n, reorth="selective", device="cpu", **kw)
    full = lanczos(c.tl.matvec, c.n, reorth="full", device="cpu", **kw)
    assert got.converged and want.converged and full.converged
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(got.eigenvalues, full.eigenvalues, rtol=0,
                               atol=1e-10)
    assert abs(got.num_iters - want.num_iters) <= 16
    # "full" sweeps every block; "selective" fewer
    if cap is None:
        assert full.full_sweeps == -(-full.num_iters // 16)
    assert got.full_sweeps < full.full_sweeps
    assert lanczos(c.tl.matvec, c.n, device="cpu", **kw).full_sweeps == \
        got.full_sweeps                       # the default is selective


def test_omega_gate_redoes_blocks():
    """A tight ω budget forces the fallback: the window block is redone
    with the full sweep and the solve still lands E0."""
    L = importlib.import_module("distributed_matvec_tpu_torch.solve.lanczos")
    c = Case(16, 8, 1, SYMS_16, streamed=False)
    ref = lanczos(c.tl.matvec, c.n, reorth="full", tol=1e-11, device="cpu")
    prev = L._OMEGA_SQRT_EPS
    L._OMEGA_SQRT_EPS = 1e-300
    try:
        got = lanczos(c.tl.matvec, c.n, tol=1e-11, device="cpu")
    finally:
        L._OMEGA_SQRT_EPS = prev
    assert got.full_sweeps == -(-got.num_iters // 16)
    np.testing.assert_allclose(got.eigenvalues, ref.eigenvalues, rtol=0,
                               atol=1e-10)


def test_omega_tracker_matches_jax():
    from distributed_matvec_tpu.solve.lanczos import _OmegaTracker as JO
    from distributed_matvec_tpu_torch.solve.lanczos import _OmegaTracker as TO

    rng = np.random.default_rng(0)
    a, b = rng.standard_normal(40), rng.random(40) + 0.5
    tj, tt = JO(), TO()
    for m in (16, 32, 40):
        assert tt.advance(a, b, m) == tj.advance(a, b, m)
    tj.reset(20)
    tt.reset(20)
    assert tt.advance(a, b, 36) == tj.advance(a, b, 36)


# -- lobpcg ----------------------------------------------------------------------

@pytest.mark.parametrize("case,engine", [
    ("chain10", "local"), ("chain16", "local"), ("chain16", "streamed")])
def test_lobpcg_matches_jax_and_dense(case, engine, request):
    """The JAX solver runs ``LocalEngine`` (its ``lobpcg_standard`` traces
    the matvec, which a streamed engine cannot give), so the streamed
    solve — in the flat hashed space, another dimension — is held to the
    JAX local solve's eigenvalues, not to its iteration count."""
    c = request.getfixturevalue(case)
    te = c.tl if engine == "local" else c.ts
    kw = dict(k=3, max_iters=300, tol=1e-13, seed=2)
    we, _, wit = jax_lobpcg(c.jl.matvec, c.n, **kw)
    ge, gv, git = lobpcg(te.matvec, c.n, device="cpu", **kw)
    np.testing.assert_allclose(ge, we, rtol=0, atol=1e-8)
    np.testing.assert_allclose(ge, np.linalg.eigvalsh(c.h)[:3], rtol=0,
                               atol=1e-8)
    if engine == "local":
        assert abs(git - wit) <= max(1, 0.1 * wit)
    assert tuple(gv.shape) == (c.n, 3)
    for i in range(3):
        v = gv[:, i].numpy()
        assert np.linalg.norm(c.op_j.matvec_host(v) - ge[i] * v) < 1e-6


def test_lobpcg_iteration_matches_jax_standard():
    """The translated iteration against jax's ``lobpcg_standard`` on one
    symmetric matrix: eigenvalues and iteration counts."""
    import jax.numpy as jnp
    from jax.experimental.sparse.linalg import lobpcg_standard

    from distributed_matvec_tpu_torch.solve.lobpcg import _lobpcg_standard

    rng = np.random.default_rng(1)
    A = rng.standard_normal((60, 60))
    A = A + A.T
    X = rng.standard_normal((60, 4))
    At = torch.from_numpy(A)
    wt, Ut, it = _lobpcg_standard(lambda x: At @ x, torch.from_numpy(X),
                                  m=200, tol=1e-12)
    wj, Uj, ij = lobpcg_standard(jnp.asarray(A), jnp.asarray(X), m=200,
                                 tol=1e-12)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(wt.numpy(), np.linalg.eigvalsh(A)[::-1][:4],
                               rtol=0, atol=1e-9)
    assert abs(it - int(ij)) <= max(1, 0.1 * int(ij))


def test_lobpcg_refuses_complex_sector():
    op = build_heisenberg(10, 5, None, [([*range(1, 10), 0], 1)])
    op.basis.build()
    eng = LocalEngine(operator_from_reference(operator_arrays(op)),
                      device="cpu")
    with pytest.raises(ValueError, match="real sectors"):
        lobpcg(eng.matvec, op.basis.number_states, k=1, device="cpu")


# -- refusals ----------------------------------------------------------------------

def test_checkpoint_path_not_implemented(chain12, tmp_path):
    """``checkpoint_path`` was refused before the solvers' checkpoints were
    ported; it now writes a checkpoint, and a rerun on the same path
    resumes from it to the same eigenvalues (tests/test_torch_checkpoint.py
    holds the resumes against the JAX solvers)."""
    c = chain12
    ck = str(tmp_path / "ck.h5")
    ref = lanczos(c.tl.matvec, c.n, device="cpu", check_every=4)
    first = lanczos(c.tl.matvec, c.n, device="cpu", check_every=4,
                    checkpoint_path=ck, checkpoint_every=1)
    assert os.path.exists(ck) and first.resumed_from == 0
    again = lanczos(c.tl.matvec, c.n, device="cpu", check_every=4,
                    checkpoint_path=ck, checkpoint_every=1)
    assert again.resumed_from > 0
    np.testing.assert_allclose(again.eigenvalues, ref.eigenvalues,
                               rtol=0, atol=1e-10)
    ck2 = str(tmp_path / "lobpcg.h5")
    w0, _, it0 = lobpcg(c.tl.matvec, c.n, device="cpu",
                        checkpoint_path=ck2, checkpoint_every=2)
    assert os.path.exists(ck2)
    w1, _, it1 = lobpcg(c.tl.matvec, c.n, device="cpu",
                        checkpoint_path=ck2, checkpoint_every=2)
    assert it1 >= it0
    np.testing.assert_allclose(w1, w0, rtol=0, atol=1e-8)


def test_unknown_reorth_policy(chain12):
    with pytest.raises(ValueError, match="reorth"):
        lanczos(chain12.tl.matvec, chain12.n, device="cpu", reorth="some")


def test_lanczos_block_needs_n_or_engine():
    with pytest.raises(ValueError, match="pass V0 or n"):
        lanczos_block(lambda x: x, k=1, device="cpu")


def test_solvers_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lanczos_block(lambda x: x, n=20, k=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lobpcg(lambda x: x, 20, k=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.lanczos(lambda v: v, n=4, reorth="full")
    # a start block that is already a tensor fixes the device
    X = torch.from_numpy(np.random.default_rng(0).random((20, 2)))
    res = lanczos_block(lambda x: x * torch.arange(
        1.0, 21.0, dtype=torch.float64)[:, None], V0=X, k=1, max_iters=40)
    assert res.eigenvalues[0] == pytest.approx(1.0)


SYMS_14 = [([*range(1, 14), 0], 0), ([*reversed(range(14))], 0)]


@pytest.fixture(scope="module")
def chain14_tiers():
    """chain_14 in its symmetric sector (85 states): the smallest chain
    whose bf16 streamed operator led the selective ``lanczos`` to a
    spurious E0 (−194.9 against −23.83), with the dense E0 of the JAX
    operator, and the port's streamed engine per tier."""
    op_j = build_heisenberg(14, 7, 1, SYMS_14)
    op_j.basis.build()
    op_t = operator_from_reference(operator_arrays(op_j), device="cpu")
    e0 = float(np.linalg.eigvalsh(dense_effective_matrix(op_j))[0])
    engines = {tier: DistributedEngine(op_t, mode="streamed", batch_size=B,
                                       stream_compress=tier, device="cpu")
               for tier in ("lossless", "f32", "bf16")}
    return e0, engines


@pytest.mark.parametrize("tier,rel", [("f32", 1e-6), ("bf16", 1e-2)])
def test_lanczos_on_quantized_tier_finds_e0(chain14_tiers, tier, rel):
    """On an ``f32``/``bf16`` streamed engine the operator is Hermitian
    only to the tier's rounding: ``lanczos`` with no ``reorth`` runs the
    full sweep there (bit-equal to ``reorth="full"``) and finds E0 within
    the tier's bound of the exact one (the selective scheme's ω estimate
    misses the loss of orthogonality and converged to −194.9 on bf16);
    an explicit ``reorth="selective"`` raises, naming the tier."""
    e0, engines = chain14_tiers
    eng = engines[tier]
    res = lanczos(eng.matvec, v0=eng.random_hashed(0), k=1, tol=1e-10,
                  device="cpu")
    full = lanczos(eng.matvec, v0=eng.random_hashed(0), k=1, tol=1e-10,
                   reorth="full", device="cpu")
    assert res.converged
    assert res.eigenvalues[0] == full.eigenvalues[0]
    assert res.num_iters == full.num_iters
    assert abs(res.eigenvalues[0] - e0) <= rel * abs(e0)
    with pytest.raises(ValueError, match=f"stream_compress='{tier}'.*"
                                         "reorth='full'"):
        lanczos(eng.matvec, v0=eng.random_hashed(0), k=1,
                reorth="selective", device="cpu")


def test_lanczos_keeps_selective_on_lossless(chain14_tiers):
    """A lossless streamed engine keeps the selective default: the same
    iterations and E0 bits as an explicit ``reorth="selective"``, and
    fewer full sweeps than blocks."""
    e0, engines = chain14_tiers
    eng = engines["lossless"]
    res = lanczos(eng.matvec, v0=eng.random_hashed(0), k=1, tol=1e-10,
                  device="cpu")
    sel = lanczos(eng.matvec, v0=eng.random_hashed(0), k=1, tol=1e-10,
                  reorth="selective", device="cpu")
    assert res.eigenvalues[0] == sel.eigenvalues[0]
    assert res.num_iters == sel.num_iters
    assert res.full_sweeps == sel.full_sweeps < res.num_iters // 16
    assert abs(res.eigenvalues[0] - e0) < 1e-10


WRAPS = {
    "lambda": lambda eng: (lambda v: eng.matvec(v)),
    "shift": lambda eng: (lambda v: eng.matvec(v) - 0.5 * v),
    "partial": lambda eng: functools.partial(eng.matvec, check=None),
}


@pytest.mark.parametrize("wrap", sorted(WRAPS))
@pytest.mark.parametrize("tier", ["f32", "bf16"])
def test_wrapped_quantized_matvec_raises(chain14_tiers, tier, wrap):
    """ROADMAP Queue 3 item 1, the quantized probe: a wrapped bf16 engine's
    matvec hid the engine from ``lanczos``, which then ran the selective
    scheme and returned −194.874 (the bound method: −23.823).  Now the
    solver meets the engine at its first apply and raises, naming the
    engine and the bound matvec; every solver alike."""
    e0, engines = chain14_tiers
    eng = engines[tier]
    mv = WRAPS[wrap](eng)
    M = eng.shard_size
    calls = {"n": 0}

    def counted(v):
        calls["n"] += 1
        return mv(v)

    for solve in (
            lambda: lanczos(counted, v0=eng.random_hashed(0), k=1,
                            tol=1e-10, device="cpu"),
            # flat [M, p] blocks through a reshaping wrapper
            lambda: lanczos_block(
                lambda X: counted(X.reshape(1, M, -1)).reshape(M, -1),
                k=1, block_size=2, device="cpu",
                V0=eng.random_hashed(0, cols=2).reshape(M, 2)),
            lambda: kpm_moments(counted, n_moments=8,
                                V0=eng.random_hashed(0, cols=1),
                                bounds=(-30.0, 10.0), device="cpu"),
            lambda: krylov_evolve(counted, psi0=eng.random_hashed(0),
                                  t_final=0.1, device="cpu")):
        calls["n"] = 0
        with pytest.raises(ValueError, match=f"stream_compress='{tier}'.*"
                                             "bound eng.matvec"):
            solve()
        assert calls["n"] == 1                  # after the first apply
    # the bound method is untouched: the repaired value
    res = lanczos(eng.matvec, v0=eng.random_hashed(0), k=1, tol=1e-10,
                  device="cpu")
    assert abs(res.eigenvalues[0] - e0) <= 1e-2 * abs(e0)


def test_wrapped_lossless_and_local_matvecs_still_run(chain14_tiers):
    """Wrapping an engine the guard does not concern (lossless streamed,
    ``LocalEngine``) keeps working: the same E0 bits and iterations as the
    bound method."""
    e0, engines = chain14_tiers
    eng = engines["lossless"]
    ref = lanczos(eng.matvec, v0=eng.random_hashed(0), k=1, tol=1e-10,
                  device="cpu")
    got = lanczos(lambda v: eng.matvec(v), v0=eng.random_hashed(0), k=1,
                  tol=1e-10, device="cpu")
    assert got.eigenvalues[0] == ref.eigenvalues[0]
    assert got.num_iters == ref.num_iters
    assert abs(got.eigenvalues[0] - e0) < 1e-10
