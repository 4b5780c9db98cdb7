"""The port's dynamics solvers (KPM, Krylov time evolution) and bound
observables against the JAX package, on the CPU, from identical
representatives and tables.

Tolerances:
* ``spectral_bounds``: within 1e-10 of JAX's (the same recurrence from the
  same start vector; the dots round differently);
* ``kpm_moments`` with the same start block and bounds: within 1e-11 of
  JAX's moments and of the dense-matrix recurrence on the same block
  (``test_dynamics._dense_moments_same_vectors``); streamed moments within
  1e-11 of ``LocalEngine`` moments on the same block in block order;
* kernels, ``reconstruct_dos`` and ``exact_moments``: bit-equal (copied
  host NumPy);
* ``kpm_spectral_function``: within 1e-10;
* ``krylov_evolve``: accepted step times equal to JAX's, final state within
  1e-10 of JAX's and within 1e-9 of dense ``scipy.linalg.expm``;
* ``expectation_value``: within 1e-12 of JAX's;
* over a ``DistributedEngine`` at D = 2 and 4 (``bind_observables``
  binding ``fused``, ``ell`` or ``compact`` engines on the solve engine's
  shards and layout, complex sectors through ``ell``/``fused``):
  expectation values within 1e-12 of the JAX function's at the same D and
  mode, ``kpm_spectral_function`` through a bound observable and
  ``krylov_evolve``'s observable series within 1e-10, LOBPCG within 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm

import distributed_matvec_tpu.parallel.engine as JE
from distributed_matvec_tpu.models import observables as jax_obs
from distributed_matvec_tpu.parallel.distributed import \
    DistributedEngine as JaxDistributed
from distributed_matvec_tpu.solve import lobpcg as jax_lobpcg
from distributed_matvec_tpu.solve import kpm as jax_kpm
from distributed_matvec_tpu.solve import krylov_evolve as jax_evolve
from distributed_matvec_tpu.solve.lanczos import _rand_like
from distributed_matvec_tpu_torch import (DistributedEngine, LocalEngine,
                                          kpm_dos, kpm_moments,
                                          kpm_spectral_function,
                                          krylov_evolve, lobpcg,
                                          spectral_bounds)
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)
from distributed_matvec_tpu_torch.models import observables as obs
from distributed_matvec_tpu_torch.solve import kpm

from test_dynamics import _dense_moments_same_vectors
from test_operator import build_heisenberg, dense_effective_matrix
from test_torch_solvers import SYMS_12, Case

T8 = [([*range(1, 8), 0], 1)]            # k = 1 of the 8-ring: complex


@pytest.fixture(scope="module")
def chain12():
    return Case(12, 6, 1, SYMS_12)


@pytest.fixture(scope="module")
def ring8_k1():
    """A complex-Hermitian sector: (JAX engine, port engine, dense H)."""
    op_j = build_heisenberg(8, 4, None, T8)
    op_j.basis.build()
    op_t = operator_from_reference(operator_arrays(op_j))
    return (JE.LocalEngine(op_j), LocalEngine(op_t, device="cpu"),
            dense_effective_matrix(op_j))


def _unit(shape, dtype, seed):
    v = _rand_like(shape, dtype, seed)
    return v / np.linalg.norm(v, axis=0, keepdims=True)


# -- spectral bounds and moments ----------------------------------------------

def test_spectral_bounds_match_jax(chain12):
    """20 steps, well short of the 35-state space: near its dimension the
    unreorthogonalized recurrence amplifies rounding in both packages."""
    c = chain12
    want = jax_kpm.spectral_bounds(c.jl.matvec, n=c.n, iters=20, seed=3)
    got = spectral_bounds(c.tl.matvec, n=c.n, iters=20, seed=3,
                          device="cpu")
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-10)
    assert got[2] == want[2] == 20
    w = np.linalg.eigvalsh(c.h)
    assert got[0] < w[0] and got[1] > w[-1]
    # the streamed engine draws its own start vector, as JAX's does
    want_s = jax_kpm.spectral_bounds(c.js.matvec, iters=20, seed=3)
    got_s = spectral_bounds(c.ts.matvec, iters=20, seed=3)
    np.testing.assert_allclose(got_s[:2], want_s[:2], rtol=0, atol=1e-10)


def test_kpm_moments_match_jax_and_dense(chain12):
    c = chain12
    V0 = _unit((c.n, 3), np.float64, 2)
    bounds = (-24.0, 14.0)
    want = jax_kpm.kpm_moments(c.jl.matvec, 64, V0=jnp.asarray(V0),
                               bounds=bounds)
    got = kpm_moments(c.tl.matvec, 64, V0=torch.from_numpy(V0),
                      bounds=bounds)
    np.testing.assert_allclose(got.moments, want.moments, rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(got.moment_stderr, want.moment_stderr,
                               rtol=0, atol=1e-11)
    ref = _dense_moments_same_vectors(c.h.real, got.scale, V0, 64)
    np.testing.assert_allclose(got.moments, ref, rtol=0, atol=1e-11)
    assert got.moments[0] == pytest.approx(1.0, abs=1e-15)
    assert got.num_applies == want.num_applies == 32
    assert got.scale == want.scale and got.bounds == want.bounds


def test_kpm_moments_seeded_draw_matches_jax(chain12):
    """No V0 and no bounds: the seeded block and the Lanczos bracket."""
    c = chain12
    want = jax_kpm.kpm_moments(c.jl.matvec, 48, n=c.n, n_vectors=3, seed=5,
                               bounds_iters=24)
    got = kpm_moments(c.tl.matvec, 48, n=c.n, n_vectors=3, seed=5,
                      bounds_iters=24, device="cpu")
    np.testing.assert_allclose(got.bounds, want.bounds, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.moments, want.moments, rtol=0,
                               atol=1e-11)
    assert got.num_applies == want.num_applies


def test_kpm_streamed_matches_local_same_block(chain12):
    c = chain12
    V0 = _unit((c.n, 2), np.float64, 11)
    bounds = (-24.0, 14.0)
    before = c.ts.n_applies
    r_s = kpm_moments(c.ts.matvec, 32, V0=c.ts.to_hashed(V0),
                      bounds=bounds)
    r_l = kpm_moments(c.tl.matvec, 32, V0=torch.from_numpy(V0),
                      bounds=bounds)
    np.testing.assert_allclose(r_s.moments, r_l.moments, rtol=0,
                               atol=1e-11)
    # one [1, M, 2] apply per recurrence step
    assert c.ts.n_applies - before == r_s.num_applies == 16


def test_kpm_streamed_seeded_block_matches_jax(chain12):
    c = chain12
    want = jax_kpm.kpm_moments(c.js.matvec, 24, n_vectors=3, seed=6,
                               bounds_iters=16)
    got = kpm_moments(c.ts.matvec, 24, n_vectors=3, seed=6,
                      bounds_iters=16)
    np.testing.assert_allclose(got.bounds, want.bounds, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.moments, want.moments, rtol=0,
                               atol=1e-11)


def test_kpm_complex_sector_matches_jax(ring8_k1):
    je, te, h = ring8_k1
    n = h.shape[0]
    V0 = _unit((n, 2), np.float64, 3)
    want = jax_kpm.kpm_moments(je.matvec, 32, V0=jnp.asarray(V0),
                               bounds_iters=12)
    got = kpm_moments(te.matvec, 32, V0=torch.from_numpy(V0),
                      bounds_iters=12)
    np.testing.assert_allclose(got.moments, want.moments, rtol=0,
                               atol=1e-11)


@pytest.mark.parametrize("name,args", [
    ("jackson_kernel", (64,)), ("jackson_kernel", (7,)),
    ("lorentz_kernel", (64,)), ("lorentz_kernel", (33, 2.5))])
def test_kernels_bit_equal(name, args):
    np.testing.assert_array_equal(getattr(kpm, name)(*args),
                                  getattr(jax_kpm, name)(*args))


@pytest.mark.parametrize("kernel", ["jackson", "lorentz", "none"])
def test_reconstruct_dos_and_exact_moments_bit_equal(kernel):
    rng = np.random.default_rng(8)
    evals = np.sort(rng.uniform(-3.0, 2.0, 40))
    scale = (2.7, -0.45)
    mu = kpm.exact_moments(evals, scale, 50)
    np.testing.assert_array_equal(mu, jax_kpm.exact_moments(evals, scale,
                                                            50))
    for kw in ({"npoints": 200}, {"energies": np.linspace(-4, 3, 77)}):
        got = kpm.reconstruct_dos(mu, scale, kernel=kernel, **kw)
        want = jax_kpm.reconstruct_dos(mu, scale, kernel=kernel, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="unknown KPM kernel"):
        kpm.reconstruct_dos(mu, scale, kernel="gauss")


def test_kpm_dos_matches_jax(chain12):
    c = chain12
    want = jax_kpm.kpm_dos(c.jl.matvec, 96, n=c.n, n_vectors=6, seed=4)
    got = kpm_dos(c.tl.matvec, 96, n=c.n, n_vectors=6, seed=4,
                  device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-10)
    mass = np.trapezoid(got[1], got[0])
    assert abs(mass - 1.0) < 0.02, mass


def test_kpm_spectral_function_matches_jax(chain12):
    c = chain12
    psi = _unit((c.n,), np.float64, 9)
    bj = jax_obs.bind_observables([c.op_j], c.jl)[0]
    bt = obs.bind_observables([c.op_t], c.tl)[0]
    want = jax_kpm.kpm_spectral_function(c.jl.matvec, jnp.asarray(psi),
                                         bj.matvec, n_moments=64,
                                         bounds_iters=20)
    got = kpm_spectral_function(c.tl.matvec, torch.from_numpy(psi),
                                bt.matvec, n_moments=64, bounds_iters=20)
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)


# -- Krylov time evolution ------------------------------------------------------

def test_krylov_evolve_matches_jax_and_expm(chain12):
    c = chain12
    psi0 = _unit((c.n,), np.float64, 7)
    kw = dict(t_final=2.0, tol=1e-12, krylov_dim=20)
    want = jax_evolve(c.jl.matvec, psi0=jnp.asarray(psi0), **kw)
    got = krylov_evolve(c.tl.matvec, psi0=torch.from_numpy(psi0), **kw)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_allclose(got.psi.numpy(), np.asarray(want.psi),
                               rtol=0, atol=1e-10)
    ref = expm(-2.0j * c.h) @ psi0
    np.testing.assert_allclose(got.psi.numpy(), ref, rtol=0, atol=1e-9)
    assert got.num_applies == want.num_applies
    assert got.num_rejects == want.num_rejects
    np.testing.assert_allclose(got.energies, want.energies, rtol=0,
                               atol=1e-10)
    assert got.norm_drift < 1e-12 * got.num_steps
    assert got.energy_drift < 1e-11


def test_krylov_evolve_streamed_two_column_path(chain12):
    """A complex state on the streamed engine rides the [1, M, 2] block:
    one apply per Krylov vector."""
    c = chain12
    psi0 = _unit((c.n,), np.float64, 9)
    kw = dict(t_final=1.0, tol=1e-12, krylov_dim=16)
    want = jax_evolve(c.js.matvec, psi0=c.js.to_hashed(psi0), **kw)
    before = c.ts.n_applies
    got = krylov_evolve(c.ts.matvec, psi0=c.ts.to_hashed(psi0), **kw)
    assert c.ts.n_applies - before == got.num_applies
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_allclose(got.psi.numpy(), np.asarray(want.psi),
                               rtol=0, atol=1e-10)
    ref = expm(-1.0j * c.h) @ psi0
    np.testing.assert_allclose(c.ts.from_hashed(got.psi.real)
                               + 1j * c.ts.from_hashed(got.psi.imag), ref,
                               rtol=0, atol=1e-9)


def test_krylov_evolve_complex_sector_native(ring8_k1):
    je, te, h = ring8_k1
    psi0 = _unit((h.shape[0],), np.complex128, 3)
    kw = dict(t_final=1.0, tol=1e-12, krylov_dim=16)
    want = jax_evolve(je.matvec, psi0=jnp.asarray(psi0), **kw)
    got = krylov_evolve(te.matvec, psi0=torch.from_numpy(psi0), **kw)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_allclose(got.psi.numpy(), np.asarray(want.psi),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.psi.numpy(), expm(-1.0j * h) @ psi0,
                               rtol=0, atol=1e-9)


def test_krylov_evolve_observables_and_budget(chain12):
    c = chain12
    bo = obs.bind_observables([c.op_t], c.tl)
    res = krylov_evolve(c.tl.matvec, n=c.n, t_final=1.0, tol=1e-12,
                        krylov_dim=16, seed=2, observables=bo,
                        device="cpu")
    series = res.observables[bo[0].name]
    assert len(series) == res.num_steps + 1
    vals = np.array([v for _, v in series])
    # <H> is conserved under exp(-iHt)
    np.testing.assert_allclose(vals, vals[0], rtol=0, atol=1e-10)
    np.testing.assert_allclose(vals[0], res.energies[0], rtol=1e-12)
    part = krylov_evolve(c.tl.matvec, n=c.n, t_final=1.0, tol=1e-12,
                         krylov_dim=16, seed=2, max_steps=2, device="cpu")
    assert part.num_steps == 2 and part.times[-1] < 1.0
    np.testing.assert_array_equal(part.times, res.times[:3])


# -- observables ------------------------------------------------------------------

def test_expectation_values_match_jax(chain12, ring8_k1):
    c = chain12
    bj = jax_obs.bind_observables([c.op_j], c.jl)[0]
    bt = obs.bind_observables([c.op_t], c.tl)[0]
    assert bt.engine.mode == "fused"
    for psi in (_unit((c.n,), np.float64, 3),
                _unit((c.n,), np.complex128, 4)):
        want = bj.expectation(jnp.asarray(psi))
        assert bt.expectation(torch.from_numpy(psi)) == pytest.approx(
            want, abs=1e-12)
        assert obs.expectations([c.op_t], c.tl, psi)[0][1] == \
            pytest.approx(want, abs=1e-12)
        dense = float(np.real(psi.conj() @ (c.h @ psi)))
        assert bt.expectation(psi) == pytest.approx(dense, abs=1e-12)
    je, te, h = ring8_k1
    psi = _unit((h.shape[0],), np.complex128, 2)
    want = jax_obs.expectation_value(je, jnp.asarray(psi))
    got = obs.expectation_value(te, torch.from_numpy(psi))
    assert got == pytest.approx(want, abs=1e-12)
    assert obs._complex_native(te) and not obs._complex_native(c.tl)


def test_expectation_values_streamed(chain12):
    c = chain12
    bj = jax_obs.bind_observables([c.op_j], c.jl)[0]
    # bound over the streamed engine: fused by default, as the JAX
    # function binds, on the solve engine's (shared) layout; streamed too
    for mode in (None, "streamed"):
        bt = obs.bind_observables([c.op_t], c.ts, **(
            {"mode": mode} if mode else {}))[0]
        assert bt.engine.mode == (mode or "fused")
        assert bt.engine.shard_size == c.ts.shard_size
        assert bt.engine.layout is c.ts.layout
        for psi in (_unit((c.n,), np.float64, 5),
                    _unit((c.n,), np.complex128, 6)):
            psi_h = torch.complex(c.ts.to_hashed(psi.real),
                                  c.ts.to_hashed(psi.imag)) \
                if np.iscomplexobj(psi) else c.ts.to_hashed(psi)
            assert bt.expectation(psi_h) == pytest.approx(
                bj.expectation(jnp.asarray(psi)), abs=1e-12)


# -- observables bound over the sharded engine (D > 1) ---------------------------

SHARDED = [(D, m) for D in (2, 4) for m in ("fused", "ell", "compact")]


@pytest.fixture(scope="module")
def sharded12(chain12):
    """chain12's solve engines at D = 2 and 4 (ell) in both packages."""
    c = chain12
    return {D: (JaxDistributed(c.op_j, n_devices=D, mode="ell",
                               batch_size=32),
                DistributedEngine(c.op_t, n_devices=D, mode="ell",
                                  batch_size=32, device="cpu"))
            for D in (2, 4)}


@pytest.mark.parametrize("D,mode", SHARDED)
def test_bound_observables_sharded_match_jax(chain12, sharded12, D, mode):
    c = chain12
    je, te = sharded12[D]
    bj = jax_obs.bind_observables([c.op_j], je, mode=mode)[0]
    bt = obs.bind_observables([c.op_t], te, mode=mode)[0]
    assert (bt.engine.mode, bt.engine.n_devices) == (mode, D)
    assert bt.engine.layout is te.layout
    assert bt.engine.batch_size == te.batch_size
    for psi in (_unit((c.n,), np.float64, 3),
                _unit((c.n,), np.complex128, 4)):
        want = bj.expectation(je.to_hashed(psi))
        got = bt.expectation(te.to_hashed(psi))
        assert got == pytest.approx(want, abs=1e-12)
        dense = float(np.real(psi.conj() @ (c.h @ psi)))
        assert got == pytest.approx(dense, abs=1e-12)
        assert obs.expectations([c.op_t], te, te.to_hashed(psi),
                                mode=mode)[0][1] == pytest.approx(want,
                                                                  abs=1e-12)
    # the dynamical structure factor through the bound observable
    psi = _unit((c.n,), np.float64, 9)
    want = jax_kpm.kpm_spectral_function(
        je.matvec, je.to_hashed(psi), bj.matvec, n_moments=32,
        bounds=(-24.0, 14.0))
    got = kpm_spectral_function(te.matvec, te.to_hashed(psi), bt.matvec,
                                n_moments=32, bounds=(-24.0, 14.0))
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[2].moments, want[2].moments, rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("D", [2, 4])
def test_evolve_and_lobpcg_sharded_match_jax(chain12, sharded12, D):
    """krylov_evolve with a bound observable, and LOBPCG, through the
    one-process engine at D shards, against the JAX engine at the same D."""
    c = chain12
    je, te = sharded12[D]
    bj = jax_obs.bind_observables([c.op_j], je)
    bt = obs.bind_observables([c.op_t], te)
    psi0 = _unit((c.n,), np.float64, 7)
    kw = dict(t_final=1.0, tol=1e-12, krylov_dim=16)
    want = jax_evolve(je.matvec, psi0=je.to_hashed(psi0), observables=bj,
                      **kw)
    got = krylov_evolve(te.matvec, psi0=te.to_hashed(psi0), observables=bt,
                        **kw)
    np.testing.assert_array_equal(got.times, want.times)
    name = bt[0].name
    series_t = np.array([v for _, v in got.observables[name]])
    series_j = np.array([v for _, v in want.observables[bj[0].name]])
    np.testing.assert_allclose(series_t, series_j, rtol=0, atol=1e-10)
    # <H> is conserved under exp(-iHt)
    np.testing.assert_allclose(series_t, series_t[0], rtol=0, atol=1e-10)
    ref = expm(-1.0j * c.h) @ psi0
    np.testing.assert_allclose(te.from_hashed(got.psi.real)
                               + 1j * te.from_hashed(got.psi.imag), ref,
                               rtol=0, atol=1e-9)
    ev_j, _, _ = jax_lobpcg(je.matvec, c.n, k=2, tol=1e-12)
    ev_t, vecs, _ = lobpcg(te.matvec, c.n, k=2, tol=1e-12)
    np.testing.assert_allclose(ev_t, np.asarray(ev_j), rtol=0, atol=1e-8)
    np.testing.assert_allclose(ev_t, np.linalg.eigvalsh(c.h)[:2], rtol=0,
                               atol=1e-8)
    assert vecs.shape == (c.n, 2)


@pytest.mark.parametrize("D,mode", [(D, m) for D in (2, 4)
                                    for m in ("ell", "fused")])
def test_bound_observables_complex_sector_sharded(ring8_k1, D, mode):
    """A complex sector binds over ell or fused, and its expectation
    values equal the JAX function's at the same D; the streamed engine
    binds it too and gives the same value."""
    je_l, _, h = ring8_k1
    op_j = je_l.operator
    op_t = operator_from_reference(operator_arrays(op_j))
    je = JaxDistributed(op_j, n_devices=D, mode="ell", batch_size=16)
    te = DistributedEngine(op_t, n_devices=D, mode="ell", batch_size=16,
                           device="cpu")
    bj = jax_obs.bind_observables([op_j], je, mode=mode)[0]
    bt = obs.bind_observables([op_t], te, mode=mode)[0]
    assert bt.engine.mode == mode and not bt.engine.real
    psi = _unit((h.shape[0],), np.complex128, 2)
    want = bj.expectation(je.to_hashed(psi))
    got = bt.expectation(te.to_hashed(psi))
    assert got == pytest.approx(want, abs=1e-12)
    assert got == pytest.approx(float(np.real(psi.conj() @ (h @ psi))),
                                abs=1e-12)
    bs = obs.bind_observables([op_t], te, mode="streamed")[0]
    assert bs.engine.stream_kernel == "torch" and not bs.engine.real
    assert bs.expectation(te.to_hashed(psi)) == pytest.approx(want,
                                                              abs=1e-12)


# -- refusals ----------------------------------------------------------------------

def test_dynamics_refusals(chain12):
    c = chain12
    with pytest.raises(ValueError, match="n_moments must be >= 2"):
        kpm_moments(c.tl.matvec, 1, n=c.n, device="cpu")
    with pytest.raises(ValueError, match="n_vectors must be >= 1"):
        kpm_moments(c.tl.matvec, 8, n=c.n, n_vectors=0, device="cpu")
    with pytest.raises(ValueError, match="t_final must be > 0"):
        krylov_evolve(c.tl.matvec, n=c.n, t_final=0.0, device="cpu")
    with pytest.raises(ValueError, match="pass V0 or n"):
        kpm_moments(lambda x: x, 8, device="cpu")
    with pytest.raises(ValueError, match="pass v0 or n"):
        spectral_bounds(lambda x: x, device="cpu")
    with pytest.raises(ValueError, match="pass psi0 or n"):
        krylov_evolve(lambda x: x, device="cpu")
    for call in (lambda: kpm_moments(c.tl.matvec, 8, n=c.n, device="cpu",
                                     checkpoint_path="k.h5"),
                 lambda: kpm_dos(c.tl.matvec, 8, n=c.n, device="cpu",
                                 checkpoint_path="k.h5"),
                 lambda: krylov_evolve(c.tl.matvec, n=c.n, device="cpu",
                                       checkpoint_path="e.h5")):
        with pytest.raises(NotImplementedError, match="checkpoint"):
            call()


def test_dynamics_need_a_card_unless_asked(monkeypatch, chain12):
    c = chain12
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: spectral_bounds(c.tl.matvec, n=c.n),
                 lambda: kpm_moments(c.tl.matvec, 8, n=c.n),
                 lambda: kpm_dos(c.tl.matvec, 8, n=c.n),
                 lambda: krylov_evolve(c.tl.matvec, n=c.n)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for, or fixed by a start tensor, the CPU runs
    assert kpm_moments(c.tl.matvec, 4, n=c.n, device="cpu",
                       bounds=(-24.0, 14.0)).moments[0] == pytest.approx(
                           1.0, abs=1e-15)
    psi = torch.from_numpy(_unit((c.n,), np.float64, 1))
    assert krylov_evolve(c.tl.matvec, psi0=psi, t_final=0.1).psi.device \
        == psi.device
