"""The whole slice: the port's streamed engine and Lanczos against the JAX
package, on the CPU, from identical representatives and tables.

Tolerances:
* plan arrays (``dest``/``ridx``/``rok`` word streams, the codes) and the
  codec spec: bit-exact — both packages run the same integer routing and
  the same host encode; the dictionary values are bit-exact too, because
  the port's orbit-scan norms and coefficient products keep the JAX
  operation order (see test_torch_kernels.py);
* matvec: atol 1e-14 / rtol 1e-12, the reference's tolerance
  (TestMatrixVectorProduct.chpl:15-16) — the receive-side sums run in
  another order (``index_add_`` into y instead of a per-chunk
  ``segment_sum``);
* ground-state energy: 1e-10 against the JAX ``lanczos`` on the same
  operator (the start vectors differ, so only eigenvalues are compared),
  and the N=16 ring anchor E0/4 = −7.1422963606 to its printed digits.
"""

import numpy as np
import pytest
import torch

from distributed_matvec_tpu.models.lattices import heisenberg_chain as jax_chain
from distributed_matvec_tpu.parallel.distributed import \
    DistributedEngine as JaxEngine
from distributed_matvec_tpu.parallel.engine import LocalEngine
from distributed_matvec_tpu.solve import lanczos as jax_lanczos
from distributed_matvec_tpu.utils.config import update_config
from distributed_matvec_tpu_torch import DistributedEngine, lanczos
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)
from distributed_matvec_tpu_torch.models.lattices import heisenberg_chain

N16_E0_OVER_4 = -7.1422963606


@pytest.fixture(scope="module",
                params=[(12, None), (16, None), (32, 4)],
                ids=["chain_12_symm", "chain_16_symm", "chain_32_hw4_symm"])
def engines(request):
    n, hw = request.param
    op_j = jax_chain(n, hw, symmetric=True)
    op_j.basis.build()
    update_config(stream_compress="lossless")
    try:
        e_j = JaxEngine(op_j, n_devices=1, mode="streamed", batch_size=64)
    finally:
        update_config(stream_compress="off")
    op_t = operator_from_reference(operator_arrays(op_j), device="cpu")
    e_t = DistributedEngine(op_t, batch_size=64, device="cpu",
                            mode="streamed", stream_compress="lossless")
    return op_j, e_j, e_t


def test_plan_bit_exact(engines):
    _, e_j, e_t = engines
    assert e_t._codec.spec == e_j._codec.spec
    np.testing.assert_array_equal(e_t._codec.dicts[0], e_j._codec.dicts[0])
    np.testing.assert_array_equal(e_t._cdict[0].numpy(),
                                  e_j._codec.dict_device_row(0))
    assert e_t.nchunks == len(e_j._plan_chunks)
    for ci in range(e_t.nchunks):
        got = e_t.plan_chunk(ci)
        want = e_j._plan_chunks[ci][0]
        for k in ("dest", "ridx", "rok", "coeff"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert e_t.plan_bytes == e_j.plan_bytes
    assert e_t.plan_bytes_raw == e_j.plan_bytes_raw


def test_matvec_matches_jax(engines):
    op_j, e_j, e_t = engines
    rng = np.random.default_rng(3)
    x = rng.random(op_j.basis.number_states) - 0.5
    want = np.asarray(e_j.matvec_global(x))
    got = e_t.matvec_global(x)
    np.testing.assert_allclose(got, want, atol=1e-14, rtol=1e-12)
    # hashed layouts agree too
    np.testing.assert_array_equal(e_t.to_hashed(x).numpy(),
                                  np.asarray(e_j.to_hashed(x)))


def test_lanczos_matches_jax(engines):
    op_j, _, e_t = engines
    n = op_j.basis.number_states
    want = jax_lanczos(LocalEngine(op_j).matvec, n, k=1, tol=1e-11)
    got = lanczos(e_t.matvec, v0=e_t.random_hashed(0), k=1, tol=1e-11,
                  device="cpu")
    assert got.converged and want.converged
    assert abs(got.eigenvalues[0] - want.eigenvalues[0]) < 1e-10


def test_port_enumeration_and_tables_reproduce_reference():
    """The port's own lattice constructor and enumeration give the arrays the
    JAX package gives, and carrying them across changes nothing."""
    op_j = jax_chain(16, symmetric=True)
    op_j.basis.build()
    op_t = heisenberg_chain(16, symmetric=True)
    op_t.basis.build()
    want = operator_arrays(op_j)
    got = operator_arrays(op_t)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    again = operator_arrays(operator_from_reference(got))
    for k in want:
        np.testing.assert_array_equal(again[k], want[k], err_msg=k)


def test_n16_anchor_end_to_end():
    """README-style library use on the port alone: build → engine →
    Lanczos reproduces the N=16 ring ground state."""
    op = heisenberg_chain(16, symmetric=True)
    eng = DistributedEngine(op, batch_size=64, device="cpu",
                            mode="streamed", stream_compress="lossless")
    # "full": one apply per iteration (the selective default redoes a
    # block whose ω estimate crosses √ε, applying its steps again)
    res = lanczos(eng.matvec, v0=eng.random_hashed(1), k=1, device="cpu",
                  compute_eigenvectors=True, reorth="full")
    assert res.converged
    assert abs(res.eigenvalues[0] / 4 - N16_E0_OVER_4) < 1e-9
    v = res.eigenvectors[0]
    resid = eng.matvec(v) - res.eigenvalues[0] * v
    assert float(torch.linalg.vector_norm(resid)) < 1e-8
    assert eng.n_applies == res.num_iters + 1
    x = np.random.default_rng(5).random(op.basis.number_states) - 0.5
    np.testing.assert_allclose(eng.matvec_global(x), op.matvec_host(x),
                               atol=1e-14, rtol=1e-12)
    assert isinstance(eng.to_hashed(x), torch.Tensor)
