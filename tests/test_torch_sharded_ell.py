"""The hash-sharded engine at D > 1 with the static routing plan, ell and
compact: the port's ``DistributedEngine`` (D shards in one process, on the
CPU) against the JAX ``DistributedEngine`` on the virtual CPU mesh, at the
same D, mode and ``batch_size``.

Tolerances:
* the plan — per-shard query lists ``qin``, ELL index and coefficient
  tables, sign tags, the tail, the exchanged norms, T0 and the query
  capacity: bit-exact — both run the same host build on bit-identical
  coefficients and norms;
* matvec: atol 1e-14 / rtol 1e-12, the reference's tolerance
  (TestMatrixVectorProduct.chpl:15-16);
* a block apply's columns equal rank-1 applies bit for bit in real sectors
  (the same gathers, multiplies and adds per column) and at the matvec
  tolerance in complex ones (the CPU's vectorized complex multiply may
  round a column of a block otherwise);
* eigenvalues: 1e-10 against the JAX solver on the same operator.
"""

import numpy as np
import pytest
import torch

from distributed_matvec_tpu.models.basis import SpinBasis as JaxBasis
from distributed_matvec_tpu.models.lattices import (
    chain_edges as jax_chain_edges,
    heisenberg_from_edges as jax_heisenberg)
from distributed_matvec_tpu.parallel.distributed import \
    DistributedEngine as JaxEngine
from distributed_matvec_tpu.parallel.engine import LocalEngine as JaxLocal
from distributed_matvec_tpu.solve import lanczos as jax_lanczos
from distributed_matvec_tpu_torch import DistributedEngine, lanczos
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)
from distributed_matvec_tpu_torch.models.basis import SpinBasis
from distributed_matvec_tpu_torch.models.lattices import (
    chain_edges, heisenberg_from_edges)

from test_operator import build_heisenberg

ATOL, RTOL = 1e-14, 1e-12

#: (n, hw, inv, syms, D, batch_size): the shapes of
#: test_engine_distributed.DIST_CONFIGS (the complex-character sector
#: included), and the 16-site chain whose ELL split leaves a tail
CONFIGS = {
    "chain_8_d2": (8, 4, None, (), 2, 16),
    "chain_10_d4": (10, 5, None, (), 4, 16),
    "chain_12_d8": (12, 6, None, (), 8, 32),
    "chain_10_inv_d8": (10, 5, -1, (), 8, 16),
    "chain_12_symm_d8": (12, 6, 1, [([*range(1, 12), 0], 0)], 8, 16),
    "chain_10_k1_d4": (10, 5, None, [([*range(1, 10), 0], 1)], 4, 16),
    "chain_16_d4": (16, 8, None, (), 4, 512),
}

CASES = [(c, m) for c in sorted(CONFIGS) for m in ("ell", "compact")
         if not (m == "compact" and c == "chain_10_k1_d4")]

#: the structure arrays the two packages share (JAX's compact ``n_parts``
#: is its split-gather form, a TPU workaround the port does not carry)
_KEYS = {"ell": ("idx", "coeff", "qin", "tail_rows", "tail_idx",
                 "tail_coeff"),
         "compact": ("idx", "qin", "inv_n", "norms_all", "tail_rows",
                     "tail_idx")}


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{c}-{m}" for c, m in CASES])
def engines(request):
    name, mode = request.param
    n, hw, inv, syms, D, B = CONFIGS[name]
    op_j = build_heisenberg(n, hw, inv, syms)
    op_j.basis.build()
    e_j = JaxEngine(op_j, n_devices=D, mode=mode, batch_size=B)
    op_t = operator_from_reference(operator_arrays(op_j), device="cpu")
    e_t = DistributedEngine(op_t, n_devices=D, mode=mode, batch_size=B,
                            device="cpu")
    return op_j, e_j, e_t


def _x(op, seed, cols=None):
    rng = np.random.default_rng(seed)
    shape = (op.basis.number_states,) + ((cols,) if cols else ())
    x = rng.random(shape) - 0.5
    if not op.effective_is_real:
        x = x + 1j * (rng.random(shape) - 0.5)
    return x


def test_plan_tables_bit_exact(engines):
    _, e_j, e_t = engines
    assert e_t._ell_T0 == e_j._ell_T0
    assert e_t.query_capacity == e_j.query_capacity
    want = e_j.structure_arrays()
    got = e_t.structure_arrays()
    keys = [k for k in _KEYS[e_t.mode] if k in want]
    assert sorted(got) == sorted(keys)
    for k in keys:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    if e_t.n_devices > 1:
        # every shard asks its peers for something
        assert int((got["qin"] != 0).sum()) > 0


def test_matvec_matches_jax(engines):
    op_j, e_j, e_t = engines
    x = _x(op_j, 3)
    got = e_t.matvec_global(x)
    np.testing.assert_allclose(got, np.asarray(e_j.matvec_global(x)),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, op_j.matvec_host(x), atol=ATOL,
                               rtol=RTOL)


def test_block_columns_equal_rank1(engines):
    op_j, e_j, e_t = engines
    X = e_t.to_hashed(_x(op_j, 5, cols=3))
    Y = e_t.matvec(X)
    assert Y.shape == (e_t.n_devices, e_t.shard_size, 3)
    for r in range(3):
        y = e_t.matvec(X[..., r].contiguous())
        if e_t.real:
            assert torch.equal(Y[..., r], y)
        else:
            torch.testing.assert_close(Y[..., r], y, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        e_t.from_hashed(Y), np.asarray(e_j.from_hashed(e_j.matvec(
            e_j.to_hashed(e_t.from_hashed(X))))), atol=ATOL, rtol=RTOL)


def test_lanczos_matches_jax(engines):
    op_j, _, e_t = engines
    n = op_j.basis.number_states
    want = jax_lanczos(JaxLocal(op_j).matvec, n, k=1, tol=1e-11)
    got = lanczos(e_t.matvec, v0=e_t.random_hashed(0), k=1, tol=1e-11,
                  device="cpu")
    assert got.converged and want.converged
    assert abs(got.eigenvalues[0] - want.eigenvalues[0]) < 1e-10


def test_split_leaves_a_tail():
    """chain_16_d4 exercises the two-level split's tail in both modes."""
    op = build_heisenberg(16, 8, None)
    op.basis.build()
    op_t = operator_from_reference(operator_arrays(op), device="cpu")
    for mode in ("ell", "compact"):
        e = DistributedEngine(op_t, n_devices=4, mode=mode, batch_size=512,
                              device="cpu")
        T0, S, _ = e.ell_split
        assert T0 < e.num_terms and S > 0
        assert "tail_rows" in e.structure_arrays()


def test_compact_refusals_match_jax():
    """Compact refuses anisotropic couplings and complex sectors as the JAX
    engine does, with the same errors."""
    def anisotropic(basis_cls, chain, heis):
        b = basis_cls(8, 4)
        op = heis(b, chain(8)) + 0.44 * heis(
            b, [(i, (i + 2) % 8) for i in range(8)])
        b.build()
        return op

    def k1(basis_cls, chain, heis):
        b = basis_cls(10, 5, None, [([1, 2, 3, 4, 5, 6, 7, 8, 9, 0], 1)])
        op = heis(b, chain(10))
        b.build()
        return op

    for make, match in ((anisotropic, "single off-diagonal magnitude"),
                        (k1, "real sector")):
        op_j = make(JaxBasis, jax_chain_edges, jax_heisenberg)
        op_t = make(SpinBasis, chain_edges, heisenberg_from_edges)
        with pytest.raises(ValueError, match=match):
            JaxEngine(op_j, n_devices=2, mode="compact")
        with pytest.raises(ValueError, match=match):
            DistributedEngine(op_t, n_devices=2, mode="compact",
                              device="cpu")
