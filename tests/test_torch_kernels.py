"""The port's operator kernels (``ops/kernels.py``) against the JAX ones.

Tolerance: none — ``gather_coefficients``, ``state_info`` and ``apply_diag``
must match bit for bit.  The port keeps the reference's operation order:
the orbit scan visits the group elements in the JAX scan's order and keeps
the first minimising element, and the off-diagonal legs are summed one at a
time.  Both packages start from identical tables (``convert.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_matvec_tpu.models.lattices import heisenberg_chain
from distributed_matvec_tpu.ops import kernels as JK
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)
from distributed_matvec_tpu_torch.ops import kernels as TK
from distributed_matvec_tpu_torch.utils import u64

from test_operator import build_heisenberg

_T12 = [*range(1, 12), 0]
_R12 = list(range(11, -1, -1))

CONFIGS = {
    "chain_12_symm": lambda: heisenberg_chain(12, symmetric=True),
    "chain_16_symm": lambda: heisenberg_chain(16, symmetric=True),
    # 32-bit states: bit 31 set, full-width shift networks
    "chain_32_hw4_symm": lambda: heisenberg_chain(32, 4, symmetric=True),
    # k = 0 with reflection, no spin inversion
    "chain_12_k0_reflection": lambda: build_heisenberg(
        12, 6, None, [(_T12, 0), (_R12, 0)]),
    # the multi-coset group of test_operator's coset-loop test
    "chain_12_multicoset": lambda: build_heisenberg(
        12, 6, 1, [(_T12, 0), (_R12, 0)]),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    op_j = CONFIGS[request.param]()
    op_j.basis.build()
    op_t = operator_from_reference(operator_arrays(op_j), device="cpu")
    return op_j, op_t


def _states(op, seed):
    """Basis reps plus random states of the sector's width."""
    rng = np.random.default_rng(seed)
    n = op.basis.number_spins
    return np.concatenate([op.basis.representatives,
                           rng.integers(0, (1 << n) - 1, 2048,
                                        dtype=np.uint64, endpoint=True)])


def test_gather_coefficients_bit_exact(pair):
    op_j, op_t = pair
    reps = op_j.basis.representatives
    norms = op_j.basis.norms
    tj = JK.device_tables(op_j)
    bj, cj = jax.jit(JK.gather_coefficients)(tj, jnp.asarray(reps),
                                             jnp.asarray(norms))
    tt = TK.device_tables(op_t, "cpu")
    bt, ct = TK.gather_coefficients(tt, u64.from_numpy(reps),
                                    torch.from_numpy(norms))
    np.testing.assert_array_equal(u64.to_numpy(bt), np.asarray(bj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_state_info_and_diag_bit_exact(pair):
    op_j, op_t = pair
    states = _states(op_j, 7)
    tj = JK.device_tables(op_j)
    rj, chj, nj = jax.jit(JK.state_info)(tj.group, jnp.asarray(states))
    tt = TK.device_tables(op_t, "cpu")
    rt, cht, nt = TK.state_info(tt.group, u64.from_numpy(states))
    np.testing.assert_array_equal(u64.to_numpy(rt), np.asarray(rj))
    np.testing.assert_array_equal(cht.numpy(), np.asarray(chj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    dj = jax.jit(JK.apply_diag)(tj.diag, jnp.asarray(states))
    dt = TK.apply_diag(tt.diag, u64.from_numpy(states))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
