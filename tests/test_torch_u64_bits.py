"""The port's u64-on-int64 bit kernels against the JAX ``ops/bits.py``.

Tolerance: none — every output is an integer (or ±1.0) and must match bit
for bit.  Inputs are random u64 values from a seeded NumPy generator, with
states that have bit 63 set, the all-ones SENTINEL, and lookups that fall
outside the basis.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_matvec_tpu.ops import bits as JB
from distributed_matvec_tpu_torch.ops import bits as TB
from distributed_matvec_tpu_torch.utils import u64

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def _states(seed: int, n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, np.iinfo(np.uint64).max, n, dtype=np.uint64,
                     endpoint=True)
    a[:4] = [0, SENTINEL, np.uint64(1 << 63), np.uint64((1 << 63) - 1)]
    a[4:64] |= np.uint64(1 << 63)          # bit 63 set
    return a


def _t(a):
    return u64.from_numpy(a)


def test_u64_helpers_match_numpy():
    a = _states(1)
    b = _states(2)
    ta, tb = _t(a), _t(b)
    for s in (0, 1, 7, 31, 32, 33, 63):
        np.testing.assert_array_equal(u64.to_numpy(u64.srl(ta, s)),
                                      a >> np.uint64(s))
    np.testing.assert_array_equal(u64.ult(ta, tb).numpy(), a < b)
    np.testing.assert_array_equal(u64.to_numpy(u64.umin(ta, tb)),
                                  np.minimum(a, b))
    for d in (1, 2, 3, 7, 8, 1_000_003, (1 << 62) + 5):
        np.testing.assert_array_equal(u64.to_numpy(u64.umod(ta, d)),
                                      a % np.uint64(d))
    np.testing.assert_array_equal(u64.popcount(ta).numpy(),
                                  np.bitwise_count(a).astype(np.int64))


def test_popcount_sign_hash_match_jax():
    a = _states(3)
    ta = _t(a)
    np.testing.assert_array_equal(
        TB.popcount64(ta).numpy(),
        np.asarray(JB.popcount64(jnp.asarray(a))).astype(np.int64))
    np.testing.assert_array_equal(
        TB.sign_from_parity(ta).numpy(),
        np.asarray(JB.sign_from_parity(jnp.asarray(a))))
    np.testing.assert_array_equal(
        u64.to_numpy(TB.hash64(ta)), np.asarray(JB.hash64(jnp.asarray(a))))


@pytest.mark.parametrize("n_shards", [1, 3, 8, 7919])
def test_shard_index_matches_jax(n_shards):
    a = _states(4)
    np.testing.assert_array_equal(
        TB.shard_index(_t(a), n_shards).numpy(),
        np.asarray(JB.shard_index(jnp.asarray(a), n_shards)))


@pytest.mark.parametrize("n_bits,dir_bits", [(20, None), (40, 6), (64, 12)])
def test_state_index_bucketed_matches_jax(n_bits, dir_bits):
    rng = np.random.default_rng(5)
    hi = (1 << n_bits) - 1
    reps = np.unique(rng.integers(0, hi, 3000, dtype=np.uint64,
                                  endpoint=True))
    host = (JB.build_sorted_lookup(reps, n_bits, dir_bits=dir_bits),
            TB.build_sorted_lookup(reps, n_bits, dir_bits=dir_bits))
    for a, b in zip(*host):
        np.testing.assert_array_equal(a, b)
    pair, dir_tab, shift, probes = host[1]
    # hits, near misses, in-range random, above the basis width, SENTINEL
    q = np.concatenate([reps, reps + np.uint64(1),
                        rng.integers(0, hi, 2000, dtype=np.uint64,
                                     endpoint=True),
                        _states(6, 512), [SENTINEL]])
    idx_j, found_j = JB.state_index_bucketed(
        jnp.asarray(pair), jnp.asarray(dir_tab), jnp.asarray(q),
        shift=shift, probes=probes)
    idx_t, found_t = TB.state_index_bucketed(
        torch.from_numpy(pair.astype(np.int64)), torch.from_numpy(dir_tab),
        _t(q), shift=shift, probes=probes)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    assert found_t[: reps.size].all()
    assert not found_t[-1]
