"""The hash-sharded engine at D > 1, streamed and fused: the port's
``DistributedEngine`` (D shards in one process, on the CPU) against the JAX
``DistributedEngine`` on the virtual CPU mesh, at the same D, mode and
``batch_size``; and the pieces the sharded apply is made of.

Tolerances:
* routing, plan streams, codes, per-shard dictionaries and the codec spec:
  bit-exact — the same integer routing and the same host encode on
  bit-identical coefficients (see test_torch_streamed.py);
* ``_bucket_positions`` and the exchange: bit-exact (integer work, a copy);
* matvec: atol 1e-14 / rtol 1e-12, the reference's tolerance
  (TestMatrixVectorProduct.chpl:15-16) — the receive side sums in another
  order (``index_add_`` into y instead of a per-chunk ``segment_sum``);
* a block apply's columns equal rank-1 applies bit for bit on the CPU in
  real sectors (the same per-column decode, gathers and adds in the same
  order), and at the matvec tolerance in complex ones;
* ``random_hashed``: the same seeded draws, rtol 1e-14 (the norm is summed
  in another order);
* eigenvalues: 1e-10 against the JAX solver on the same operator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_matvec_tpu.parallel import distributed as JD
from distributed_matvec_tpu.parallel.distributed import \
    DistributedEngine as JaxEngine
from distributed_matvec_tpu.parallel.engine import LocalEngine as JaxLocal
from distributed_matvec_tpu.parallel.mesh import (SHARD_AXIS, make_mesh,
                                                  shard_map_compat)
from distributed_matvec_tpu.solve import lanczos as jax_lanczos
from distributed_matvec_tpu.solve import lanczos_block as jax_lanczos_block
from distributed_matvec_tpu.utils.config import get_config, update_config
from distributed_matvec_tpu_torch import (DistributedEngine, lanczos,
                                          lanczos_block)
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)
from distributed_matvec_tpu_torch.ops import plan_codec as TPC
from distributed_matvec_tpu_torch.parallel import distributed as TD

from test_operator import build_heisenberg

ATOL, RTOL = 1e-14, 1e-12

#: (n, hw, inv, syms, D, batch_size): the shapes of
#: test_engine_distributed.DIST_CONFIGS, real sectors (complex ones, the
#: other tiers and hybrid mode are in test_torch_stream_tiers.py), at D = 2,
#: 4, 8
STREAMED_CONFIGS = {
    "chain_8_d2": (8, 4, None, (), 2, 16),
    "chain_10_d4": (10, 5, None, (), 4, 16),
    "chain_12_d8": (12, 6, None, (), 8, 16),
    "chain_10_inv_d8": (10, 5, -1, (), 8, 16),
    "chain_12_symm_d8": (12, 6, 1, [([*range(1, 12), 0], 0)], 8, 16),
}

#: fused takes the complex-character sector too; a shard holds M = 128
#: slots here, so B = 32 still makes four chunks
FUSED_CONFIGS = {
    "chain_8_d2": (8, 4, None, (), 2, 16),
    "chain_10_d4": (10, 5, None, (), 4, 32),
    "chain_12_symm_d8": (12, 6, 1, [([*range(1, 12), 0], 0)], 8, 32),
    "chain_10_k1_d4": (10, 5, None, [([*range(1, 10), 0], 1)], 4, 32),
}


def _pair(cfg, mode):
    n, hw, inv, syms, D, B = cfg
    op_j = build_heisenberg(n, hw, inv, syms)
    op_j.basis.build()
    if mode == "streamed":
        update_config(stream_compress="lossless")
    try:
        e_j = JaxEngine(op_j, n_devices=D, mode=mode, batch_size=B)
    finally:
        update_config(stream_compress="off")
    op_t = operator_from_reference(operator_arrays(op_j), device="cpu")
    e_t = DistributedEngine(op_t, n_devices=D, mode=mode, batch_size=B,
                            device="cpu")
    return op_j, e_j, e_t


@pytest.fixture(scope="module", params=sorted(STREAMED_CONFIGS))
def streamed(request):
    return _pair(STREAMED_CONFIGS[request.param], "streamed")


@pytest.fixture(scope="module", params=sorted(FUSED_CONFIGS))
def fused(request):
    return _pair(FUSED_CONFIGS[request.param], "fused")


def _x(op, seed, cols=None):
    rng = np.random.default_rng(seed)
    shape = (op.basis.number_states,) + ((cols,) if cols else ())
    x = rng.random(shape) - 0.5
    if not op.effective_is_real:
        x = x + 1j * (rng.random(shape) - 0.5)
    return x


# -- streamed ------------------------------------------------------------------


def test_streamed_plan_bit_exact(streamed):
    _, e_j, e_t = streamed
    D = e_t.n_devices
    assert e_t._codec.spec == e_j._codec.spec
    assert e_t._codec.spec["D"] == D and e_t._capacity == e_j._capacity
    for d in range(D):
        np.testing.assert_array_equal(e_t._codec.dicts[d],
                                      e_j._codec.dicts[d])
        np.testing.assert_array_equal(e_t._cdict[d].numpy(),
                                      e_j._codec.dict_device_row(d))
    assert e_t.nchunks == len(e_j._plan_chunks) > 1
    for ci in range(e_t.nchunks):
        for d in range(D):
            got = e_t.plan_chunk(ci, d)
            want = e_j._plan_chunks[ci][d]
            for k in ("dest", "ridx", "rok", "coeff"):
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{ci} {d} {k}")
    assert e_t.plan_bytes == e_j.plan_bytes
    assert e_t.plan_bytes_raw == e_j.plan_bytes_raw


def test_streamed_matvec_matches_jax(streamed):
    op_j, e_j, e_t = streamed
    x = _x(op_j, 3)
    np.testing.assert_allclose(e_t.matvec_global(x),
                               np.asarray(e_j.matvec_global(x)),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(e_t.matvec_global(x), op_j.matvec_host(x),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(e_t.to_hashed(x).numpy(),
                                  np.asarray(e_j.to_hashed(x)))
    # the same seeded draws; the norms are summed in another order
    np.testing.assert_allclose(e_t.random_hashed(4).numpy(),
                               np.asarray(e_j.random_hashed(4)), rtol=1e-14,
                               atol=0)


def test_streamed_block_columns_equal_rank1(streamed):
    op_j, e_j, e_t = streamed
    X = e_t.to_hashed(_x(op_j, 5, cols=3))
    Y = e_t.matvec(X)
    assert Y.shape == X.shape == (e_t.n_devices, e_t.shard_size, 3)
    for r in range(3):
        assert torch.equal(Y[..., r], e_t.matvec(X[..., r].contiguous()))
    np.testing.assert_allclose(Y.numpy(), np.asarray(e_j.matvec(
        jnp.asarray(X.numpy()))), atol=ATOL, rtol=RTOL)


def test_streamed_lanczos_matches_jax(streamed):
    op_j, _, e_t = streamed
    want = jax_lanczos(JaxLocal(op_j).matvec, op_j.basis.number_states, k=1,
                       tol=1e-11)
    got = lanczos(e_t.matvec, v0=e_t.random_hashed(0), k=1, tol=1e-11,
                  device="cpu")
    assert got.converged and want.converged
    assert abs(got.eigenvalues[0] - want.eigenvalues[0]) < 1e-10


def test_streamed_fill_is_send_occupancy_not_rok():
    """On every chunk of a real D = 4 plan, the stored fill counts are the
    send buffer's occupancy: the live entries of bucket k write exactly its
    slots [k·cap, k·cap + fill[k]).  The chunk's rok stream describes the
    receive buffer, and across the plan it differs from that occupancy in
    both directions — the decode kernel must not take it for the send
    side."""
    op = build_heisenberg(10, 5, None, ())
    op.basis.build()
    e_t = DistributedEngine(operator_from_reference(operator_arrays(op),
                                                    device="cpu"),
                            n_devices=4, batch_size=16, device="cpu")
    spec = e_t._codec.spec
    D, cap, n_recv, nl = spec["D"], spec["cap_eff"], spec["n_recv"], \
        spec["n_live"]
    nwd = TPC.packed_words(nl, spec["w_dest"])
    slot = np.arange(n_recv)
    rok_not_occ = occ_not_rok = 0
    for ci in range(e_t.nchunks):
        for d in range(D):
            enc = e_t.plan_chunk(ci, d)
            dest = TPC.unpack_bits_np(enc["dest"][:nwd], nl,
                                      spec["w_dest"]).astype(np.int64)
            written = np.zeros(n_recv, bool)
            written[dest[dest < n_recv]] = True
            fill = enc["fill"]
            np.testing.assert_array_equal(fill,
                                          TPC.send_fill(dest, D, cap))
            np.testing.assert_array_equal(
                written, (slot % cap) < fill[slot // cap])
            rok = TPC.unpack_bits_np(enc["rok"], n_recv, 1).astype(bool)
            rok_not_occ += int((rok & ~written).sum())
            occ_not_rok += int((written & ~rok).sum())
    assert rok_not_occ > 0 and occ_not_rok > 0


def test_streamed_kernel_plain_on_sharded_chunks():
    """The decode wrapper on every (chunk, shard) of a D = 4 plan, given
    the stored fill counts, equals the zero-fill-and-scatter reference, and
    so does the NumPy model of the kernel's write-once rule."""
    from test_torch_plan_codec import _write_once

    op = build_heisenberg(10, 5, None, ())
    op.basis.build()
    e_t = DistributedEngine(operator_from_reference(operator_arrays(op),
                                                    device="cpu"),
                            n_devices=4, batch_size=16, device="cpu")
    spec = e_t._codec.spec
    nl, n_recv = spec["n_live"], spec["n_recv"]
    nwd = TPC.packed_words(nl, spec["w_dest"])
    rng = np.random.default_rng(2)
    for ci in range(e_t.nchunks):
        for d in range(e_t.n_devices):
            edest, codes, _, _, fill = e_t._chunk_views(e_t._plan_host[ci, d])
            x = torch.from_numpy(rng.standard_normal(spec["cshape"][0]))
            got = TPC.fused_decode_gather_scatter(spec, edest, codes, fill,
                                                  e_t._cdict[d], x)
            enc = e_t.plan_chunk(ci, d)
            dest = TPC.unpack_bits_np(enc["dest"][:nwd], nl, spec["w_dest"])
            rows = TPC.unpack_bits_np(enc["dest"][nwd:], nl, spec["w_row"])
            want = np.zeros(n_recv + 1)
            want[np.minimum(dest, n_recv).astype(np.int64)] = \
                e_t._cdict[d].numpy()[enc["coeff"].astype(np.int64)] \
                * x.numpy()[rows.astype(np.int64)]
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(
                _write_once(spec, dest.astype(np.int64),
                            rows.astype(np.int64), enc["coeff"],
                            enc["fill"], e_t._cdict[d].numpy(), x.numpy()),
                want)


def test_streamed_lanczos_block_d4_matches_jax():
    op_j, e_j, e_t = _pair(STREAMED_CONFIGS["chain_10_d4"], "streamed")
    want = jax_lanczos_block(e_j.matvec, k=2, tol=1e-11, max_iters=400)
    got = lanczos_block(e_t.matvec, k=2, tol=1e-11, max_iters=400,
                        device="cpu")
    assert got.converged and want.converged
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("mode", ["streamed", "fused"])
def test_tiny_remote_buffer_overflows_in_both(mode):
    op_j = build_heisenberg(12, 6)
    op_j.basis.build()
    op_t = operator_from_reference(operator_arrays(op_j), device="cpu")
    x = _x(op_j, 1)
    cfg = get_config()
    saved = (cfg.all_to_all_capacity_factor, cfg.remote_buffer_size)
    update_config(all_to_all_capacity_factor=1.0, remote_buffer_size=8,
                  stream_compress="lossless")
    try:
        with pytest.warns(RuntimeWarning, match="capacity"):
            with pytest.raises(RuntimeError, match="overflow"):
                e_j = JaxEngine(op_j, n_devices=8, mode=mode, batch_size=128)
                e_j.matvec(e_j.to_hashed(x))
    finally:
        update_config(all_to_all_capacity_factor=saved[0],
                      remote_buffer_size=saved[1], stream_compress="off")
    with pytest.warns(RuntimeWarning, match="capacity"):
        with pytest.raises(RuntimeError, match="overflow"):
            e_t = DistributedEngine(op_t, n_devices=8, mode=mode,
                                    batch_size=128, device="cpu",
                                    all_to_all_capacity_factor=1.0,
                                    remote_buffer_size=8)
            e_t.matvec(e_t.to_hashed(x))


# -- fused ---------------------------------------------------------------------


def test_fused_matvec_matches_jax(fused):
    op_j, e_j, e_t = fused
    assert e_t._capacity == e_j._capacity
    x = _x(op_j, 6)
    got = e_t.matvec_global(x)
    np.testing.assert_allclose(got, np.asarray(e_j.matvec_global(x)),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, op_j.matvec_host(x), atol=ATOL,
                               rtol=RTOL)


def test_fused_block_columns_equal_rank1(fused):
    op_j, e_j, e_t = fused
    X = e_t.to_hashed(_x(op_j, 7, cols=3))
    Y = e_t.matvec(X)
    for r in range(3):
        y = e_t.matvec(X[..., r].contiguous())
        if e_t.real:
            assert torch.equal(Y[..., r], y)
        else:
            # the CPU's vectorized complex multiply may round a broadcast
            # product otherwise than a single column's
            torch.testing.assert_close(Y[..., r], y, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(Y.numpy(), np.asarray(e_j.matvec(
        jnp.asarray(X.numpy()))), atol=ATOL, rtol=RTOL)


def test_fused_wide_block_shrinks_chunk():
    """A block wider than 4 columns runs at a smaller row chunk (here 8
    rows for 9 columns at B = 16) with its own capacity and counter check,
    as the JAX engine's does, and still equals it."""
    op_j, e_j, e_t = _pair((10, 5, None, (), 4, 16), "fused")
    X = _x(op_j, 8, cols=9)
    Y = e_t.from_hashed(e_t.matvec(e_t.to_hashed(X)))
    np.testing.assert_allclose(Y, np.asarray(e_j.from_hashed(e_j.matvec(
        e_j.to_hashed(X)))), atol=ATOL, rtol=RTOL)
    assert e_t._checked == e_j._checked == {8}


def test_fused_lanczos_matches_jax(fused):
    op_j, _, e_t = fused
    want = jax_lanczos(JaxLocal(op_j).matvec, op_j.basis.number_states, k=1,
                       tol=1e-11)
    got = lanczos(e_t.matvec, v0=e_t.random_hashed(0), k=1, tol=1e-11,
                  device="cpu")
    assert got.converged and want.converged
    assert abs(got.eigenvalues[0] - want.eigenvalues[0]) < 1e-10


# -- the pieces ----------------------------------------------------------------


@pytest.mark.parametrize("D", [3, 16, 17, 32])
def test_bucket_positions_match_jax(D):
    """Both branches: the one-hot cumsum (D ≤ 16) and the stable sort."""
    rng = np.random.default_rng(D)
    key = rng.integers(0, D + 1, 5000)
    got = TD._bucket_positions(torch.from_numpy(key), D).numpy()
    want = np.asarray(JD._bucket_positions(jnp.asarray(key, jnp.int32), D))
    np.testing.assert_array_equal(got, want)
    # the rank of each entry among the earlier entries of its bucket
    for k in range(D):
        np.testing.assert_array_equal(got[key == k],
                                      np.arange(int((key == k).sum())))


@pytest.mark.parametrize("D", [1, 2, 4])
def test_all_to_all_is_tiled_exchange(D):
    """Shard d's receive block s is shard s's send block d: against a
    hand-built exchange and against JAX's tiled ``all_to_all`` on the
    virtual mesh."""
    C = 5
    rng = np.random.default_rng(D)
    send = rng.standard_normal((D, D, C, 2))
    want = np.empty_like(send)
    for d in range(D):
        for s in range(D):
            want[d, s] = send[s, d]
    got = TD.all_to_all(torch.from_numpy(send))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    if D == 1:
        return
    mesh = make_mesh(D)

    def body(sb):
        return jax.lax.all_to_all(sb[0], SHARD_AXIS, 0, 0, tiled=True)[None]

    f = shard_map_compat(body, mesh=mesh, in_specs=(P(SHARD_AXIS),),
                         out_specs=P(SHARD_AXIS))
    np.testing.assert_array_equal(np.asarray(jax.jit(f)(jnp.asarray(send))),
                                  want)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_hashed_layout_matches_jax(D):
    """The port's layout of a real basis equals the JAX package's: the same
    counts, padding and permutation, so both packages put every state on
    the same shard and slot."""
    from distributed_matvec_tpu.parallel.shuffle import \
        HashedLayout as JaxLayout
    from distributed_matvec_tpu_torch.parallel.shuffle import HashedLayout

    op = build_heisenberg(12, 6, 1, [([*range(1, 12), 0], 0)])
    op.basis.build()
    reps = op.basis.representatives
    got, want = HashedLayout(reps, D), JaxLayout(reps, D)
    assert got.shard_size == want.shard_size
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.inverse, want.inverse)
