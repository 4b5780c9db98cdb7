"""The port on the card: the CUDA decode kernel against its plain version
(synthetic chunks, every chunk of a real D = 4 plan and of an ``f32``
tier's plan), and the streamed engine (real and complex sectors, hybrid
mode's send buffer), the hash-sharded engine at D = 4 in every mode and
``LocalEngine`` on the card against the same engines on the CPU.

Marked ``cuda``: each test skips without a CUDA device.  Run them on a
machine with one as ``python -m pytest --noconftest tests/test_torch_cuda.py``
(``tests/conftest.py`` imports jax, which that machine need not have).

Tolerances: the kernel is held to its plain version bit for bit
(``torch.equal``: one product per entry, plain stores); the engine's matvec
to the CPU engine at atol 1e-13 / rtol 1e-12, because the card's
``index_add_`` sums with atomics in a run-dependent order; ``LocalEngine``
at the same tolerance, its integer tables bit for bit and its
coefficients within 1e-15.  The streamed engine's multi-column apply is
held column by column to its rank-1 applies at atol 1e-13 (the same
per-column decode launches; the atomic adds of two applies need not run
in the same order), and the block solvers on the card to the same solvers
on the CPU: eigenvalues within 1e-10, KPM moments within 1e-11.  The
synthetic chunks are ``chip_smoke.py``'s.
"""

import os
import sys

import numpy as np
import pytest
import torch

from distributed_matvec_tpu_torch import (DistributedEngine, LocalEngine,
                                          SpinBasis, kpm_moments, lanczos,
                                          lanczos_block)
from distributed_matvec_tpu_torch.models.lattices import (
    chain_edges, heisenberg_chain, heisenberg_from_edges)
from distributed_matvec_tpu_torch.ops import plan_codec as PC

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("code_bits", [8, 16])
def test_kernel_equals_plain(cuda, code_bits):
    """Three buckets, the live entries in random order over their
    prefixes, then padding."""
    rng = np.random.default_rng(code_bits)
    B, n_recv, n_live, D = 5000, 9000, 8000, 3
    cap = n_recv // D
    ndict = 13 if code_bits == 8 else 3000
    spec = {"n_live": n_live, "n_recv": n_recv, "D": D, "cap_eff": cap,
            "w_dest": PC.bits_for(n_recv), "w_row": PC.bits_for(B - 1),
            "code_bits": code_bits, "ndict": ndict, "coeff": "dict",
            "cshape": [B, 8]}
    fill = np.array([2500, 2300, 2200], np.int32)
    occupied = np.concatenate([k * cap + np.arange(f)
                               for k, f in enumerate(fill)])
    n_real = occupied.size
    dest = np.full(n_live, n_recv, np.int64)
    dest[:n_real] = rng.permutation(occupied)
    rows = np.zeros(n_live, np.int64)
    rows[:n_real] = rng.integers(0, B, n_real)
    codes = np.full(n_live, 2, np.uint8 if code_bits == 8 else np.uint16)
    codes[:n_real] = rng.integers(0, ndict, n_real)
    words = np.concatenate([PC.pack_bits(dest, spec["w_dest"]),
                            PC.pack_bits(rows, spec["w_row"])])
    args = (spec, torch.from_numpy(words.view(np.int32)).to(cuda),
            torch.from_numpy(codes if code_bits == 8
                             else codes.view(np.int16)).to(cuda),
            torch.from_numpy(fill).to(cuda),
            torch.from_numpy(rng.standard_normal(ndict)).to(cuda),
            torch.from_numpy(rng.standard_normal(B)).to(cuda))
    before = PC.fused_decode_gather_scatter.launches
    got = PC.fused_decode_gather_scatter(*args)
    torch.cuda.synchronize()
    assert PC.fused_decode_gather_scatter.launches == before + 1
    assert torch.equal(got, PC._fused_decode_gather_scatter_plain(*args))


@pytest.mark.parametrize("case", range(len(chip_smoke.KERNEL_CASES)))
def test_kernel_synthetic_cases(cuda, case):
    """Every slot written once, equal to the plain version: through the
    wrapper and into a buffer filled with NaN first."""
    B, n_recv, n_live, n_real, code_bits, ndict, kw = \
        chip_smoke.KERNEL_CASES[case]
    args = chip_smoke.synthetic_chunk(cuda, B, n_recv, n_live, n_real,
                                      code_bits, ndict, seed=case, **kw)
    assert chip_smoke.check_kernel(args) == 0.0


def test_kernel_on_sharded_plan_chunks(cuda):
    """Every (chunk, shard) of a real D = 4 plan, whose rok streams differ
    from the send occupancy: the kernel equals the plain version."""
    op = heisenberg_chain(16, symmetric=True)
    eng = DistributedEngine(op, n_devices=4, batch_size=32, device=cuda)
    spec = eng._codec.spec
    assert spec["D"] == 4 and eng.nchunks > 1
    rng = np.random.default_rng(4)
    for ci in range(eng.nchunks):
        for d in range(4):
            v = eng._chunk_views(eng._plan_host[ci, d].to(cuda))
            x_c = torch.from_numpy(rng.standard_normal(eng.batch_size)).to(
                cuda)
            assert chip_smoke.check_kernel(
                (spec, v[0], v[1], v[4], eng._cdict[d], x_c)) == 0.0


@pytest.mark.parametrize("mode", ["streamed", "ell", "compact", "fused"])
def test_sharded_engine_on_card_matches_cpu(cuda, mode):
    """D = 4 shards on the card against the same engine on the CPU; the
    streamed apply launches the decode kernel once per shard per chunk."""
    op = heisenberg_chain(16, symmetric=True)
    e_gpu = DistributedEngine(op, n_devices=4, mode=mode, batch_size=32,
                              device=cuda)
    e_cpu = DistributedEngine(op, n_devices=4, mode=mode, batch_size=32,
                              device="cpu")
    x = np.random.default_rng(1).random(op.basis.number_states) - 0.5
    before = PC.fused_decode_gather_scatter.launches
    np.testing.assert_allclose(e_gpu.matvec_global(x),
                               e_cpu.matvec_global(x),
                               atol=1e-13, rtol=1e-12)
    if mode == "streamed":
        assert PC.fused_decode_gather_scatter.launches - before == \
            4 * e_gpu.nchunks
    res = lanczos(e_gpu.matvec, v0=e_gpu.random_hashed(0), k=1, device=cuda)
    assert abs(res.eigenvalues[0] / 4 - -7.1422963606) < 1e-9


def test_engine_on_card_matches_cpu(cuda):
    op = heisenberg_chain(16, symmetric=True)
    e_gpu = DistributedEngine(op, batch_size=64, device=cuda)
    e_cpu = DistributedEngine(op, batch_size=64, device="cpu")
    x = np.random.default_rng(1).random(op.basis.number_states) - 0.5
    before = PC.fused_decode_gather_scatter.launches
    np.testing.assert_allclose(e_gpu.matvec_global(x),
                               e_cpu.matvec_global(x),
                               atol=1e-13, rtol=1e-12)
    assert PC.fused_decode_gather_scatter.launches - before == e_gpu.nchunks
    res = lanczos(e_gpu.matvec, v0=e_gpu.random_hashed(0), k=1, device=cuda)
    assert abs(res.eigenvalues[0] / 4 - -7.1422963606) < 1e-9


def _k1_ring(n=12):
    basis = SpinBasis(n, n // 2, None, [([*range(1, n), 0], 1)])
    op = heisenberg_from_edges(basis, chain_edges(n))
    basis.build()
    return op


@pytest.mark.parametrize("case,mode", [
    ("chain_16_symm", "ell"), ("chain_16_symm", "compact"),
    ("chain_16_symm", "fused"), ("chain_12_k1", "ell"),
    ("chain_12_k1", "fused")])
def test_local_engine_on_card_matches_cpu(cuda, case, mode):
    op = heisenberg_chain(16, symmetric=True) if case == "chain_16_symm" \
        else _k1_ring()
    e_gpu = LocalEngine(op, batch_size=61, mode=mode, device=cuda)
    e_cpu = LocalEngine(op, batch_size=61, mode=mode, device="cpu")
    assert e_gpu.ell_split == e_cpu.ell_split
    want = e_cpu.structure_arrays()
    for k, got in e_gpu.structure_arrays().items():
        if got.dtype.is_floating_point or got.dtype.is_complex:
            torch.testing.assert_close(got.cpu(), want[k], rtol=0,
                                       atol=1e-15)
        else:
            assert torch.equal(got.cpu(), want[k]), k
    n = op.basis.number_states
    rng = np.random.default_rng(2)
    for shape in ((n,), (n, 3)):
        x = rng.random(shape) - 0.5
        if not e_gpu.real:
            x = x + 1j * (rng.random(shape) - 0.5)
        y = e_gpu.matvec(x)
        assert y.device == cuda
        np.testing.assert_allclose(y.cpu().numpy(),
                                   e_cpu.matvec(x).numpy(),
                                   atol=1e-13, rtol=1e-12)


def test_local_lanczos_on_card(cuda):
    op = _k1_ring()
    eng = LocalEngine(op, device=cuda)
    got = lanczos(eng.matvec, eng.n_states, k=2, compute_eigenvectors=True,
                  device=cuda)
    want = lanczos(LocalEngine(op, device="cpu").matvec, eng.n_states, k=2,
                   device="cpu")
    assert got.converged
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=0,
                               atol=1e-10)
    for lam, v in zip(got.eigenvalues, got.eigenvectors):
        assert v.dtype == torch.complex128 and v.device == cuda
        assert float(torch.linalg.vector_norm(eng.matvec(v) - lam * v)) \
            < 1e-8


def test_streamed_block_apply_on_card(cuda):
    """A [1, M, 4] apply launches the decode kernel once per column per
    chunk, and each column equals a rank-1 apply of that column."""
    op = heisenberg_chain(16, symmetric=True)
    e_gpu = DistributedEngine(op, batch_size=64, device=cuda)
    e_cpu = DistributedEngine(op, batch_size=64, device="cpu")
    X = e_gpu.random_hashed(3, cols=4)
    before = PC.fused_decode_gather_scatter.launches
    Y = e_gpu.matvec(X)
    torch.cuda.synchronize()
    assert PC.fused_decode_gather_scatter.launches - before == \
        4 * e_gpu.nchunks
    for r in range(4):
        y = e_gpu.matvec(X[..., r].contiguous())
        torch.testing.assert_close(Y[..., r], y, rtol=0, atol=1e-13)
    np.testing.assert_allclose(Y.cpu().numpy(),
                               e_cpu.matvec(X.cpu()).numpy(),
                               atol=1e-13, rtol=1e-12)


def test_block_solvers_on_card_match_cpu(cuda):
    op = heisenberg_chain(16, symmetric=True)
    e_gpu = DistributedEngine(op, batch_size=64, device=cuda)
    e_cpu = DistributedEngine(op, batch_size=64, device="cpu")
    got = lanczos_block(e_gpu.matvec, k=2, tol=1e-11, max_iters=400)
    want = lanczos_block(e_cpu.matvec, k=2, tol=1e-11, max_iters=400)
    assert got.converged and want.converged
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=0,
                               atol=1e-10)
    bounds = (-40.0, 20.0)
    m_gpu = kpm_moments(e_gpu.matvec, 64, n_vectors=3, bounds=bounds)
    m_cpu = kpm_moments(e_cpu.matvec, 64, n_vectors=3, bounds=bounds)
    np.testing.assert_allclose(m_gpu.moments, m_cpu.moments, rtol=0,
                               atol=1e-11)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_rank_engine_one_rank_on_card(cuda, backend, tmp_path):
    """A one-rank group on the card — gloo, staged through pinned host
    memory, and NCCL — carries every wire dtype through its collectives
    and runs every exchange as a collective; each mode's apply equals the
    same engine's on the CPU, and Lanczos finds the anchor."""
    import torch.distributed as dist

    from distributed_matvec_tpu_torch.parallel.mesh import init_distributed

    op = heisenberg_chain(16, symmetric=True)
    op.basis.build()
    x = np.random.default_rng(2).random(op.basis.number_states) - 0.5
    g = init_distributed(backend, f"file://{tmp_path}/rendezvous", 1, 0,
                         device=cuda if backend == "gloo" else None)
    try:
        assert g.stages_host == (backend == "gloo")
        chip_smoke.wire_check(g, cuda)
        for mode in ("streamed", "ell", "fused"):
            e = DistributedEngine(op, mode=mode, batch_size=64, group=g)
            e_cpu = DistributedEngine(op, mode=mode, batch_size=64,
                                      device="cpu")
            assert e.device == cuda
            np.testing.assert_allclose(e.matvec_global(x),
                                       e_cpu.matvec_global(x),
                                       atol=1e-13, rtol=1e-12)
            assert (e.exchange_bytes > 0) == (mode != "ell")
        res = lanczos(e.matvec, v0=e.random_hashed(0), k=1)
        assert abs(res.eigenvalues[0] / 4 - -7.1422963606) < 1e-9
    finally:
        dist.destroy_process_group()


def test_pipelined_applies_on_card(cuda):
    """D = 4 streamed and fused engines in one process on the card: a
    pipelined apply equals the depth-0 apply bit for bit under
    deterministic algorithms (the card's ``index_add_`` otherwise adds in
    a run-dependent order), and the CPU engine's within 1e-13."""
    op = heisenberg_chain(16, symmetric=True)
    op.basis.build()
    x = np.random.default_rng(8).random(op.basis.number_states) - 0.5
    for mode in ("streamed", "fused"):
        e = DistributedEngine(op, n_devices=4, mode=mode, batch_size=16,
                              device=cuda)
        xh = e.to_hashed(x)
        torch.use_deterministic_algorithms(True)
        try:
            y0 = e.matvec(xh)
            for depth in (2, 3):
                e.pipeline_depth = depth
                assert torch.equal(e.matvec(xh), y0), (mode, depth)
        finally:
            torch.use_deterministic_algorithms(False)
        e_cpu = DistributedEngine(op, n_devices=4, mode=mode, batch_size=16,
                                  device="cpu")
        np.testing.assert_allclose(e.from_hashed(y0), e_cpu.matvec_global(x),
                                   atol=1e-13, rtol=1e-12)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_rank_engine_pipelined_on_card(cuda, backend, tmp_path):
    """A one-rank group on the card: the staged exchange (for gloo through
    pinned host memory on the group's comm thread) equals ``exchange`` in
    every wire dtype, and the streamed and fused applies at depth 2 equal
    depth 0 bit for bit under deterministic algorithms."""
    import torch.distributed as dist

    from distributed_matvec_tpu_torch.parallel.mesh import init_distributed

    op = heisenberg_chain(16, symmetric=True)
    op.basis.build()
    x = np.random.default_rng(3).random(op.basis.number_states) - 0.5
    g = init_distributed(backend, f"file://{tmp_path}/rendezvous", 1, 0,
                         device=cuda if backend == "gloo" else None)
    try:
        for name in chip_smoke.WIRE_DTYPES:
            v = torch.arange(6, device=cuda).reshape(1, 6)
            v = v % 3 == 0 if name == "bool" else v.to(getattr(torch, name))
            got, want = g.exchange_staged(v), g.exchange(v)
            assert got.dtype == want.dtype and torch.equal(got, want), name
        for mode in ("streamed", "fused"):
            e = DistributedEngine(op, mode=mode, batch_size=32, group=g)
            xh = e.to_hashed(x)
            torch.use_deterministic_algorithms(True)
            try:
                y0 = e.matvec(xh)
                e.pipeline_depth = 2
                y2 = e.matvec(xh)
            finally:
                torch.use_deterministic_algorithms(False)
            assert e.pipeline_depth == 2 and torch.equal(y2, y0), mode
            assert e.last_pipeline["chunks"] == e.nchunks
    finally:
        dist.destroy_process_group()


def test_kernel_on_f32_dictionary_chunks(cuda):
    """The unchanged kernel on an f32 tier's chunks (a dictionary of
    quantized values): equal to its plain version on every chunk, and the
    engine's apply launches it once per chunk."""
    op = heisenberg_chain(16, symmetric=True)
    eng = DistributedEngine(op, batch_size=64, stream_compress="f32",
                            device=cuda)
    spec = eng._codec.spec
    assert eng.stream_kernel == "cuda" and spec["coeff"] == "dict"
    rng = np.random.default_rng(6)
    for ci in range(eng.nchunks):
        v = eng._chunk_views(eng._plan_host[ci, 0].to(cuda))
        x_c = torch.from_numpy(rng.standard_normal(eng.batch_size)).to(cuda)
        assert chip_smoke.check_kernel(
            (spec, v[0], v[1], v[4], eng._cdict[0], x_c)) == 0.0
    before = PC.fused_decode_gather_scatter.launches
    eng.matvec(eng.random_hashed(1))
    torch.cuda.synchronize()
    assert PC.fused_decode_gather_scatter.launches - before == eng.nchunks


def test_complex_streamed_on_card_matches_cpu(cuda):
    """The 16-ring's k = 1 sector through the streamed engine on the card:
    the torch decode path, no kernel launch, the apply within atol 1e-13 /
    rtol 1e-12 of the same engine on the CPU, and a ``[1, M, 3]`` apply
    column by column against its single-column applies."""
    op = _k1_ring(16)
    e_gpu = DistributedEngine(op, batch_size=256, device=cuda)
    e_cpu = DistributedEngine(op, batch_size=256, device="cpu")
    assert e_gpu.stream_kernel == "torch" and not e_gpu.real
    rng = np.random.default_rng(3)
    n = op.basis.number_states
    x = rng.random(n) - 0.5 + 1j * (rng.random(n) - 0.5)
    before = PC.fused_decode_gather_scatter.launches
    np.testing.assert_allclose(e_gpu.matvec_global(x),
                               e_cpu.matvec_global(x),
                               atol=1e-13, rtol=1e-12)
    X = e_gpu.to_hashed(x[:, None] * np.array([1.0, -0.5j, 2.0]))
    Y = e_gpu.matvec(X)
    for r in range(3):
        torch.testing.assert_close(Y[..., r],
                                   e_gpu.matvec(X[..., r].contiguous()),
                                   rtol=0, atol=1e-13)
    torch.cuda.synchronize()
    assert PC.fused_decode_gather_scatter.launches == before


def test_hybrid_send_buffer_on_card(cuda):
    """One hybrid chunk's send buffer (streamed terms decoded, the others
    recomputed) equals the lossless streamed engine's kernel output bit for
    bit, and the hybrid apply equals the streamed one under deterministic
    algorithms."""
    op = heisenberg_chain(16, symmetric=True)
    es = DistributedEngine(op, batch_size=64, device=cuda)
    eh = DistributedEngine(op, batch_size=64, mode="hybrid",
                           hybrid_split="stream:0,2,5", device=cuda)
    assert es.stream_kernel == "cuda" and eh.stream_kernel == "torch"
    xh = es.random_hashed(2)
    for ci in range(es.nchunks):
        x_c = xh[0, ci * 64:(ci + 1) * 64]
        assert torch.equal(chip_smoke.send_buffer(eh, ci, x_c),
                           chip_smoke.send_buffer(es, ci, x_c)), ci
    torch.use_deterministic_algorithms(True)
    try:
        assert torch.equal(eh.matvec(xh), es.matvec(xh))
    finally:
        torch.use_deterministic_algorithms(False)
