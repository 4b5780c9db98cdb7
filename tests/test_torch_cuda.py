"""The port on the card: the CUDA decode kernel against its plain version,
and the streamed engine on the card against the same engine on the CPU.

Marked ``cuda``: each test skips without a CUDA device.  Run them on a
machine with one as ``python -m pytest --noconftest tests/test_torch_cuda.py``
(``tests/conftest.py`` imports jax, which that machine need not have).

Tolerances: the kernel is held to its plain version bit for bit
(``torch.equal``: one product per entry, plain stores); the engine's matvec
to the CPU engine at atol 1e-13 / rtol 1e-12, because the card's
``index_add_`` sums with atomics in a run-dependent order.  The synthetic
chunks are ``chip_smoke.py``'s.
"""

import os
import sys

import numpy as np
import pytest
import torch

from distributed_matvec_tpu_torch import DistributedEngine, lanczos
from distributed_matvec_tpu_torch.models.lattices import heisenberg_chain
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
    rng = np.random.default_rng(code_bits)
    B, n_recv, n_live, n_real = 5000, 9000, 8000, 7000
    ndict = 13 if code_bits == 8 else 3000
    spec = {"n_live": n_live, "n_recv": n_recv,
            "w_dest": PC.bits_for(n_recv), "w_row": PC.bits_for(B - 1),
            "code_bits": code_bits, "ndict": ndict, "coeff": "dict",
            "cshape": [B, 8]}
    dest = np.full(n_live, n_recv, np.int64)
    dest[:n_real] = rng.permutation(n_recv)[:n_real]
    rows = np.zeros(n_live, np.int64)
    rows[:n_real] = rng.integers(0, B, n_real)
    codes = np.full(n_live, 2, np.uint8 if code_bits == 8 else np.uint16)
    codes[:n_real] = rng.integers(0, ndict, n_real)
    rok = np.zeros(n_recv, bool)
    rok[dest[:n_real]] = True
    words = np.concatenate([PC.pack_bits(dest, spec["w_dest"]),
                            PC.pack_bits(rows, spec["w_row"])])
    args = (spec, torch.from_numpy(words.view(np.int32)).to(cuda),
            torch.from_numpy(codes if code_bits == 8
                             else codes.view(np.int16)).to(cuda),
            torch.from_numpy(PC.pack_bits(rok, 1).view(np.int32)).to(cuda),
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
