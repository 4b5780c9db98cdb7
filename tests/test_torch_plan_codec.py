"""The port's plan codec and fused decode against the JAX ``ops/plan_codec.py``.

Tolerance: none.  Bitpacking is integer work; the fused decode does one
product per live entry and plain stores, so the plain version, the JAX
Pallas kernel (interpret mode, called directly — outside ``shard_map``) and
the JAX XLA decode path all give the same send buffer bit for bit.  On the
CPU the wrapper ``fused_decode_gather_scatter`` takes the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_matvec_tpu.ops import plan_codec as JPC
from distributed_matvec_tpu.parallel.distributed import \
    DistributedEngine as JaxEngine
from distributed_matvec_tpu.utils.config import update_config
from distributed_matvec_tpu_torch.ops import plan_codec as TPC

from test_operator import build_heisenberg

WIDTHS = [1, 3, 8, 13, 17, 24, 31, 32]


def _words(a: np.ndarray) -> torch.Tensor:
    """u32 word stream → the port's int32 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _codes(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint8:
        return torch.from_numpy(a)
    return torch.from_numpy(np.ascontiguousarray(a, np.uint16).view(np.int16))


@pytest.mark.parametrize("width", WIDTHS)
def test_pack_unpack_match_jax(width):
    rng = np.random.default_rng(width)
    n = 1000
    vals = rng.integers(0, 1 << width, n, dtype=np.uint64)
    vals[:3] = [0, (1 << width) - 1, 1 << (width - 1)]
    packed = TPC.pack_bits(vals, width)
    np.testing.assert_array_equal(packed, JPC.pack_bits(vals, width))
    got = TPC.unpack_bits(_words(packed), n, width).numpy()
    np.testing.assert_array_equal(got.astype(np.uint64), vals)
    np.testing.assert_array_equal(
        got.astype(np.uint64),
        np.asarray(JPC.unpack_bits(jnp.asarray(packed), n, width)))
    np.testing.assert_array_equal(TPC.unpack_bits_np(packed, n, width), vals)


def _synthetic(code_bits: int, seed: int):
    """One encoded chunk shaped as the codec writes it: unique live
    destinations, padding entries at the drop sentinel with the pad code
    and row 0, streams packed by each package's own ``pack_bits``."""
    rng = np.random.default_rng(seed)
    B, n_live, n_recv = 96, 136, 150
    n_real = 121
    ndict = 200 if code_bits == 8 else 3000
    spec = {"n_live": n_live, "n_recv": n_recv, "w_dest": JPC.bits_for(n_recv),
            "w_row": JPC.bits_for(B - 1), "code_bits": code_bits,
            "ndict": ndict, "coeff": "dict", "cshape": [B, 7]}
    dest = np.full(n_live, n_recv, np.int64)
    dest[:n_real] = rng.permutation(n_recv)[:n_real]
    rows = np.zeros(n_live, np.int64)
    rows[:n_real] = rng.integers(0, B, n_real)
    codes = np.full(n_live, 5, np.uint8 if code_bits == 8 else np.uint16)
    codes[:n_real] = rng.integers(0, ndict, n_real)
    cdict = rng.standard_normal(ndict)
    x = rng.standard_normal(B)
    return spec, dest, rows, codes, cdict, x


@pytest.mark.parametrize("code_bits", [8, 16])
def test_fused_plain_matches_pallas_synthetic(code_bits):
    spec, dest, rows, codes, cdict, x = _synthetic(code_bits, code_bits)
    streams = {}
    for name, pack in (("jax", JPC.pack_bits), ("torch", TPC.pack_bits)):
        streams[name] = np.concatenate([pack(dest, spec["w_dest"]),
                                        pack(rows, spec["w_row"])])
    np.testing.assert_array_equal(streams["jax"], streams["torch"])
    want = np.asarray(JPC.fused_decode_gather_scatter(
        spec, jnp.asarray(streams["jax"]), jnp.asarray(codes),
        jnp.asarray(cdict), jnp.asarray(x), interpret=True))
    args = (spec, _words(streams["torch"]), _codes(codes),
            torch.from_numpy(cdict), torch.from_numpy(x))
    plain = TPC._fused_decode_gather_scatter_plain(*args).numpy()
    np.testing.assert_array_equal(plain, want)
    before = TPC.fused_decode_gather_scatter.launches
    np.testing.assert_array_equal(
        TPC.fused_decode_gather_scatter(*args).numpy(), want)
    # the CPU path runs the plain version and launches no kernel
    assert TPC.fused_decode_gather_scatter.launches == before
    # every live entry landed in its slot; the rest of the buffer is zero
    ref = np.zeros(spec["n_recv"] + 1)
    live = dest < spec["n_recv"]
    ref[dest[live]] = cdict[codes[live]] * x[rows[live]]
    np.testing.assert_array_equal(plain[:-1], ref[:-1])


def test_fused_checks_operands():
    spec, dest, rows, codes, cdict, x = _synthetic(8, 3)
    edest = _words(np.concatenate([TPC.pack_bits(dest, spec["w_dest"]),
                                   TPC.pack_bits(rows, spec["w_row"])]))
    with pytest.raises(ValueError, match="ecodes"):
        TPC.fused_decode_gather_scatter(
            spec, edest, _codes(codes.astype(np.uint16)),
            torch.from_numpy(cdict), torch.from_numpy(x))
    with pytest.raises(ValueError, match="x_c"):
        TPC.fused_decode_gather_scatter(
            spec, edest, _codes(codes), torch.from_numpy(cdict),
            torch.from_numpy(x[:-1]))


@pytest.fixture(scope="module")
def jax_lossless_engine():
    update_config(stream_compress="lossless")
    try:
        op = build_heisenberg(12, 6, 1, [([*range(1, 12), 0], 0)])
        op.basis.build()
        eng = JaxEngine(op, n_devices=1, mode="streamed", batch_size=64)
    finally:
        update_config(stream_compress="off")
    return eng


def test_fused_plain_matches_pallas_and_xla_on_engine_chunks(
        jax_lossless_engine):
    eng = jax_lossless_engine
    spec = eng._codec.spec
    assert spec["coeff"] == "dict" and spec["D"] == 1
    cdict = eng._codec.dict_device_row(0)
    rng = np.random.default_rng(11)
    B = spec["cshape"][0]
    n_recv = spec["n_recv"]
    for ci in range(len(eng._plan_chunks)):
        enc = eng._plan_chunks[ci][0]
        x = rng.standard_normal(B)
        pallas = np.asarray(JPC.fused_decode_gather_scatter(
            spec, jnp.asarray(enc["dest"]), jnp.asarray(enc["coeff"]),
            jnp.asarray(cdict), jnp.asarray(x), interpret=True))
        dest, row, cf, _, _ = JPC.decode_plan_shard(
            spec, jnp.asarray(enc["dest"]), jnp.asarray(enc["coeff"]),
            jnp.asarray(enc["ridx"]), jnp.asarray(enc["rok"]),
            jnp.asarray(cdict))
        xla = np.asarray(jnp.zeros(n_recv).at[dest].set(
            cf * jnp.asarray(x)[row], mode="drop"))
        got = TPC.fused_decode_gather_scatter(
            spec, _words(enc["dest"]), _codes(enc["coeff"]),
            torch.from_numpy(cdict), torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, pallas)
        np.testing.assert_array_equal(got[:n_recv], xla)
        # the port's device decode equals the JAX one field by field
        t = TPC.decode_plan_shard(
            spec, _words(enc["dest"]), _codes(enc["coeff"]),
            _words(enc["ridx"]), _words(enc["rok"]), torch.from_numpy(cdict))
        j = JPC.decode_plan_shard(
            spec, jnp.asarray(enc["dest"]), jnp.asarray(enc["coeff"]),
            jnp.asarray(enc["ridx"]), jnp.asarray(enc["rok"]),
            jnp.asarray(cdict))
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
