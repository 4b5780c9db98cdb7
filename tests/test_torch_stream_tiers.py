"""The rest of the streamed engine — every codec tier (``off``, ``lossless``,
``f32``, ``bf16``), complex128 sectors, raw (non-dictionary) coefficient
streams and ``mode="hybrid"`` — in the port against the JAX package, on the
CPU, from the same operators and seeded inputs.

Tolerances:
* the codec spec, every encoded array (dtype and bytes), the decode tables
  and the host decode: bit-exact against the JAX ``PlanCodec`` on synthetic
  and real engine chunks — the same host encode on bit-identical
  coefficients; bf16 rounds through torch and equals ``ml_dtypes``'
  rounding bit for bit (``ml_dtypes`` is imported here only);
* engine plans (every record, in the JAX engine's form): bit-exact against
  the JAX ``DistributedEngine`` at the same D, mode, tier and
  ``batch_size``;
* matvec: atol 1e-14 / rtol 1e-12 against the JAX engine (the reference's
  tolerance, TestMatrixVectorProduct.chpl:15-16; the receive side sums in
  another order); the quantized tiers also within JAX's documented bounds
  of the lossless apply, 1e-6 (``f32``) and 1e-2 (``bf16``) relative to its
  largest value (tests/test_plan_codec.py);
* the port's ``off``, raw-coefficient and hybrid applies equal its
  lossless streamed apply bit for bit (the same products, scattered to the
  same slots, summed in the same order), as the JAX tests hold the JAX
  engines; pipelined applies equal depth 0 bit for bit, and a block's
  columns equal single-column applies bit for bit (complex products run on
  real components, so their rounding does not depend on the block shape);
* eigenvalues: within 1e-10 of JAX's ``lanczos_block`` on the JAX engine
  of the same mode.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_matvec_tpu.ops import plan_codec as JPC
from distributed_matvec_tpu.parallel.distributed import \
    DistributedEngine as JaxEngine
from distributed_matvec_tpu.solve import lanczos_block as jax_lanczos_block
from distributed_matvec_tpu.utils.config import update_config
from distributed_matvec_tpu_torch import (DistributedEngine, LocalEngine,
                                          lanczos_block)
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)
from distributed_matvec_tpu_torch.ops import plan_codec as TPC

from test_operator import build_heisenberg

ATOL, RTOL = 1e-14, 1e-12
TIERS = ("off", "lossless", "f32", "bf16")
BOUNDS = {"f32": 1e-6, "bf16": 1e-2}

SYMS_12 = [([*range(1, 12), 0], 0)]
RING_10_K1 = [([*range(1, 10), 0], 1)]

#: (n, hw, inv, syms, D, split): tests/test_engine_hybrid.py's
#: HYBRID_CONFIGS — a |G| > 1 sector, a trivial group and a complex
#: (k = 1) sector; mixed splits and both ends
HYBRID_CONFIGS = [
    (12, 6, 1, SYMS_12, 4, "stream:0,2,5"),
    (12, 6, 1, SYMS_12, 4, "all-recompute"),
    (12, 6, 1, SYMS_12, 4, "all-stream"),
    (10, 5, None, (), 4, "stream:1,3"),
    (10, 5, None, RING_10_K1, 4, "stream:0,1"),
]
BATCH = 64


# -- helpers --------------------------------------------------------------------


def _ops(n, hw, inv, syms):
    op_j = build_heisenberg(n, hw, inv, list(syms))
    op_j.basis.build()
    return op_j, operator_from_reference(operator_arrays(op_j), device="cpu")


def _jax_engine(op_j, D, mode, tier, batch=BATCH, **kw):
    update_config(stream_compress=tier)
    try:
        return JaxEngine(op_j, n_devices=D, mode=mode, batch_size=batch,
                         **kw)
    finally:
        update_config(stream_compress="off")


def _engine(op_t, D, mode="streamed", tier="lossless", batch=BATCH, **kw):
    return DistributedEngine(op_t, n_devices=D, mode=mode, batch_size=batch,
                             stream_compress=tier, device="cpu", **kw)


def _x(op, seed, cols=None):
    rng = np.random.default_rng(seed)
    shape = (op.basis.number_states,) + ((cols,) if cols else ())
    x = rng.random(shape) - 0.5
    if not op.effective_is_real:
        x = x + 1j * (rng.random(shape) - 0.5)
    return x


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _same_plan(e_t, e_j):
    """The port's plan, record by record, against the JAX engine's."""
    assert e_t._codec.spec == e_j._codec.spec
    assert e_t.nchunks == len(e_j._plan_chunks)
    for d in range(e_t.n_devices):
        _same(e_t._cdict[d].numpy(), e_j._codec.dict_device_row(d),
              f"shard {d} dictionary")
        for ci in range(e_t.nchunks):
            got, want = e_t.plan_chunk(ci, d), e_j._plan_chunks[ci][d]
            for k in ("dest", "ridx", "rok", "coeff"):
                _same(got[k], want[k], f"chunk {ci} shard {d} {k}")
    assert e_t.plan_bytes == e_j.plan_bytes
    assert e_t.plan_bytes_raw == e_j.plan_bytes_raw


def _synthetic(rng, ckind, B=24, T=5, n_recv=64, M=48, values=None):
    """JAX tests/test_plan_codec.py's ``_chunk``: a raw record with
    repeating (or given) coefficient values."""
    if values is None:
        values = np.array([0.0, 0.5, -0.5, 1.25, -2.0])
    cf = rng.choice(values, (B, T))
    if ckind == "complex":
        cf = cf + 1j * rng.choice(values, (B, T))
    return {"dest": rng.integers(0, n_recv, B * T,
                                 endpoint=True).astype(np.int32),
            "coeff": cf,
            "ridx": rng.integers(0, M, n_recv).astype(np.int32),
            "rok": rng.integers(0, 2, n_recv).astype(bool)}


def _codec_pair(tier, chunks, ckind, **kw):
    args = dict(n_dest=kw.pop("n_dest"), cap_build=kw.pop("cap_build"),
                n_devices=kw.pop("n_devices"),
                shard_size=kw.pop("shard_size"), cshape=kw.pop("cshape"),
                ckind=ckind, **kw)
    return (TPC.PlanCodec.build(tier, chunks, **args),
            JPC.PlanCodec.build(tier, chunks, **args))


def _same_codec(c_t, c_j, chunks):
    """Spec, dictionaries, decode tables, every encoded array and the host
    decode of every record, port against JAX."""
    assert c_t.spec == c_j.spec
    assert c_t.raw_chunk_bytes() == c_j.raw_chunk_bytes()
    for d in c_j.dicts:
        _same(c_t.dicts[d], c_j.dicts[d], f"dict {d}")
        _same(c_t.dict_store(d), c_j.dict_store(d), f"dict_store {d}")
    for per in chunks:
        for d, pc in per.items():
            _same(c_t.dict_device_row(d), c_j.dict_device_row(d),
                  f"dict_device_row {d}")
            e_t, e_j = c_t.encode_chunk(pc, d), c_j.encode_chunk(pc, d)
            assert sorted(e_t) == sorted(e_j)
            for k in e_j:
                _same(e_t[k], e_j[k], f"encoded {k}")
            h_t, h_j = c_t.decode_chunk_host(e_t, d), \
                c_j.decode_chunk_host(e_j, d)
            for k in h_j:
                _same(h_t[k], h_j[k], f"decoded {k}")
            if c_t.spec["tier"] != "off":
                for k, v in c_j.compact_raw(pc).items():
                    _same(c_t.compact_raw(pc)[k], v, f"compact {k}")
            assert TPC.PlanCodec.encoded_bytes(e_t) == \
                JPC.PlanCodec.encoded_bytes(e_j)


# -- the codec --------------------------------------------------------------------


@pytest.mark.parametrize("ckind", ["real", "complex"])
@pytest.mark.parametrize("tier", TIERS)
def test_codec_matches_jax_synthetic(tier, ckind):
    rng = np.random.default_rng(TIERS.index(tier) * 2 + (ckind == "real"))
    chunks = [{0: _synthetic(rng, ckind)}, {0: _synthetic(rng, ckind)}]
    c_t, c_j = _codec_pair(tier, chunks, ckind, n_dest=120, cap_build=64,
                           n_devices=1, shard_size=48, cshape=(24, 5))
    assert c_t.spec["coeff"] == ("raw" if tier == "off" else "dict")
    _same_codec(c_t, c_j, chunks)


@pytest.mark.parametrize("ckind", ["real", "complex"])
@pytest.mark.parametrize("tier", ["lossless", "f32", "bf16"])
def test_codec_raw_fallback_matches_jax(tier, ckind):
    """Continuous coefficients past ``dict_max=8``: raw coefficient
    streams in the tier's storage form, [n] or [n, 2] columns."""
    rng = np.random.default_rng(7)
    chunks = [{0: _synthetic(rng, ckind, B=16, T=4, n_recv=32, M=32,
                             values=rng.standard_normal(64))}]
    c_t, c_j = _codec_pair(tier, chunks, ckind, n_dest=64, cap_build=32,
                           n_devices=1, shard_size=32, cshape=(16, 4),
                           dict_max=8)
    assert c_t.spec["coeff"] == "raw"
    _same_codec(c_t, c_j, chunks)
    enc = c_t.encode_chunk(chunks[0][0], 0)["coeff"]
    assert enc.dtype == {"lossless": np.float64, "f32": np.float32,
                         "bf16": np.uint16}[tier]
    assert enc.ndim == (1 if ckind == "real" else 2)


@pytest.fixture(scope="module")
def engine_chunks():
    """Raw plan chunks of two port engines at D = 4 — chain_12_symm (real)
    and the 10-ring's k = 1 sector (complex) — with the engines."""
    out = {}
    for ckind, cfg in (("real", (12, 6, 1, SYMS_12)),
                       ("complex", (10, 5, None, RING_10_K1))):
        _, op_t = _ops(*cfg)
        e = _engine(op_t, 4)
        out[ckind] = (e, e._build_stream_plan())
    return out


@pytest.mark.parametrize("ckind", ["real", "complex"])
@pytest.mark.parametrize("tier", TIERS)
def test_codec_matches_jax_on_engine_chunks(engine_chunks, tier, ckind):
    e, raw = engine_chunks[ckind]
    c_t, c_j = _codec_pair(tier, raw, ckind, n_dest=e.batch_size
                           * e.num_terms, cap_build=e._capacity,
                           n_devices=4, shard_size=e.shard_size,
                           cshape=(e.batch_size, e.num_terms))
    assert c_t.spec["D"] == 4 and len(raw) > 1
    _same_codec(c_t, c_j, raw)


def test_codec_term_mask_unit():
    """JAX test_codec_term_mask_unit's cases on the port's codec: a masked
    build stores only the streamed terms while the trim covers every live
    entry, the mask round-trips through the spec JSON, the off tier
    refuses it; and the masked codec equals JAX's."""
    B, T, D, cap = 8, 4, 2, 16
    rng = np.random.default_rng(5)
    coeff = rng.random((B, T)) * (rng.random((B, T)) < 0.6)
    dest = np.full(B * T, D * cap, np.int32)
    for j, i in enumerate(np.nonzero(coeff.reshape(-1))[0]):
        dest[i] = (j % D) * cap + (j // D)
    pc = {"dest": dest, "coeff": coeff,
          "ridx": np.arange(D * cap, dtype=np.int32) % B,
          "rok": np.ones(D * cap, bool)}
    mask = np.array([True, False, True, False])
    kw = dict(n_dest=B * T, cap_build=cap, n_devices=D, shard_size=B,
              cshape=(B, T))
    codec, c_j = _codec_pair("lossless", [{0: pc}], "real", term_mask=mask,
                             **dict(kw))
    full = TPC.PlanCodec.build("lossless", [{0: pc}], ckind="real", **kw)
    assert codec.spec["cap_eff"] == full.spec["cap_eff"]
    assert codec.spec["n_live"] <= full.spec["n_live"]
    assert codec.spec["stream_terms"] == [0, 2]
    np.testing.assert_array_equal(codec.term_mask(), mask)
    rt = TPC.PlanCodec.from_spec_json(codec.spec_json())
    np.testing.assert_array_equal(rt.term_mask(), mask)
    cp = codec.compact_raw(pc)
    kept = cp["coeff"][cp["coeff"] != 0]
    want = coeff[:, mask].reshape(-1)
    np.testing.assert_array_equal(np.sort(kept), np.sort(want[want != 0]))
    _same_codec(codec, c_j, [{0: pc}])
    with pytest.raises(ValueError, match="compacted tier"):
        TPC.PlanCodec.build("off", [{0: pc}], ckind="real", term_mask=mask,
                            **kw)


def test_codec_spec_and_dictionary_round_trip():
    """A codec restored from its spec JSON and stored dictionary re-encodes
    bit for bit; an unknown tier and a pair kind are refused."""
    rng = np.random.default_rng(3)
    for ckind in ("real", "complex"):
        pc = _synthetic(rng, ckind)
        codec = TPC.PlanCodec.build("f32", [{0: pc}], n_dest=120,
                                    cap_build=64, n_devices=1,
                                    shard_size=48, cshape=(24, 5),
                                    ckind=ckind)
        restored = TPC.PlanCodec.from_spec_json(codec.spec_json())
        assert restored.spec == codec.spec
        restored.set_dict(0, codec.dict_store(0))
        e1, e2 = codec.encode_chunk(pc, 0), restored.encode_chunk(pc, 0)
        for k in e1:
            _same(e2[k], e1[k], k)
    with pytest.raises(ValueError, match="tier"):
        TPC.PlanCodec({"version": 1, "tier": "fp8", "ckind": "real"})
    with pytest.raises(NotImplementedError, match="pair"):
        TPC.PlanCodec({"version": 1, "tier": "off", "ckind": "pair"})


def test_bf16_rounding_matches_ml_dtypes():
    """torch's f64 → bfloat16 rounding (one rounding, to nearest even) and
    the u16 widening against ml_dtypes, on random magnitudes, signed
    zeros, infinities, and f64 values at and beside an f32 halfway point
    of bf16 (where rounding through f32 first would differ)."""
    rng = np.random.default_rng(11)
    v = rng.standard_normal(50_000) * 10.0 ** rng.uniform(-30, 30, 50_000)
    f = rng.standard_normal(5_000).astype(np.float32).view(np.uint32)
    tie = ((f & np.uint32(0xFFFF0000)) | np.uint32(0x8000)).view(
        np.float32).astype(np.float64)
    v = np.concatenate([v, tie, np.nextafter(tie, np.inf),
                        np.nextafter(tie, -np.inf),
                        [0.0, -0.0, np.inf, -np.inf, 1e-45, 3.4e38]])
    got = TPC._bf16_bits(v)
    want = v.astype(ml_dtypes.bfloat16).view(np.uint16)
    _same(got, want, "bf16 bits")
    _same(TPC._bf16_values(got),
          want.view(ml_dtypes.bfloat16).astype(np.float64), "bf16 values")
    _same(TPC._quantize(v, "bf16"), JPC._quantize(v, "bf16"), "quantize")
    z = v[:1000] + 1j * v[1000:2000]
    _same(TPC._quantize(z, "bf16"), JPC._quantize(z, "bf16"), "complex")


def test_device_decode_every_tier_and_kind():
    """``decode_plan_shard`` on tensors equals the host decode: the off
    pass-through, dictionary gathers from f64 and c128 tables, raw f64,
    f32 and bf16 values, and (re, im) columns."""
    rng = np.random.default_rng(8)
    for ckind in ("real", "complex"):
        for tier in TIERS:
            for dict_max in (TPC.DICT_MAX, 2):
                pc = _synthetic(rng, ckind)
                codec = TPC.PlanCodec.build(
                    tier, [{0: pc}], n_dest=120, cap_build=64, n_devices=1,
                    shard_size=48, cshape=(24, 5), ckind=ckind,
                    dict_max=dict_max)
                enc = codec.encode_chunk(pc, 0)
                host = codec.decode_chunk_host(enc, 0)

                def t(a):
                    a = np.ascontiguousarray(a)
                    if a.dtype in (np.uint32, np.uint16):
                        a = a.view(np.int32 if a.dtype == np.uint32
                                   else np.int16)
                    return torch.from_numpy(a)

                dev = TPC.decode_plan_shard(
                    codec.spec, t(enc["dest"]), t(enc["coeff"]),
                    t(enc["ridx"]), t(enc["rok"]),
                    torch.from_numpy(codec.dict_device_row(0)))
                keys = ("dest", "coeff", "ridx", "rok") if tier == "off" \
                    else ("dest", "row", "coeff", "ridx", "rok")
                for k, got in zip(keys, dev):
                    want = np.asarray(host[k])
                    if k == "coeff":
                        # the pads' values are dropped at the sentinel
                        live = np.asarray(host["dest"]).reshape(-1) \
                            < codec.spec["n_recv"]
                        got = got.numpy().reshape(-1)[live]
                        want = want.reshape(-1)[live]
                    np.testing.assert_array_equal(
                        np.asarray(got), want.astype(np.asarray(got).dtype),
                        err_msg=f"{ckind} {tier} {dict_max} {k}")


# -- the engines ------------------------------------------------------------------


@pytest.fixture(scope="module")
def chain12():
    """chain_12_symm at D = 4: the ops and the port's lossless engine."""
    op_j, op_t = _ops(12, 6, 1, SYMS_12)
    return op_j, op_t, _engine(op_t, 4)


@pytest.mark.parametrize("tier", TIERS)
def test_tier_engine_matches_jax(chain12, tier):
    op_j, op_t, lossless = chain12
    e_j = _jax_engine(op_j, 4, "streamed", tier)
    e_t = _engine(op_t, 4, tier=tier)
    _same_plan(e_t, e_j)
    assert e_t.stream_kernel == ("torch" if tier == "off" else "cuda")
    x = _x(op_j, 3)
    y = e_t.matvec_global(x)
    np.testing.assert_allclose(y, np.asarray(e_j.matvec_global(x)),
                               atol=ATOL, rtol=RTOL)
    y_ref = lossless.matvec(lossless.to_hashed(x))
    yh = e_t.matvec(e_t.to_hashed(x))
    if tier in ("off", "lossless"):
        assert torch.equal(yh, y_ref)
    else:
        rel = float((yh - y_ref).abs().max() / y_ref.abs().max())
        assert 0 < rel <= BOUNDS[tier], rel
    X = e_t.to_hashed(_x(op_j, 4, cols=3))
    Y = e_t.matvec(X)
    for r in range(3):
        assert torch.equal(Y[..., r], e_t.matvec(X[..., r].contiguous()))


def test_complex_streamed_matches_jax():
    op_j, op_t = _ops(10, 5, None, RING_10_K1)
    e_j = _jax_engine(op_j, 4, "streamed", "lossless")
    e_t = _engine(op_t, 4)
    assert not e_t.real and e_t.stream_kernel == "torch"
    assert e_t._codec.spec["ckind"] == "complex"
    assert e_t._cdict.dtype == torch.complex128
    _same_plan(e_t, e_j)
    x = _x(op_j, 3)
    y = e_t.matvec_global(x)
    np.testing.assert_allclose(y, np.asarray(e_j.matvec_global(x)),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(y, op_j.matvec_host(x), atol=ATOL, rtol=RTOL)
    # Hermitian with non-real off-diagonals: <x, Hz> = <Hx, z>
    z = _x(op_j, 9)
    a = np.vdot(x, e_t.matvec_global(z))
    b = np.vdot(y, z)
    assert abs(a - b) < 1e-12 * abs(a)
    for tier in ("off", "f32", "bf16"):
        e2 = _engine(op_t, 4, tier=tier)
        _same_plan(e2, _jax_engine(op_j, 4, "streamed", tier))
        np.testing.assert_allclose(e2.matvec_global(x),
                                   np.asarray(e_j.matvec_global(x)),
                                   atol=BOUNDS.get(tier, ATOL) * 10,
                                   rtol=BOUNDS.get(tier, RTOL))


@pytest.mark.parametrize("n,hw,inv,syms,D,split", HYBRID_CONFIGS,
                         ids=[f"{c[0]}-{c[5]}" for c in HYBRID_CONFIGS])
def test_hybrid_matches_jax_and_streamed(n, hw, inv, syms, D, split):
    op_j, op_t = _ops(n, hw, inv, syms)
    e_j = _jax_engine(op_j, D, "hybrid", "off", hybrid_split=split)
    e_h = _engine(op_t, D, mode="hybrid", tier="off", hybrid_split=split)
    e_s = _engine(op_t, D)
    assert e_h._codec.spec["tier"] == "lossless"
    assert e_h._codec.spec["hybrid"] is True
    assert e_h.stream_kernel == "torch"
    assert e_h.hybrid_stream_fraction == e_j.hybrid_stream_fraction
    if split != "all-stream":
        assert e_h.hybrid_stream_fraction < 1.0
        assert e_h.plan_bytes < e_s.plan_bytes
    _same_plan(e_h, e_j)
    x = _x(op_j, 5)
    yh = e_h.matvec(e_h.to_hashed(x))
    assert torch.equal(yh, e_s.matvec(e_s.to_hashed(x)))
    np.testing.assert_allclose(e_h.from_hashed(yh),
                               np.asarray(e_j.matvec_global(x)), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(e_h.from_hashed(yh), op_j.matvec_host(x),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("ckind", ["real", "complex"])
def test_raw_streams_bit_equal_to_dictionary(ckind, monkeypatch):
    """``DICT_MAX`` lowered: the port engine streams raw coefficients,
    equal to the JAX engine's raw plan (its ``PlanCodec.build`` patched to
    the same ceiling) and, bit for bit, to the port's dictionary apply."""
    cfg = (12, 6, 1, SYMS_12) if ckind == "real" \
        else (10, 5, None, RING_10_K1)
    op_j, op_t = _ops(*cfg)
    e_dict = _engine(op_t, 4)
    assert e_dict._codec.spec["coeff"] == "dict"
    build = JPC.PlanCodec.build.__func__

    def build8(cls, *a, **kw):
        kw["dict_max"] = 2
        return build(cls, *a, **kw)

    monkeypatch.setattr(JPC.PlanCodec, "build", classmethod(build8))
    monkeypatch.setattr(TPC, "DICT_MAX", 2)
    e_j = _jax_engine(op_j, 4, "streamed", "lossless")
    e_raw = _engine(op_t, 4)
    assert e_raw._codec.spec["coeff"] == "raw"
    assert e_raw.stream_kernel == "torch"
    _same_plan(e_raw, e_j)
    x = _x(op_j, 6)
    X = _x(op_j, 7, cols=3)
    for v in (x, X):
        assert torch.equal(e_raw.matvec(e_raw.to_hashed(v)),
                           e_dict.matvec(e_dict.to_hashed(v)))
    np.testing.assert_allclose(e_raw.matvec_global(x),
                               np.asarray(e_j.matvec_global(x)), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("case", ["hybrid", "complex"])
def test_pipelined_and_blocks(case):
    """Depth 3 (over 4+ chunks) equals depth 0 bit for bit, and ``[D, M,
    3]`` / ``[D, M, 6]`` blocks equal their single-column applies bit for
    bit and the JAX engine's blocks within the matvec tolerance."""
    if case == "hybrid":
        op_j, op_t = _ops(10, 5, None, ())
        kw = dict(mode="hybrid", hybrid_split="stream:1,2,3")
    else:
        op_j, op_t = _ops(10, 5, None, RING_10_K1)
        kw = {}
    e = _engine(op_t, 4, batch=16, **kw)
    e_j = _jax_engine(op_j, 4, kw.get("mode", "streamed"), "lossless",
                      batch=16, **({"hybrid_split": kw["hybrid_split"]}
                                   if kw else {}))
    assert e.nchunks >= 4
    x = e.to_hashed(_x(op_j, 2))
    y0 = e.matvec(x)
    e.pipeline_depth = 3
    assert e.pipeline_depth == 3
    assert torch.equal(e.matvec(x), y0)
    assert e.last_pipeline["chunks"] == e.nchunks
    for k in (3, 6):
        X = e.to_hashed(_x(op_j, 10 + k, cols=k))
        Y = e.matvec(X)
        e.pipeline_depth = 0
        for r in range(k):
            assert torch.equal(Y[..., r], e.matvec(X[..., r].contiguous()))
        e.pipeline_depth = 3
        np.testing.assert_allclose(
            Y.numpy(), np.asarray(e_j.matvec(jnp.asarray(X.numpy()))),
            atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", ["hybrid", "complex"])
def test_lanczos_block_matches_jax(case):
    if case == "hybrid":
        op_j, op_t = _ops(12, 6, 1, SYMS_12)
        kw = dict(mode="hybrid", hybrid_split="stream:0,2,5")
    else:
        # the 14-ring's k = 1 sector (245 states): the 10-ring's 25 states
        # exhaust a block Krylov space before the test's tolerance
        op_j, op_t = _ops(14, 7, None, [([*range(1, 14), 0], 1)])
        kw = {}
    e_j = _jax_engine(op_j, 4, kw.get("mode", "streamed"), "lossless",
                      **({"hybrid_split": kw["hybrid_split"]} if kw
                         else {}))
    e = _engine(op_t, 4, **kw)
    want = jax_lanczos_block(e_j.matvec, k=2, tol=1e-11, max_iters=400)
    got = lanczos_block(e.matvec, k=2, tol=1e-11, max_iters=400,
                        device="cpu")
    assert got.converged and want.converged
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=0,
                               atol=1e-10)


def test_refusals():
    """JAX's words for a bad split and a term out of range; an unknown
    tier; LocalEngine points hybrid at DistributedEngine.  The "auto"
    split (the JAX default, so None too) resolves to the JAX engine's mask
    under the same (CPU default) calibration, and its apply equals the
    hand-set ``stream:<mask>`` engine's bit for bit."""
    op_j, op_t = _ops(10, 5, None, ())
    with pytest.raises(ValueError, match="hybrid split"):
        _engine(op_t, 2, mode="hybrid", hybrid_split="bogus")
    with pytest.raises(ValueError, match="hybrid split"):
        _engine(op_t, 2, mode="hybrid", hybrid_split="stream:1,x")
    with pytest.raises(ValueError, match="outside"):
        _engine(op_t, 2, mode="hybrid", hybrid_split="stream:9999")
    want = _jax_engine(op_j, 2, "hybrid", "lossless",
                       hybrid_split="auto")._hybrid_mask
    x = _x(op_t, 0)
    for split in ("auto", None, " AUTO "):
        e = _engine(op_t, 2, mode="hybrid", hybrid_split=split)
        np.testing.assert_array_equal(e._hybrid_mask, want)
        twin = _engine(op_t, 2, mode="hybrid", hybrid_split=e.hybrid_split)
        _same(e.matvec_global(x), twin.matvec_global(x), f"auto {split}")
    with pytest.raises(ValueError, match="stream_compress"):
        _engine(op_t, 2, tier="fp8")
    with pytest.raises(ValueError, match="DistributedEngine"):
        LocalEngine(op_t, mode="hybrid", device="cpu")
    e = _engine(op_t, 2, mode="ell")
    assert e.stream_kernel is None
