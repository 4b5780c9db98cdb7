"""The port's plan codec and fused decode against the JAX ``ops/plan_codec.py``.

Tolerance: none.  Bitpacking is integer work; the fused decode does one
product per live entry and plain stores, so the plain version, the JAX
Pallas kernel (interpret mode, called directly — outside ``shard_map``) and
the JAX XLA decode path all give the same send buffer bit for bit.  On the
CPU the wrapper ``fused_decode_gather_scatter`` takes the plain version.

The CUDA kernel writes the send buffer once, without a zero fill, and
relies on two properties of the plan: the live entries routed to bucket k
occupy exactly its slots ``[k·cap_eff, k·cap_eff + fill[k])`` (``fill`` is
the chunk's per-bucket fill counts, :func:`send_fill`), and padding
entries form the tail of the live stream.  ``_write_once`` models its
writes in NumPy; the tests check the properties on every chunk of real
plans (the port's and the JAX engine's) and that the model equals the
plain version there and on synthetic chunks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_matvec_tpu.models.lattices import heisenberg_chain as jax_chain
from distributed_matvec_tpu.ops import plan_codec as JPC
from distributed_matvec_tpu.parallel.distributed import \
    DistributedEngine as JaxEngine
from distributed_matvec_tpu.utils.config import update_config
from distributed_matvec_tpu_torch import DistributedEngine as TorchEngine
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)
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


def _synthetic(code_bits: int, seed: int, B=96, n_recv=150, n_live=136,
               n_real=121, ndict=None, identity=False, w_dest=None,
               w_row=None, D=None):
    """One chunk shaped as the codec writes it: ``n_recv`` send slots in D
    buckets (D = 1 with ``identity``, else the largest of 4, 3, 2, 1 that
    divides ``n_recv``, unless given), ``n_real`` live entries filling a
    random prefix of each bucket — ``0 … n_real−1`` in order with
    ``identity``, as at one device; else in random order — then padding
    entries at the drop sentinel with the pad code and row 0.  Returns the
    spec, the streams' values and the per-bucket fill counts.
    ``w_dest``/``w_row`` widen the fields beyond the bits their values
    need."""
    rng = np.random.default_rng(seed)
    if ndict is None:
        ndict = 200 if code_bits == 8 else 3000
    if D is None:
        D = 1 if identity else next(k for k in (4, 3, 2, 1)
                                    if n_recv % k == 0)
    cap = n_recv // D
    spec = {"n_live": n_live, "n_recv": n_recv, "D": D, "cap_eff": cap,
            "w_dest": w_dest or JPC.bits_for(n_recv),
            "w_row": w_row or JPC.bits_for(B - 1), "code_bits": code_bits,
            "ndict": ndict, "coeff": "dict", "cshape": [B, 7]}
    # each bucket's fill: how many of n_real random slots land in it
    fill = np.bincount(rng.permutation(n_recv)[:n_real] // cap,
                       minlength=D)
    occupied = np.flatnonzero(np.arange(n_recv) % cap
                              < fill[np.arange(n_recv) // cap])
    dest = np.full(n_live, n_recv, np.int64)
    dest[:n_real] = occupied if identity else rng.permutation(occupied)
    rows = np.zeros(n_live, np.int64)
    rows[:n_real] = (np.sort(rng.integers(0, B, n_real)) if identity
                     else rng.integers(0, B, n_real))
    codes = np.full(n_live, ndict - 1,
                    np.uint8 if code_bits == 8 else np.uint16)
    codes[:n_real] = rng.integers(0, ndict, n_real)
    cdict = rng.standard_normal(ndict)
    x = rng.standard_normal(B)
    return spec, dest, rows, codes, fill.astype(np.int32), cdict, x


def _write_once(spec, dest, rows, codes, fill, cdict, x) -> np.ndarray:
    """The CUDA kernel's writes, modelled in NumPy: each live entry writes
    its amplitude to its slot, each slot at or above its bucket's fill gets
    0.0, and the last entry writes the drop slot (its amplitude if it is
    padding, else 0.0).  Asserts that every slot is written exactly once."""
    nl, n_recv, cap = spec["n_live"], spec["n_recv"], spec["cap_eff"]
    amp = cdict[codes.astype(np.int64)] * x[rows]
    out = np.full(n_recv + 1, np.nan)
    writes = np.zeros(n_recv + 1, np.int64)
    live = dest < n_recv
    out[dest[live]] = amp[live]
    np.add.at(writes, dest[live], 1)
    slot = np.arange(n_recv)
    clear = np.flatnonzero(slot % cap >= np.asarray(fill)[slot // cap])
    out[clear] = 0.0
    writes[clear] += 1
    out[n_recv] = amp[-1] if nl and dest[-1] >= n_recv else 0.0
    writes[n_recv] += 1
    assert np.array_equal(writes, np.ones_like(writes)), \
        "a slot is written other than once"
    return out


def _encoded(spec, dest, rows, codes, pack=TPC.pack_bits):
    """The chunk's encoded streams: dest+row words and codes."""
    return (np.concatenate([pack(dest, spec["w_dest"]),
                            pack(rows, spec["w_row"])]), codes)


def _fill(fill) -> torch.Tensor:
    return torch.from_numpy(np.asarray(fill, np.int32))


@pytest.mark.parametrize("code_bits", [8, 16])
def test_fused_plain_matches_pallas_synthetic(code_bits):
    spec, dest, rows, codes, fill, cdict, x = _synthetic(code_bits,
                                                         code_bits)
    streams = {}
    for name, pack in (("jax", JPC.pack_bits), ("torch", TPC.pack_bits)):
        streams[name] = np.concatenate([pack(dest, spec["w_dest"]),
                                        pack(rows, spec["w_row"])])
    np.testing.assert_array_equal(streams["jax"], streams["torch"])
    want = np.asarray(JPC.fused_decode_gather_scatter(
        spec, jnp.asarray(streams["jax"]), jnp.asarray(codes),
        jnp.asarray(cdict), jnp.asarray(x), interpret=True))
    args = (spec, _words(streams["torch"]), _codes(codes), _fill(fill),
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


#: synthetic chunks for the kernel's write-once rule: keyword arguments of
#: ``_synthetic``.  The CUDA kernel's tile is 1024 entries.
SYNTHETIC_CASES = {
    "u8": dict(code_bits=8),
    "u16_large_dict": dict(code_bits=16, ndict=3000),
    "u16_w32": dict(code_bits=16, B=300, n_recv=2000,
                                n_live=1800, n_real=1500, ndict=700,
                                w_dest=32, w_row=32),
    "identity": dict(code_bits=8, B=700, n_recv=3000, n_live=3008,
                     n_real=2990, identity=True),
    "no_padding": dict(code_bits=8, B=500, n_recv=5000, n_live=4000,
                       n_real=4000, ndict=50),
    "no_padding_identity": dict(code_bits=8, B=500, n_recv=4000,
                                n_live=4000, n_real=4000, identity=True),
    "all_padding": dict(code_bits=8, B=100, n_recv=300, n_live=264,
                        n_real=0, ndict=9),
    "tile_minus_1": dict(code_bits=8, B=700, n_recv=1100, n_live=1023,
                         n_real=1000, ndict=30),
    "tile_plus_1": dict(code_bits=8, B=700, n_recv=1100, n_live=1025,
                        n_real=1025, ndict=30),
    "two_tiles_minus_1": dict(code_bits=16, B=700, n_recv=2047,
                              n_live=2047, n_real=2046, ndict=30,
                              identity=True),
    "two_tiles_plus_1": dict(code_bits=8, B=700, n_recv=2100, n_live=2049,
                             n_real=2040, ndict=30),
    "w1": dict(code_bits=8, B=2, n_recv=1, n_live=8, n_real=1, ndict=4),
    "w1_no_padding": dict(code_bits=8, B=2, n_recv=1, n_live=1, n_real=1,
                          ndict=4),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC_CASES))
def test_write_once_matches_plain_and_pallas_synthetic(case):
    spec, dest, rows, codes, fill, cdict, x = _synthetic(
        seed=len(case), **SYNTHETIC_CASES[case])
    edest, ecodes = _encoded(spec, dest, rows, codes)
    plain = TPC._fused_decode_gather_scatter_plain(
        spec, _words(edest), _codes(ecodes), _fill(fill),
        torch.from_numpy(cdict), torch.from_numpy(x)).numpy()
    pallas = np.asarray(JPC.fused_decode_gather_scatter(
        spec, jnp.asarray(edest), jnp.asarray(ecodes), jnp.asarray(cdict),
        jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(
        _write_once(spec, dest, rows, codes, fill, cdict, x), plain)


def test_fused_checks_operands():
    spec, dest, rows, codes, fill, cdict, x = _synthetic(8, 3)
    edest, _ = _encoded(spec, dest, rows, codes)
    edest, fill = _words(edest), _fill(fill)
    with pytest.raises(ValueError, match="ecodes"):
        TPC.fused_decode_gather_scatter(
            spec, edest, _codes(codes.astype(np.uint16)), fill,
            torch.from_numpy(cdict), torch.from_numpy(x))
    with pytest.raises(ValueError, match="x_c"):
        TPC.fused_decode_gather_scatter(
            spec, edest, _codes(codes), fill, torch.from_numpy(cdict),
            torch.from_numpy(x[:-1]))
    with pytest.raises(ValueError, match="fill"):
        TPC.fused_decode_gather_scatter(
            spec, edest, _codes(codes), fill[:-1], torch.from_numpy(cdict),
            torch.from_numpy(x))
    with pytest.raises(ValueError, match="out"):
        TPC.fused_decode_gather_scatter(
            spec, edest, _codes(codes), fill, torch.from_numpy(cdict),
            torch.from_numpy(x), out=torch.empty(spec["n_recv"]))


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
        nl, nwd = spec["n_live"], TPC.packed_words(spec["n_live"],
                                                    spec["w_dest"])
        fill = TPC.send_fill(TPC.unpack_bits_np(enc["dest"][:nwd], nl,
                                                spec["w_dest"]),
                             spec["D"], spec["cap_eff"])
        got = TPC.fused_decode_gather_scatter(
            spec, _words(enc["dest"]), _codes(enc["coeff"]), _fill(fill),
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


@pytest.fixture(scope="module", params=[12, 16],
                ids=["chain_12_symm", "chain_16_symm"])
def plans(request):
    """Every encoded chunk of the JAX engine's and the port's streamed plan
    of one ring, at a small row chunk, with its spec and dictionary."""
    op_j = jax_chain(request.param, symmetric=True)
    op_j.basis.build()
    update_config(stream_compress="lossless")
    try:
        e_j = JaxEngine(op_j, n_devices=1, mode="streamed", batch_size=32)
    finally:
        update_config(stream_compress="off")
    e_t = TorchEngine(operator_from_reference(operator_arrays(op_j),
                                              device="cpu"),
                      batch_size=32, device="cpu", mode="streamed",
                      stream_compress="lossless")
    return {
        "jax": (e_j._codec.spec, e_j._codec.dict_device_row(0),
                [c[0] for c in e_j._plan_chunks]),
        "port": (e_t._codec.spec, e_t._cdict[0].numpy(),
                 [e_t.plan_chunk(ci) for ci in range(e_t.nchunks)]),
    }


@pytest.mark.parametrize("package", ["jax", "port"])
def test_plan_honours_kernel_precondition(plans, package):
    """On every chunk of a real plan: the live entries fill exactly the
    prefix of their bucket that the fill counts give (the port stores them
    beside the chunk; for the JAX plan they are derived from its dest
    stream), which at one device is the rok flags; padding entries form
    the tail; the plain version (with the kernel's signature) equals the
    Pallas kernel bit for bit, and the kernel's write-once model equals
    both."""
    spec, cdict, chunks = plans[package]
    nl, n_recv, cap = spec["n_live"], spec["n_recv"], spec["cap_eff"]
    nwd = TPC.packed_words(nl, spec["w_dest"])
    assert len(chunks) > 1
    rng = np.random.default_rng(7)
    slot = np.arange(n_recv)
    for enc in chunks:
        dest = TPC.unpack_bits_np(enc["dest"][:nwd], nl,
                                  spec["w_dest"]).astype(np.int64)
        rows = TPC.unpack_bits_np(enc["dest"][nwd:], nl,
                                  spec["w_row"]).astype(np.int64)
        rok = TPC.unpack_bits_np(enc["rok"], n_recv, 1).astype(bool)
        fill = TPC.send_fill(dest, spec["D"], cap)
        if package == "port":
            np.testing.assert_array_equal(enc["fill"], fill)
        pad = dest >= n_recv
        assert not np.any(pad[:-1] & ~pad[1:]), "padding before a live entry"
        written = np.zeros(n_recv, np.int64)
        np.add.at(written, dest[~pad], 1)
        assert written.max(initial=0) <= 1, "two live entries share a slot"
        np.testing.assert_array_equal(written == 1,
                                      slot % cap < fill[slot // cap])
        np.testing.assert_array_equal(rok, written == 1)     # D = 1
        x = rng.standard_normal(spec["cshape"][0])
        plain = TPC._fused_decode_gather_scatter_plain(
            spec, _words(enc["dest"]), _codes(enc["coeff"]), _fill(fill),
            torch.from_numpy(cdict), torch.from_numpy(x)).numpy()
        pallas = np.asarray(JPC.fused_decode_gather_scatter(
            spec, jnp.asarray(enc["dest"]), jnp.asarray(enc["coeff"]),
            jnp.asarray(cdict), jnp.asarray(x), interpret=True))
        np.testing.assert_array_equal(plain, pallas)
        np.testing.assert_array_equal(
            _write_once(spec, dest, rows, enc["coeff"], fill, cdict, x),
            plain)
