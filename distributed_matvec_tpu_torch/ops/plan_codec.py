"""Compressed plan streams: host-side encode, on-device decode (format v1).

PyTorch counterpart of ``distributed_matvec_tpu/ops/plan_codec.py``.  The
host side (bitpacking, :class:`PlanCodec`) is copied from it for every tier
and for real and complex128 coefficients (the (re, im) pair form is a TPU
workaround and is not ported).  bf16 rounds through torch's ``bfloat16`` on
the host and travels as its u16 bit pattern, so no ml_dtypes is needed.
The device side is torch: :func:`unpack_bits`, :func:`decode_plan_shard`
and the fused decode + gather + multiply + scatter of one chunk,
:func:`fused_decode_gather_scatter`, a hand-written CUDA kernel
(``csrc/fused_decode.cu``) with its plain version beside it.

Per (row chunk, shard) the streamed plan holds four arrays, encoded as:

``dest``  compressed tiers: TWO concatenated little-endian u32 word streams
    — the live entries' trimmed exchange slots at ``w_dest = bits(D·cap_eff)``
    bits each (the ``D·cap_eff`` sentinel marks padding), then their row
    indices at ``w_row = bits(B−1)``.  ``off``: the raw [B·T] i32 array.
``ridx``  [D·cap_eff] receive-side basis index, bitpacked at ``bits(M−1)``;
    ``off``: raw i32.
``rok``   [D·cap_eff] receive-side flag, bitpacked 1 bit/flag (every tier).
``coeff`` compressed tiers: live entries only, **dictionary-coded** (u8/u16
    codes plus one small per-shard f64 or c128 table that stays on the
    device) when the distinct coefficient values fit ``DICT_MAX``;
    otherwise raw per the tier — ``lossless`` f64, ``f32``, ``bf16`` as u16
    bits; complex values as ``[n, 2]`` (re, im) columns.  ``off``: the raw
    [B, T] f64/c128 array.

Tiers: ``off`` (the raw layout, ``rok`` bitpacked), ``lossless`` (dead-entry
compaction, exchange-capacity trim, exact values), ``f32`` and ``bf16``
(coefficient values quantized once, at encode time; indices exact).  The
decode always lands in f64/c128.

Dead entries (coefficient 0) are dropped on the host and the exchange slots
are re-based to the true maximum bucket fill, so the decoded arithmetic is
value-identical and order-identical to the raw plan's.  A hybrid codec
(``term_mask``) stores only the streamed terms' entries but trims the slots
over every live entry.  Beside the encoded streams the port keeps each
chunk's per-bucket fill counts (:func:`send_fill`): the send buffer's
occupancy, which the decode kernel needs to zero the empty slots and which
``rok`` (the receive side) gives only at D = 1.

On the device, u32 word streams travel as int32 tensors with the same bits
and u16 codes (and bf16 bits) as int16 tensors; both are widened and masked
before use.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Optional

import numpy as np
import torch

__all__ = [
    "PLAN_CODEC_VERSION",
    "DICT_MAX",
    "TIERS",
    "bits_for",
    "packed_words",
    "pack_bits",
    "unpack_bits_np",
    "unpack_bits",
    "PlanCodec",
    "decode_plan_shard",
    "decode_recv",
    "send_fill",
    "fused_decode_gather_scatter",
]

PLAN_CODEC_VERSION = 1

#: Per-shard dictionary ceiling: u16 codes.  Beyond it the coefficient
#: stream falls back to the tier's raw form.
DICT_MAX = 1 << 16

TIERS = ("off", "lossless", "f32", "bf16")

#: coefficient kinds of the port's codec (JAX's "pair" is a TPU workaround)
CKINDS = ("real", "complex")


# ---------------------------------------------------------------------------
# fixed-width bitpacking (host pack / host + device unpack)
# Copied from distributed_matvec_tpu/ops/plan_codec.py.


def bits_for(maxval: int) -> int:
    """Bits needed to represent values in ``[0, maxval]`` (min 1)."""
    return max(int(maxval).bit_length(), 1)


def packed_words(n: int, width: int) -> int:
    """u32 words holding ``n`` ``width``-bit values, +1 spare word so the
    two-word device read never runs off the end."""
    return (n * width + 31) // 32 + 1


#: pack_bits block size: bounds the transient bit-expansion scratch to
#: ~BLK·width bytes instead of O(n·width).  A multiple of 8, so every
#: block's bit run starts on a byte boundary.
_PACK_BLOCK = 1 << 17


def pack_bits(values, width: int) -> np.ndarray:
    """``values`` → little-endian u32 word stream at ``width`` bits each
    (bit ``k`` of value ``j`` lands at global bit ``j·width + k``).
    Packs in bounded blocks: peak scratch is O(_PACK_BLOCK·width), not
    O(n·width)."""
    if not 1 <= width <= 32:
        raise ValueError(f"width {width} outside [1, 32]")
    v = np.asarray(values).reshape(-1)
    if v.dtype == np.bool_:
        v = v.astype(np.uint8)
    v = v.astype(np.uint64)
    n = v.size
    if n and width < 64 and int(v.max()) >> width:
        raise ValueError(
            f"value {int(v.max())} does not fit in {width} bits")
    shifts = np.arange(width, dtype=np.uint64)
    nw = packed_words(n, width)
    out = np.zeros(nw * 4, np.uint8)
    for s in range(0, n, _PACK_BLOCK):
        blk = v[s: s + _PACK_BLOCK]
        bits = ((blk[:, None] >> shifts[None, :])
                & np.uint64(1)).astype(np.uint8)
        packed = np.packbits(bits.reshape(-1), bitorder="little")
        b0 = (s * width) // 8          # block-aligned: s·width ≡ 0 (mod 8)
        out[b0: b0 + packed.size] = packed
    return out.view("<u4").copy()


def unpack_bits_np(packed: np.ndarray, n: int, width: int) -> np.ndarray:
    """Host inverse of :func:`pack_bits` (u64 values)."""
    b = np.unpackbits(np.ascontiguousarray(packed).view(np.uint8),
                      bitorder="little")
    idx = (np.arange(n, dtype=np.int64)[:, None] * width
           + np.arange(width, dtype=np.int64)[None, :])
    sh = np.arange(width, dtype=np.uint64)[None, :]
    return (b[idx].astype(np.uint64) << sh).sum(axis=1, dtype=np.uint64)


def unpack_bits(packed: torch.Tensor, n: int, width: int) -> torch.Tensor:
    """Device unpack of ``n`` ``width``-bit values from an int32 tensor of
    u32 words → int64 [n].  Bit offsets are computed in int64 (``n·width``
    exceeds 2³² at chain_32-class sizes); the second word is read only for a
    value that spills into it, so no shift by 32 is ever issued."""
    words = packed.to(torch.int64) & 0xFFFFFFFF
    bit0 = torch.arange(n, dtype=torch.int64, device=packed.device) * width
    w0 = bit0 >> 5
    off = bit0 & 31
    lo = words[w0] >> off
    spill = (off + width) > 32
    sh = torch.where(spill, 32 - off, 0)
    w1 = torch.clamp(w0 + 1, max=packed.shape[0] - 1)
    hi = torch.where(spill, (words[w1] << sh) & 0xFFFFFFFF, 0)
    return (lo | hi) & ((1 << width) - 1)


# ---------------------------------------------------------------------------
# coefficient canonicalization / quantization
# Copied from distributed_matvec_tpu/ops/plan_codec.py; bf16 through torch.


def _canonical(cf: np.ndarray, ckind: str) -> np.ndarray:
    """Flat f64 (real) or c128 (complex) view of a coeff array: the
    dictionary's key space and the liveness test."""
    cf = np.asarray(cf)
    if ckind == "real":
        return cf.astype(np.float64, copy=False).reshape(-1)
    return cf.astype(np.complex128, copy=False).reshape(-1)


def _bf16_bits(vals: np.ndarray) -> np.ndarray:
    """f64 values rounded to bfloat16 (to nearest even, one rounding from
    f64), as their u16 bit patterns."""
    t = torch.from_numpy(np.ascontiguousarray(vals, np.float64))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _bf16_values(bits: np.ndarray) -> np.ndarray:
    """u16 bf16 bit patterns → their f64 values (exact: the 16 bits are the
    high half of an f32 word)."""
    w = np.asarray(bits, np.uint16).astype(np.uint32) << np.uint32(16)
    return w.view(np.float32).astype(np.float64)


def _quantize(vals: np.ndarray, tier: str) -> np.ndarray:
    """Round values through the tier's storage precision (returned at full
    precision — the error is baked in exactly once, at encode time)."""
    if tier in ("off", "lossless"):
        return vals
    if np.iscomplexobj(vals):
        if tier == "f32":
            return vals.astype(np.complex64).astype(np.complex128)
        return (_bf16_values(_bf16_bits(vals.real))
                + 1j * _bf16_values(_bf16_bits(vals.imag)))
    if tier == "f32":
        return vals.astype(np.float32).astype(np.float64)
    return _bf16_values(_bf16_bits(vals))


def _raw_store(flat: np.ndarray, ckind: str, tier: str) -> np.ndarray:
    """Storage form of a compacted raw (non-dictionary) coefficient vector
    (canonical f64/c128 live values): [n] f64/f32/bf16-as-u16 for real,
    [n, 2] (re, im) columns for complex."""
    if ckind != "real":
        flat = np.stack([flat.real, flat.imag], axis=-1)
    else:
        flat = flat.real
    if tier == "lossless":
        return flat.astype(np.float64)
    if tier == "f32":
        return flat.astype(np.float32)
    return _bf16_bits(flat)


def _raw_load(stored: np.ndarray, ckind: str) -> np.ndarray:
    """Host inverse of :func:`_raw_store` back to canonical f64/c128."""
    if stored.dtype == np.uint16:
        v = _bf16_values(stored)
    else:
        v = stored.astype(np.float64)
    if ckind != "real":
        return v[..., 0] + 1j * v[..., 1]
    return v


# ---------------------------------------------------------------------------
# the codec (host)
# Copied from distributed_matvec_tpu/ops/plan_codec.py.


class PlanCodec:
    """One engine's plan codec: a static ``spec`` (JSON-serializable) plus
    the per-shard coefficient dictionaries."""

    def __init__(self, spec: Dict, dicts: Optional[Dict[int, np.ndarray]]
                 = None):
        if spec.get("version") != PLAN_CODEC_VERSION:
            raise ValueError(
                f"plan codec version {spec.get('version')} != "
                f"{PLAN_CODEC_VERSION}")
        if spec["tier"] not in TIERS:
            raise ValueError(f"unknown compress tier {spec['tier']!r}")
        if spec.get("ckind", "real") not in CKINDS:
            raise NotImplementedError(
                f"coefficient kind {spec['ckind']!r}: the port's codec "
                f"takes {'|'.join(CKINDS)} (the pair form is a TPU "
                "workaround)")
        self.spec = spec
        self.dicts: Dict[int, np.ndarray] = dicts or {}

    # -- construction ----------------------------------------------------

    @classmethod
    def build(cls, tier: str, chunks, n_dest: int, cap_build: int,
              n_devices: int, shard_size: int, cshape, ckind: str,
              agree: Optional[Callable] = None,
              dict_max: int = DICT_MAX,
              term_mask: Optional[np.ndarray] = None) -> "PlanCodec":
        """Codec for a freshly built plan.  ``chunks`` is the engine's
        ``[{shard: pc}]`` raw-chunk list; the scan measures the live-entry
        census (compaction bound), the true maximum bucket fill (capacity
        trim), and the distinct-coefficient census (dictionary decision).
        ``agree`` (one shard per rank) maps the local decisions
        ``(use_dict, nd, fill, n_live)`` to job-wide ones — the encoded
        shapes enter every rank's apply, so every rank must encode alike.

        ``term_mask`` (hybrid mode) is a [T] bool array marking which
        terms' entries are STORED (True = streamed); the other terms are
        recomputed on the device per apply.  The capacity trim still
        measures ALL live entries — the merged slot layout is the full
        plan's, so the streamed entries keep exactly the slots of the
        full-streamed apply and the recompute side fills the per-bucket
        complement — while the dest/row/coeff streams (and the dictionary)
        carry only the masked subset."""
        D = int(n_devices)
        T = int(cshape[1])
        spec = {"version": PLAN_CODEC_VERSION, "tier": tier,
                "n_dest": int(n_dest), "D": D,
                "cap_build": int(cap_build), "cap_eff": int(cap_build),
                "n_recv": D * int(cap_build),
                "w_dest": bits_for(D * int(cap_build)),
                "w_ridx": bits_for(max(shard_size - 1, 1)),
                "w_row": bits_for(max(int(cshape[0]) - 1, 1)),
                "n_live": int(n_dest),
                "cshape": [int(s) for s in cshape], "ckind": ckind,
                "coeff": "raw", "code_bits": 0, "ndict": 0}
        cls(spec)                      # validates tier and kind up front
        if term_mask is not None:
            term_mask = np.asarray(term_mask, bool).reshape(-1)
            if term_mask.size != T:
                raise ValueError(
                    f"term_mask has {term_mask.size} entries for "
                    f"{T} terms")
            spec["hybrid"] = True
            spec["stream_terms"] = [int(t) for t in
                                    np.nonzero(term_mask)[0]]
            if tier == "off":
                raise ValueError(
                    "a term-masked (hybrid) plan requires a compacted "
                    "tier — the raw [B, T] layout cannot drop terms")
        if tier == "off":
            return cls(spec)
        mask_flat = None if term_mask is None \
            else np.tile(term_mask, int(cshape[0]))
        uniq: Dict[int, np.ndarray] = {}
        n_live = 0
        fill = 0
        for per in chunks:
            for d, pc in per.items():
                flat = _canonical(pc["coeff"], ckind)
                # live = contributes to the apply: nonzero coefficient AND
                # a real exchange slot (the D·Cap sentinel marks entries
                # the raw scatter drops)
                dest_all = np.asarray(pc["dest"], np.int64).reshape(-1)
                live = (flat != 0) & (dest_all < D * cap_build)
                dest = dest_all[live]
                if dest.size:
                    # in-bucket rank: live positions are consecutive per
                    # bucket, so max(pos)+1 is the fill.  ALL live entries
                    # count here even under a term mask: the trim defines
                    # the merged slot space
                    fill = max(fill, int((dest % cap_build).max()) + 1)
                if mask_flat is not None:
                    live &= mask_flat
                n_live = max(n_live, int(live.sum()))
                u = np.unique(flat[live])
                prev = uniq.get(d)
                uniq[d] = u if prev is None else \
                    np.unique(np.concatenate([prev, u]))
        nd = max((u.size for u in uniq.values()), default=0)
        use_dict = bool(uniq) and nd <= dict_max
        fill = max(fill, 1)
        n_live = max(((n_live + 7) // 8) * 8, 8)
        if agree is not None:
            use_dict, nd, fill, n_live = agree(use_dict, nd, fill, n_live)
        spec["cap_eff"] = int(min(fill, cap_build))
        spec["n_recv"] = D * spec["cap_eff"]
        spec["w_dest"] = bits_for(spec["n_recv"])
        spec["n_live"] = int(min(n_live, n_dest))
        if use_dict and nd:
            spec["coeff"] = "dict"
            spec["code_bits"] = 8 if nd <= (1 << 8) else 16
            spec["ndict"] = int(nd)
            return cls(spec, uniq)
        return cls(spec)

    def spec_json(self) -> str:
        return json.dumps(self.spec, sort_keys=True)

    @classmethod
    def from_spec_json(cls, s: str) -> "PlanCodec":
        spec = json.loads(s)
        for k in ("tier", "n_dest", "D", "cap_build", "cap_eff", "n_recv",
                  "w_dest", "w_ridx", "w_row", "n_live", "cshape", "ckind",
                  "coeff"):
            if k not in spec:
                raise ValueError(f"codec spec missing {k!r}")
        return cls(spec)

    def set_dict(self, d: int, values: np.ndarray) -> None:
        """Attach shard ``d``'s dictionary, as :meth:`dict_store` wrote it:
        real f64 or (re, im) f64 pairs."""
        if self.spec["ckind"] == "real":
            self.dicts[d] = np.asarray(values, np.float64).reshape(-1)
        else:
            v = np.asarray(values, np.float64)
            self.dicts[d] = v[:, 0] + 1j * v[:, 1]

    def dict_store(self, d: int) -> np.ndarray:
        """Shard ``d``'s dictionary in stored form: the UNPADDED sorted
        original-precision values as plain f64 columns.  Originals, not
        quantized: they are the ``searchsorted`` key space; quantization is
        applied downstream, in :meth:`dict_device_row` and
        :meth:`decode_chunk_host`."""
        vals = self.dicts[d]
        if self.spec["ckind"] == "real":
            return np.asarray(vals.real, np.float64)
        return np.stack([vals.real, vals.imag], axis=-1).astype(np.float64)

    def dict_device_row(self, d: int) -> np.ndarray:
        """Shard ``d``'s device-resident decode table, padded to the agreed
        ``ndict`` so the stacked operand is uniform: [nd] f64 (real) or
        [nd] c128 (complex).  Values are quantized per the tier (the one
        place the precision loss happens).  Empty row when the codec
        carries no dict."""
        nd = self.spec["ndict"]
        dt = np.float64 if self.spec["ckind"] == "real" else np.complex128
        if not nd or self.spec["coeff"] != "dict":
            return np.zeros(0, dt)
        vals = _quantize(self.dicts[d], self.spec["tier"])
        out = np.zeros(nd, dt)
        out[: vals.size] = vals.real if dt == np.float64 else vals
        return out

    # -- compaction (host) ------------------------------------------------

    def term_mask(self) -> Optional[np.ndarray]:
        """The [T] bool stream mask of a hybrid (term-masked) codec, None
        otherwise."""
        if not self.spec.get("hybrid"):
            return None
        mask = np.zeros(int(self.spec["cshape"][1]), bool)
        mask[np.asarray(self.spec.get("stream_terms", []), np.int64)] = True
        return mask

    def compact_raw(self, pc: Dict) -> Dict:
        """One raw (chunk, shard) record → its compacted host-side form:
        live entries only (the masked term subset for a hybrid codec),
        trimmed exchange slots, explicit row indices.  Keys:
        ``dest``/``row``/``coeff`` ([n_live], canonical f64/c128 coeff,
        pads: drop-sentinel / 0 / 0) and ``ridx``/``rok`` ([D·cap_eff], the
        per-bucket prefix of the raw receive layout)."""
        s = self.spec
        D, cap_b, cap_e = s["D"], s["cap_build"], s["cap_eff"]
        nl = s["n_live"]
        flat = _canonical(pc["coeff"], s["ckind"])
        dest_all = np.asarray(pc["dest"], np.int64).reshape(-1)
        live = (flat != 0) & (dest_all < D * cap_b)   # build's definition
        mask = self.term_mask()
        if mask is not None:
            live &= np.tile(mask, int(s["cshape"][0]))
        dest = dest_all[live]
        if dest.size > nl:
            raise ValueError(
                f"{dest.size} live entries exceed the codec's n_live "
                f"{nl} — plan/codec mismatch")
        key = dest // cap_b
        pos = dest - key * cap_b
        if pos.size and int(pos.max()) >= cap_e:
            raise ValueError(
                f"bucket fill {int(pos.max()) + 1} exceeds the codec's "
                f"cap_eff {cap_e} — plan/codec mismatch")
        d_out = np.full(nl, D * cap_e, np.int64)
        d_out[: dest.size] = key * cap_e + pos
        r_out = np.zeros(nl, np.int64)
        r_out[: dest.size] = np.nonzero(live)[0] // s["cshape"][1]
        c_out = np.zeros(nl, flat.dtype)
        c_out[: dest.size] = flat[live]
        ridx = np.asarray(pc["ridx"]).reshape(D, cap_b)[:, :cap_e]
        rok = np.asarray(pc["rok"]).reshape(D, cap_b)[:, :cap_e]
        return {"dest": d_out, "row": r_out, "coeff": c_out,
                "ridx": np.ascontiguousarray(ridx).reshape(-1),
                "rok": np.ascontiguousarray(rok).reshape(-1)}

    # -- encode / decode (host) ------------------------------------------

    def encode_chunk(self, pc: Dict, d: int) -> Dict:
        """One raw (chunk, shard) record → its encoded form (same keys).
        Compressed tiers fold the row-index stream into the ``dest`` array
        (two concatenated word streams)."""
        s = self.spec
        if s["tier"] == "off":
            return {"dest": np.asarray(pc["dest"]),
                    "coeff": np.asarray(pc["coeff"]),
                    "ridx": np.asarray(pc["ridx"]),
                    "rok": pack_bits(pc["rok"], 1)}
        cp = self.compact_raw(pc)
        out = {"dest": np.concatenate([pack_bits(cp["dest"], s["w_dest"]),
                                       pack_bits(cp["row"], s["w_row"])]),
               "ridx": pack_bits(cp["ridx"], s["w_ridx"]),
               "rok": pack_bits(cp["rok"], 1)}
        if s["coeff"] == "dict":
            codes = np.searchsorted(self.dicts[d], cp["coeff"])
            np.clip(codes, 0, max(self.dicts[d].size - 1, 0), out=codes)
            ok = self.dicts[d][codes] == cp["coeff"]
            # padding zeros may legitimately be absent from the dict —
            # their decode value is irrelevant (drop-sentinel dest)
            if not np.all(ok | (cp["coeff"] == 0)):
                raise ValueError(
                    f"shard {d}: coefficient outside its dictionary — "
                    "plan/codec mismatch")
            # pads (coeff 0) take a deterministic in-range code: their
            # decode value is dropped at the sentinel dest either way
            pad_code = min(int(np.searchsorted(self.dicts[d], 0.0)),
                           max(self.dicts[d].size - 1, 0))
            codes[cp["coeff"] == 0] = pad_code
            out["coeff"] = codes.astype(
                np.uint8 if s["code_bits"] == 8 else np.uint16)
        else:
            out["coeff"] = _raw_store(cp["coeff"], s["ckind"], s["tier"])
        return out

    def decode_chunk_host(self, enc: Dict, d: int) -> Dict:
        """Host inverse of :meth:`encode_chunk`.  For the ``off`` tier this
        is the raw record back; compressed tiers return the COMPACT form
        (:meth:`compact_raw` keys).  Quantized tiers return the quantized
        values at full precision."""
        s = self.spec
        n_recv = s["n_recv"]
        if s["tier"] == "off":
            return {"dest": enc["dest"], "coeff": enc["coeff"],
                    "ridx": enc["ridx"],
                    "rok": unpack_bits_np(enc["rok"], n_recv,
                                          1).astype(bool)}
        nl = s["n_live"]
        nwd = packed_words(nl, s["w_dest"])
        dest = unpack_bits_np(enc["dest"][:nwd], nl,
                              s["w_dest"]).astype(np.int64)
        row = unpack_bits_np(enc["dest"][nwd:], nl,
                             s["w_row"]).astype(np.int64)
        ridx = unpack_bits_np(enc["ridx"], n_recv,
                              s["w_ridx"]).astype(np.int32)
        rok = unpack_bits_np(enc["rok"], n_recv, 1).astype(bool)
        if s["coeff"] == "dict":
            coeff = _quantize(self.dicts[d], s["tier"])[
                np.asarray(enc["coeff"], np.int64)]
        else:
            coeff = _raw_load(np.asarray(enc["coeff"]), s["ckind"])
        if s["ckind"] == "real":
            coeff = coeff.real if np.iscomplexobj(coeff) else coeff
        # padding entries decode to dest == drop sentinel; zero their
        # coeff so the host form equals compact_raw exactly
        coeff = np.where(dest == n_recv, 0, coeff)
        return {"dest": dest, "row": row, "coeff": coeff,
                "ridx": ridx, "rok": rok}

    # -- size accounting --------------------------------------------------

    def raw_chunk_bytes(self) -> int:
        """Uncompressed bytes of ONE (chunk, shard) record — dest i32 +
        f64 (real) or c128 (complex) coeff + untrimmed ridx i32 + rok
        byte-bool."""
        s = self.spec
        cb = 8 if s["ckind"] == "real" else 16
        ncf = int(np.prod(s["cshape"][:2]))
        n_recv_raw = s["D"] * s["cap_build"]
        return s["n_dest"] * 4 + ncf * cb + n_recv_raw * (4 + 1)

    @staticmethod
    def encoded_bytes(enc: Dict) -> int:
        return sum(int(np.asarray(a).nbytes) for a in enc.values())


# ---------------------------------------------------------------------------
# device decode


def _code_index(codes: torch.Tensor) -> torch.Tensor:
    """u8 codes (uint8) or u16 codes (int16 bits) → int64 indices."""
    idx = codes.to(torch.int64)
    return idx & 0xFFFF if codes.dtype == torch.int16 else idx


def decode_recv(spec: Dict, ridx, rok):
    """The receive layout alone: ``(ridx int64 [n_recv], rok bool
    [n_recv])``, from raw i32 (``off``) or bitpacked words."""
    n_recv = spec["n_recv"]
    rok_b = unpack_bits(rok, n_recv, 1).to(torch.bool)
    if spec["tier"] == "off":
        return ridx.to(torch.int64), rok_b
    return unpack_bits(ridx, n_recv, spec["w_ridx"]), rok_b


def decode_plan_shard(spec: Dict, dest, coeff, ridx, rok, cdict):
    """Shard-local device decode of one encoded chunk.  ``off`` tier: the
    raw layout ``(dest int64 [B·T], coeff f64/c128 [B, T], ridx int64
    [D·cap_build], rok bool)``.  Compressed tiers: the compact form
    ``(dest int64 [n_live], row int64 [n_live], coeff f64/c128 [n_live],
    ridx int64 [D·cap_eff], rok bool [D·cap_eff])``."""
    ridx_i, rok_b = decode_recv(spec, ridx, rok)
    if spec["tier"] == "off":
        return dest.to(torch.int64), coeff, ridx_i, rok_b
    nl = spec["n_live"]
    nwd = packed_words(nl, spec["w_dest"])
    dest_i = unpack_bits(dest[:nwd], nl, spec["w_dest"])
    row_i = unpack_bits(dest[nwd:], nl, spec["w_row"])
    return dest_i, row_i, _decode_coeff_vals(spec, coeff, cdict), ridx_i, \
        rok_b


def _decode_coeff_vals(spec: Dict, coeff, cdict):
    """Compacted coefficient stream → [n_live] live values at full
    precision, f64 (real) or c128 (complex): a dictionary gather, or the
    raw f64/f32 values, or bf16 bit patterns (int16) widened as the high
    half of an f32 word; complex values arrive as ``[n_live, 2]`` (re, im)
    columns."""
    if spec["coeff"] == "dict":
        return cdict[_code_index(coeff)]
    if coeff.dtype == torch.int16:             # bf16 raw, as bit patterns
        w = torch.zeros(coeff.shape + (2,), dtype=torch.int16,
                        device=coeff.device)
        w[..., 1] = coeff                      # little-endian high half
        v = w.view(torch.float32)[..., 0].to(torch.float64)
    else:
        v = coeff.to(torch.float64)
    if spec["ckind"] == "complex":
        return torch.complex(v[..., 0], v[..., 1])
    return v


def send_fill(dest, n_buckets: int, cap: int) -> np.ndarray:
    """The send buffer's per-bucket fill counts of one chunk: [D] int32,
    the number of live entries routed to each destination shard.  ``dest``
    holds the chunk's destinations ``bucket·cap + rank`` (the raw plan's at
    ``cap_build``, or the compacted stream's at ``cap_eff``), dropped and
    padding entries at ``D·cap`` or above.  The entries of bucket k hold
    the in-bucket ranks ``0 … fill[k]−1``, so its occupied slots are
    exactly that prefix — the send side's occupancy, which the chunk's
    ``rok`` stream (the receive buffer, after the exchange) equals only at
    D = 1."""
    dest = np.asarray(dest, np.int64).reshape(-1)
    live = dest[dest < n_buckets * cap]
    return np.bincount(live // cap, minlength=n_buckets).astype(np.int32)


def _fused_decode_gather_scatter_plain(spec: Dict, edest, ecodes, fill,
                                       cdict, x_c):
    """The plain PyTorch version of :func:`fused_decode_gather_scatter`,
    with the JAX kernel's semantics: zero-fill the send buffer, unpack,
    dictionary gather × ``x[row]``, scatter.  It takes ``fill`` for the
    kernel's signature and does not read it, so comparing the two on a real
    plan also checks the kernel's precondition on the fill counts."""
    del fill
    nl, n_recv = spec["n_live"], spec["n_recv"]
    nwd = packed_words(nl, spec["w_dest"])
    dest = unpack_bits(edest[:nwd], nl, spec["w_dest"])
    rows = unpack_bits(edest[nwd:], nl, spec["w_row"])
    amps = cdict[_code_index(ecodes)] * x_c[rows]
    out = torch.zeros(n_recv + 1, dtype=torch.float64, device=x_c.device)
    # dest slots are unique by construction; every padding entry lands in
    # the trailing drop slot with the same value (pad code × x[0])
    out.index_put_((torch.clamp(dest, max=n_recv),), amps)
    return out


def _check_fused_operands(spec, edest, ecodes, fill, cdict, x_c,
                          out=None) -> None:
    nl = spec["n_live"]
    if spec["coeff"] != "dict":
        raise NotImplementedError(
            "the fused decode kernel takes dictionary-coded coefficients")
    code_dtype = {8: torch.uint8, 16: torch.int16}.get(spec["code_bits"])
    words = packed_words(nl, spec["w_dest"]) + packed_words(nl,
                                                             spec["w_row"])
    D, n_recv = spec["D"], spec["n_recv"]
    checks = [
        (edest.dtype == torch.int32 and edest.dim() == 1
         and edest.numel() == words, f"edest: int32 [{words}]"),
        (ecodes.dtype == code_dtype and ecodes.dim() == 1
         and ecodes.numel() == nl, f"ecodes: {code_dtype} [{nl}]"),
        (fill.dtype == torch.int32 and fill.dim() == 1
         and fill.numel() == D and D * spec["cap_eff"] == n_recv
         and n_recv < 1 << 31,
         f"fill: int32 [{D}] over {D} buckets of cap_eff slots, "
         f"n_recv = D·cap_eff < 2^31"),
        (cdict.dtype == torch.float64 and cdict.dim() == 1
         and cdict.numel() == spec["ndict"],
         f"cdict: float64 [{spec['ndict']}]"),
        (x_c.dtype == torch.float64 and x_c.dim() == 1
         and x_c.numel() == spec["cshape"][0],
         f"x_c: float64 [{spec['cshape'][0]}]"),
        (out is None or (out.dtype == torch.float64 and out.dim() == 1
                         and out.numel() == n_recv + 1),
         f"out: float64 [{n_recv + 1}]"),
    ]
    for ok, want in checks:
        if not ok:
            raise ValueError(f"fused_decode_gather_scatter operand {want}")
    operands = (edest, ecodes, fill, cdict, x_c) + (
        () if out is None else (out,))
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(
            f"fused_decode_gather_scatter operands on several devices: "
            f"{sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("fused_decode_gather_scatter operands must be "
                         "contiguous")


def fused_decode_gather_scatter(spec: Dict, edest, ecodes, fill, cdict, x_c,
                                out=None):
    """The fused decode + gather + multiply + scatter of one encoded chunk:
    unpack the bitpacked destination and row streams, decode the
    coefficient codes through the dictionary, gather each live entry's
    ``x`` row, multiply, and write the amplitude into the send buffer.
    Returns the ``[D·cap_eff + 1]`` f64 send buffer (the trailing slot
    collects the padding entries); every slot no live entry writes is 0.
    With ``out`` (a contiguous float64 ``[D·cap_eff + 1]`` tensor) the
    buffer is written there and ``out`` is returned.

    ``fill`` is the chunk's [D] int32 per-bucket fill counts
    (:func:`send_fill`).  The kernel writes the buffer once, without a
    separate zero fill, and takes the precondition the plan build
    guarantees: the live entries of bucket k occupy exactly its slots
    ``[k·cap_eff, k·cap_eff + fill[k])``, and padding entries form the tail
    of the live stream.

    Scope: real sector, single column, dictionary-coded coefficients.
    CPU tensors take the plain version; CUDA tensors launch the kernel of
    ``csrc/fused_decode.cu`` on the current stream (``launches`` counts
    them) or raise."""
    _check_fused_operands(spec, edest, ecodes, fill, cdict, x_c, out)
    device = x_c.device
    if device.type == "cpu":
        y = _fused_decode_gather_scatter_plain(spec, edest, ecodes, fill,
                                               cdict, x_c)
        return y if out is None else out.copy_(y)
    if device.type != "cuda":
        raise ValueError(f"no fused decode kernel for device {device}")
    if out is None:
        out = torch.empty(spec["n_recv"] + 1, dtype=torch.float64,
                          device=device)
    _launch_fused_decode(spec, edest, ecodes, fill, cdict, x_c, out)
    fused_decode_gather_scatter.launches += 1
    return out


fused_decode_gather_scatter.launches = 0


def _launch_fused_decode(spec: Dict, edest, ecodes, fill, cdict, x_c,
                         out) -> None:
    """Launch the kernel of ``csrc/fused_decode.cu`` on checked CUDA
    operands, writing every slot of ``out`` (float64 [n_recv + 1]) on the
    current stream; raises if the launch fails.  Not counted in
    ``launches``."""
    from . import cuda_kernels

    lib = cuda_kernels.library("fused_decode")
    nl = spec["n_live"]
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = lib.dmt_fused_decode_gather_scatter(
        edest.data_ptr(), packed_words(nl, spec["w_dest"]),
        packed_words(nl, spec["w_row"]), ecodes.data_ptr(),
        spec["code_bits"], fill.data_ptr(), spec["D"], cdict.data_ptr(),
        x_c.data_ptr(), out.data_ptr(), nl, spec["w_dest"], spec["w_row"],
        spec["n_recv"], stream)
    if rc:
        raise RuntimeError(
            f"fused_decode_gather_scatter launch failed: "
            f"{cuda_kernels.error_string(rc)}")
