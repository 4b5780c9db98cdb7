"""Compressed plan streams: host-side encode, on-device decode (format v1).

PyTorch counterpart of ``distributed_matvec_tpu/ops/plan_codec.py``.  The
host side (bitpacking, :class:`PlanCodec`) is copied from it, for the
``lossless`` tier only: the ``off``, ``f32`` and ``bf16`` tiers and the
hybrid term mask are not in the port yet.  The device side is torch:
:func:`unpack_bits`, :func:`decode_plan_shard` and the fused
decode + gather + multiply + scatter of one chunk,
:func:`fused_decode_gather_scatter`, a hand-written CUDA kernel
(``csrc/fused_decode.cu``) with its plain version beside it.

Per (row chunk, shard) the streamed plan holds four arrays, encoded as:

``dest``  TWO concatenated little-endian u32 word streams — the live
    entries' trimmed exchange slots at ``w_dest = bits(D·cap_eff)`` bits each
    (the ``D·cap_eff`` sentinel marks padding), then their row indices at
    ``w_row = bits(B−1)`` bits.
``ridx``  [D·cap_eff] receive-side basis index, bitpacked at ``bits(M−1)``.
``rok``   [D·cap_eff] receive-side flag, bitpacked 1 bit/flag.
``coeff`` live entries only, **dictionary-coded** (u8/u16 codes plus one
    small per-shard f64 table that stays on the device) when the distinct
    coefficient values fit ``DICT_MAX``; otherwise raw f64.

Dead entries (coefficient 0) are dropped on the host and the exchange slots
are re-based to the true maximum bucket fill, so the decoded arithmetic is
value-identical and order-identical to the raw plan's.  Beside the encoded
streams the port keeps each chunk's per-bucket fill counts
(:func:`send_fill`): the send buffer's occupancy, which the decode kernel
needs to zero the empty slots and which ``rok`` (the receive side) gives
only at D = 1.

On the device, u32 word streams travel as int32 tensors with the same bits
and u16 codes as int16 tensors; both are widened and masked before use.
"""

from __future__ import annotations

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
    "send_fill",
    "fused_decode_gather_scatter",
]

PLAN_CODEC_VERSION = 1

#: Per-shard dictionary ceiling: u16 codes.  Beyond it the coefficient
#: stream falls back to raw f64.
DICT_MAX = 1 << 16

TIERS = ("lossless",)


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
# the codec (host)
# Copied from distributed_matvec_tpu/ops/plan_codec.py, lossless tier only.


def _canonical(cf: np.ndarray) -> np.ndarray:
    """Flat f64 view of a real coeff array (the dictionary's key space and
    the liveness test)."""
    return np.asarray(cf).astype(np.float64, copy=False).reshape(-1)


class PlanCodec:
    """One engine's plan codec: a static ``spec`` plus the per-shard
    coefficient dictionaries."""

    def __init__(self, spec: Dict, dicts: Optional[Dict[int, np.ndarray]]
                 = None):
        if spec.get("version") != PLAN_CODEC_VERSION:
            raise ValueError(
                f"plan codec version {spec.get('version')} != "
                f"{PLAN_CODEC_VERSION}")
        if spec["tier"] not in TIERS:
            raise NotImplementedError(
                f"compress tier {spec['tier']!r}: the port has "
                f"{'|'.join(TIERS)} only")
        if spec["ckind"] != "real":
            raise NotImplementedError(
                f"coefficient kind {spec['ckind']!r}: the port's codec is "
                "real-sector only")
        self.spec = spec
        self.dicts: Dict[int, np.ndarray] = dicts or {}

    # -- construction ----------------------------------------------------

    @classmethod
    def build(cls, tier: str, chunks, n_dest: int, cap_build: int,
              n_devices: int, shard_size: int, cshape, ckind: str,
              dict_max: int = DICT_MAX,
              agree: Optional[Callable] = None) -> "PlanCodec":
        """Codec for a freshly built plan.  ``chunks`` is the engine's
        ``[{shard: pc}]`` raw-chunk list; the scan measures the live-entry
        census (compaction bound), the true maximum bucket fill (capacity
        trim), and the distinct-coefficient census (dictionary decision).
        ``agree`` (one shard per rank) maps the local decisions
        ``(use_dict, nd, fill, n_live)`` to job-wide ones — the encoded
        shapes enter every rank's apply, so every rank must encode
        alike."""
        D = int(n_devices)
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
        uniq: Dict[int, np.ndarray] = {}
        n_live = 0
        fill = 0
        for per in chunks:
            for d, pc in per.items():
                flat = _canonical(pc["coeff"])
                # live = contributes to the apply: nonzero coefficient AND
                # a real exchange slot (the D·Cap sentinel marks entries
                # the raw scatter drops)
                dest_all = np.asarray(pc["dest"], np.int64).reshape(-1)
                live = (flat != 0) & (dest_all < D * cap_build)
                dest = dest_all[live]
                if dest.size:
                    # in-bucket rank: live positions are consecutive per
                    # bucket, so max(pos)+1 is the fill
                    fill = max(fill, int((dest % cap_build).max()) + 1)
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

    def dict_device_row(self, d: int) -> np.ndarray:
        """Shard ``d``'s decode table, padded to the agreed ``ndict``:
        [nd] f64; empty when the codec carries no dict."""
        nd = self.spec["ndict"]
        if not nd or self.spec["coeff"] != "dict":
            return np.zeros(0, np.float64)
        vals = self.dicts[d]
        out = np.zeros(nd, np.float64)
        out[: vals.size] = vals
        return out

    # -- compaction (host) ------------------------------------------------

    def compact_raw(self, pc: Dict) -> Dict:
        """One raw (chunk, shard) record → its compacted host-side form:
        live entries only, trimmed exchange slots, explicit row indices.
        Keys: ``dest``/``row``/``coeff`` ([n_live], pads: drop-sentinel / 0
        / 0) and ``ridx``/``rok`` ([D·cap_eff], the per-bucket prefix of the
        raw receive layout)."""
        s = self.spec
        D, cap_b, cap_e = s["D"], s["cap_build"], s["cap_eff"]
        nl = s["n_live"]
        flat = _canonical(pc["coeff"])
        dest_all = np.asarray(pc["dest"], np.int64).reshape(-1)
        live = (flat != 0) & (dest_all < D * cap_b)   # build's definition
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
        The row-index stream is folded into the ``dest`` array (two
        concatenated word streams)."""
        s = self.spec
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
            out["coeff"] = cp["coeff"].astype(np.float64)
        return out

    # -- size accounting --------------------------------------------------

    def raw_chunk_bytes(self) -> int:
        """Uncompressed bytes of ONE (chunk, shard) record — dest i32 +
        f64 coeff + untrimmed ridx i32 + rok byte-bool."""
        s = self.spec
        ncf = int(np.prod(s["cshape"][:2]))
        n_recv_raw = s["D"] * s["cap_build"]
        return s["n_dest"] * 4 + ncf * 8 + n_recv_raw * (4 + 1)

    @staticmethod
    def encoded_bytes(enc: Dict) -> int:
        return sum(int(np.asarray(a).nbytes) for a in enc.values())


# ---------------------------------------------------------------------------
# device decode


def _code_index(codes: torch.Tensor) -> torch.Tensor:
    """u8 codes (uint8) or u16 codes (int16 bits) → int64 indices."""
    idx = codes.to(torch.int64)
    return idx & 0xFFFF if codes.dtype == torch.int16 else idx


def decode_plan_shard(spec: Dict, dest, coeff, ridx, rok, cdict):
    """Shard-local device decode of one encoded chunk → the compact form
    ``(dest int64 [n_live], row int64 [n_live], coeff f64 [n_live],
    ridx int64 [D·cap_eff], rok bool [D·cap_eff])``."""
    n_recv = spec["n_recv"]
    nl = spec["n_live"]
    nwd = packed_words(nl, spec["w_dest"])
    dest_i = unpack_bits(dest[:nwd], nl, spec["w_dest"])
    row_i = unpack_bits(dest[nwd:], nl, spec["w_row"])
    ridx_i = unpack_bits(ridx, n_recv, spec["w_ridx"])
    rok_b = unpack_bits(rok, n_recv, 1).to(torch.bool)
    return dest_i, row_i, _decode_coeff_vals(spec, coeff, cdict), ridx_i, \
        rok_b


def _decode_coeff_vals(spec: Dict, coeff, cdict):
    """Compacted coefficient stream → [n_live] f64 values."""
    if spec["coeff"] == "dict":
        return cdict[_code_index(coeff)]
    return coeff.to(torch.float64)


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
