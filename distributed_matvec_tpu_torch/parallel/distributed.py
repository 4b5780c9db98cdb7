"""Streamed matvec engine: y = H·x from a precomputed, compressed plan.

PyTorch counterpart of ``distributed_matvec_tpu/parallel/distributed.py``
``DistributedEngine`` in ``mode="streamed"`` on one device.  The build
resolves every row chunk's structure once — kernels and orbit scan, bucket
routing, the receive-side basis lookup — into a host-RAM plan, encodes it
with the ``lossless`` codec (``ops/plan_codec.py``), and keeps it in pinned
host memory.  Every apply then streams the encoded chunks host → device,
double-buffered on a side stream, and per chunk

    send = fused_decode_gather_scatter(chunk, x[chunk rows])   (CUDA kernel)
    y[ridx] += rok ? send : 0                                  (index_add_)

followed by the diagonal epilogue ``y += diag·x``.  The orbit scan never
runs again after the build.  At one device the exchange is the identity, so
the send buffer is the receive buffer.

Vectors live in the *hashed* layout ``[D, M]`` (here ``[1, M]``, pad slots
zero); :class:`~.shuffle.HashedLayout` converts to and from the sorted
(*block*) order.  A block of R columns is ``[1, M, R]``: the eager solvers
(``lanczos_block``, LOBPCG, KPM, Krylov evolution) apply H to R vectors at
once.  Each plan chunk is still streamed host → device once per apply; the
decode kernel is launched once per column on that column's chunk rows, and
the receive side adds the ``[n_recv, R]`` block with one ``index_add_``.
(The JAX engine decodes a multi-column chunk through XLA ops, not its
Pallas kernel, which covers the single-column stream only.)

Scope: one device, a real sector, the ``lossless`` tier with
dictionary-coded coefficients — the scope of the CUDA kernel.  Anything
else raises ``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..models.operator import Operator
from ..ops import kernels as K
from ..ops import plan_codec as PC
from ..ops.bits import build_sorted_lookup, choose_dir_bits, shard_index
from ..ops.bits import state_index_bucketed
from ..utils import u64
from ..utils.device import resolve_device
from .shuffle import HashedLayout

__all__ = ["DistributedEngine", "SENTINEL_STATE"]

#: Padding state of the hashed layout: the all-ones u64, as int64 bits.
SENTINEL_STATE = -1
_SENTINEL_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)

#: Row chunk B of the plan build and the apply (the JAX config's
#: ``matvec_batch_size`` default).
DEFAULT_BATCH_SIZE = 1 << 16

#: The host plan's per-chunk stride is a multiple of this many bytes.
_ALIGN = 16


def _round_up(n: int, b: int) -> int:
    return max(((n + b - 1) // b) * b, b)


def _bucket_positions(key: torch.Tensor, D: int) -> torch.Tensor:
    """Rank of each entry within its ``key`` bucket (keys in [0, D]; D marks
    dead entries): the one-hot cumsum form the JAX engine uses for D ≤ 16,
    bit-identical to a stable sort's positions."""
    onehot = key[:, None] == torch.arange(D, device=key.device)[None, :]
    pos_all = torch.cumsum(onehot.to(torch.int64), dim=0) - 1
    return torch.take_along_dim(
        pos_all, torch.clamp(key, 0, D - 1)[:, None], dim=1)[:, 0]


class DistributedEngine:
    """Streamed matvec over the hashed layout of a built basis.

    Usage::

        eng = DistributedEngine(op)           # on the card
        xh = eng.to_hashed(x)                 # block [N] → hashed [1, M]
        yh = eng.matvec(xh)
        y = eng.from_hashed(yh)

    ``batch_size`` is the plan's row chunk B (default 65536);
    ``stream_compress`` the codec tier.  ``device`` defaults to ``cuda``
    and raises when there is none.
    """

    def __init__(self, operator: Operator, n_devices: int = 1,
                 batch_size: Optional[int] = None, mode: str = "streamed",
                 stream_compress: str = "lossless", device=None):
        self.device = resolve_device(device)
        if mode != "streamed":
            raise NotImplementedError(
                f"engine mode {mode!r}: the port has mode='streamed' only")
        if n_devices != 1:
            raise NotImplementedError(
                f"n_devices={n_devices}: the port runs on one device")
        if stream_compress not in PC.TIERS:
            raise NotImplementedError(
                f"stream_compress={stream_compress!r}: the port has "
                f"{'|'.join(PC.TIERS)} only")
        if not operator.is_hermitian:
            raise ValueError("the engine requires a Hermitian operator")
        if not operator.effective_is_real:
            raise NotImplementedError(
                "complex sectors are not in the port yet")
        self.operator = operator
        self.mode = mode
        self.n_devices = 1
        self.stream_compress = stream_compress
        #: seconds of each construction phase
        self.timings: Dict[str, float] = {}
        #: matvec calls so far (each launches one decode kernel per chunk
        #: and column)
        self.n_applies = 0

        basis = operator.basis
        if not basis.is_built:
            basis.build()
        reps, norms = basis.representatives, basis.norms
        self.layout = HashedLayout(reps, 1)
        self.n_states = int(reps.size)
        self.shard_size = M = self.layout.shard_size
        self.counts = self.layout.counts
        count = int(self.counts[0])
        alphas_np = self.layout.to_hashed(reps, fill=_SENTINEL_U64)[0]
        norms_np = self.layout.to_hashed(norms, fill=1.0)[0]

        dev = self.device
        self.tables = K.device_tables(operator, dev)
        self.num_terms = int(self.tables.off.x.shape[0])
        self._alphas = u64.from_numpy(alphas_np, dev)
        self._norms = torch.from_numpy(norms_np).to(dev)
        dd = K.apply_diag(self.tables.diag, self._alphas)
        self._diag = torch.where(self._alphas != SENTINEL_STATE, dd,
                                 torch.zeros_like(dd))

        b = min(batch_size or DEFAULT_BATCH_SIZE, M)
        self.batch_size = _round_up(min(b, M), 8)

        # bucketed lookup over the shard's real prefix; pad rows repeat the
        # last real row so a probe clamping past the prefix cannot match a
        # SENTINEL query
        n_bits = basis.number_bits
        lk = build_sorted_lookup(alphas_np[:count], n_bits,
                                 dir_bits=choose_dir_bits(count, n_bits))
        pr = np.full((M, 2), 0xFFFFFFFF, np.uint32)
        pr[:count] = lk[0]
        if 0 < count < M:
            pr[count:] = lk[0][-1]
        self._lk_pair = torch.from_numpy(pr.astype(np.int64)).to(dev)
        self._lk_dir = torch.from_numpy(lk[1]).to(dev)
        self._lk_shift, self._lk_probes = lk[2], lk[3]
        # one device: the whole chunk's entries fit one bucket
        self._capacity = _round_up(self.batch_size * self.num_terms, 8)

        t0 = time.perf_counter()
        raw = self._build_stream_plan()
        self.timings["plan_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._encode_stream_plan(raw)
        self.timings["plan_encode_s"] = time.perf_counter() - t0
        self._cdict = torch.from_numpy(
            self._codec.dict_device_row(0)).to(dev)
        if dev.type == "cuda":
            self._copy_stream = torch.cuda.Stream(dev)
            self._dev_bufs = torch.empty(
                (2, self._chunk_stride), dtype=torch.uint8, device=dev)
            self._ready = [torch.cuda.Event(), torch.cuda.Event()]
            self._free = [torch.cuda.Event(), torch.cuda.Event()]

    # -- plan build ----------------------------------------------------------

    @property
    def nchunks(self) -> int:
        B = self.batch_size
        return (self.shard_size + B - 1) // B

    def _chunk_rows(self, ci: int):
        """Row chunk ``ci`` padded to B (SENTINEL rows, unit norms)."""
        B, M = self.batch_size, self.shard_size
        s, e = ci * B, min((ci + 1) * B, M)
        a, nn = self._alphas[s:e], self._norms[s:e]
        if e - s < B:
            pad = B - (e - s)
            a = torch.cat([a, torch.full((pad,), SENTINEL_STATE,
                                         dtype=a.dtype, device=a.device)])
            nn = torch.cat([nn, torch.ones(pad, dtype=nn.dtype,
                                           device=nn.device)])
        return a, nn

    def _build_chunk(self, a: torch.Tensor, nn: torch.Tensor):
        """One row chunk's raw plan: kernels + orbit scan, bucket routing,
        and the receive-side lookup.  Returns the host arrays ``dest``
        [B·T] i32, ``coeff`` [B, T] f64, ``ridx`` [Cap] i32, ``rok`` [Cap]
        bool, and the chunk's overflow and invalid counts."""
        D, Cap = self.n_devices, self._capacity
        betas, gcoeff = K.gather_coefficients(self.tables, a, nn)
        valid_row = (a != SENTINEL_STATE)[:, None]
        nz = (gcoeff != 0) & valid_row
        cf = torch.where(nz, gcoeff, torch.zeros_like(gcoeff))
        flat_b = betas.reshape(-1)
        live = nz.reshape(-1)
        owner = shard_index(flat_b, D).to(torch.int64)
        key = torch.where(live, owner, D)
        pos = _bucket_positions(key, D)
        in_cap = (pos < Cap) & (key < D)
        overflow = int(((pos >= Cap) & (key < D)).sum())
        dest = torch.where(in_cap, key * Cap + pos, D * Cap)
        # the trailing slot takes the dropped (dead) entries
        send_b = torch.full((D * Cap + 1,), SENTINEL_STATE,
                            dtype=torch.int64, device=a.device)
        send_b[dest] = flat_b
        recv_b = send_b[:D * Cap]          # one device: no exchange
        idx, found = state_index_bucketed(
            self._lk_pair, self._lk_dir, recv_b, shift=self._lk_shift,
            probes=self._lk_probes)
        live_r = recv_b != SENTINEL_STATE
        okc = found & live_r
        invalid = int((live_r & ~found).sum())
        ridx = torch.where(okc, idx, 0)
        return ({"dest": dest.to(torch.int32).cpu().numpy(),
                 "coeff": cf.cpu().numpy(),
                 "ridx": ridx.to(torch.int32).cpu().numpy(),
                 "rok": okc.cpu().numpy()}, overflow, invalid)

    def _build_stream_plan(self):
        """Resolve every row chunk's structure once into host arrays,
        ``[{shard: raw chunk}]`` as the JAX engine keeps them."""
        chunks = []
        overflow = invalid = 0
        for ci in range(self.nchunks):
            pc, ov, iv = self._build_chunk(*self._chunk_rows(ci))
            chunks.append({0: pc})
            overflow += ov
            invalid += iv
        if overflow:
            raise RuntimeError(
                f"{overflow} amplitudes overflowed the exchange capacity "
                f"{self._capacity}")
        if invalid:
            raise RuntimeError(
                f"{invalid} generated amplitudes map outside the basis — "
                "operator does not preserve the chosen sector")
        return chunks

    def _encode_stream_plan(self, raw) -> None:
        """Encode the raw chunks with the codec and pack them into one host
        buffer (pinned on CUDA) of ``nchunks`` equal-stride records:
        dest+row words | ridx words | rok words | codes."""
        B, T = self.batch_size, self.num_terms
        self._codec = codec = PC.PlanCodec.build(
            self.stream_compress, raw, n_dest=B * T,
            cap_build=self._capacity, n_devices=1,
            shard_size=self.shard_size, cshape=(B, T), ckind="real")
        spec = codec.spec
        if spec["coeff"] != "dict":
            raise NotImplementedError(
                f"{spec['ndict']} distinct coefficients exceed the "
                "dictionary: raw coefficient streams are not in the port "
                "yet")
        nl, n_recv = spec["n_live"], spec["n_recv"]
        words = {"dest": PC.packed_words(nl, spec["w_dest"])
                 + PC.packed_words(nl, spec["w_row"]),
                 "ridx": PC.packed_words(n_recv, spec["w_ridx"]),
                 "rok": PC.packed_words(n_recv, 1)}
        code_bytes = nl * spec["code_bits"] // 8
        layout, off = {}, 0
        for k in ("dest", "ridx", "rok"):
            layout[k] = (off, words[k] * 4)
            off += words[k] * 4
        layout["coeff"] = (off, code_bytes)
        self._chunk_stride = _round_up(off + code_bytes, _ALIGN)
        self._chunk_layout = layout
        n = self.nchunks
        self._plan_host = torch.zeros(
            (n, self._chunk_stride), dtype=torch.uint8,
            pin_memory=self.device.type == "cuda")
        host = self._plan_host.numpy()
        enc_bytes = 0
        for ci in range(n):
            enc = codec.encode_chunk(raw[ci][0], 0)
            raw[ci] = None                       # free the raw chunk
            for k, (o, nb) in layout.items():
                a = np.ascontiguousarray(enc[k]).view(np.uint8)
                if a.size != nb:
                    raise ValueError(f"encoded {k} has {a.size} bytes, the "
                                     f"chunk layout {nb}")
                host[ci, o:o + nb] = a
            enc_bytes += PC.PlanCodec.encoded_bytes(enc)
        self.plan_bytes = enc_bytes
        self.plan_bytes_raw = codec.raw_chunk_bytes() * n

    # -- plan access -----------------------------------------------------------

    def _chunk_views(self, buf: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(dest+row words, codes, ridx words, rok words) of one chunk
        record, as int32 / uint8-or-int16 views of its bytes."""
        def view(k, dtype):
            o, nb = self._chunk_layout[k]
            return buf[o:o + nb].view(dtype)

        code_dtype = torch.uint8 if self._codec.spec["code_bits"] == 8 \
            else torch.int16
        return (view("dest", torch.int32), view("coeff", code_dtype),
                view("ridx", torch.int32), view("rok", torch.int32))

    def plan_chunk(self, ci: int) -> Dict[str, np.ndarray]:
        """Encoded chunk ``ci`` as NumPy arrays in the JAX engine's form:
        ``dest``/``ridx``/``rok`` u32 word streams, ``coeff`` u8/u16
        codes."""
        dest, codes, ridx, rok = self._chunk_views(self._plan_host[ci])
        code_np = np.uint8 if codes.dtype == torch.uint8 else np.uint16
        return {"dest": dest.numpy().view(np.uint32),
                "coeff": codes.numpy().view(code_np),
                "ridx": ridx.numpy().view(np.uint32),
                "rok": rok.numpy().view(np.uint32)}

    def _stream_chunks(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        """The plan's chunks as device views, in order.  On CUDA each chunk
        is copied host → device on a side stream into one of two buffers,
        one chunk ahead of its use; the compute stream waits for the copy,
        and the copy into a buffer waits for the compute that last read
        it."""
        n = self.nchunks
        if self.device.type != "cuda":
            for ci in range(n):
                yield self._chunk_views(self._plan_host[ci])
            return
        compute = torch.cuda.current_stream(self.device)
        copy = self._copy_stream

        def issue(ci):
            slot = ci % 2
            with torch.cuda.stream(copy):
                copy.wait_event(self._free[slot])
                self._dev_bufs[slot].copy_(self._plan_host[ci],
                                           non_blocking=True)
                self._ready[slot].record(copy)

        if n:
            copy.wait_stream(compute)
            issue(0)
        for ci in range(n):
            if ci + 1 < n:
                issue(ci + 1)
            slot = ci % 2
            compute.wait_event(self._ready[slot])
            yield self._chunk_views(self._dev_bufs[slot])
            self._free[slot].record(compute)

    # -- apply -----------------------------------------------------------------

    def matvec(self, xh: torch.Tensor) -> torch.Tensor:
        """y = H·x in the hashed layout: ``[1, M]`` or a block of R columns
        ``[1, M, R]``, float64 on the engine's device."""
        M = self.shard_size
        if (xh.shape[:2] != (1, M) or xh.dim() not in (2, 3)
                or xh.dtype != torch.float64 or xh.device != self.device):
            raise ValueError(
                f"matvec takes a float64 [1, {M}] or [1, {M}, R] tensor on "
                f"{self.device}, got {xh.dtype} {tuple(xh.shape)} on "
                f"{xh.device}")
        y = self._apply(xh, self._stream_chunks())
        self.n_applies += 1
        return y

    def _apply(self, xh: torch.Tensor, chunks) -> torch.Tensor:
        """The apply over ``chunks``, an iterable of the plan's chunk views
        on the device in chunk order (:meth:`_stream_chunks` streams them
        from host memory).  Columns are applied side by side: per chunk one
        decode launch per column, then one ``index_add_`` of the block."""
        M, B = self.shard_size, self.batch_size
        spec = self._codec.spec
        n_recv, w_ridx = spec["n_recv"], spec["w_ridx"]
        x = xh[0].reshape(M, -1)                       # [M, R]
        R = x.shape[1]
        # column-major copy: each column's chunk rows are contiguous, as
        # the kernel takes them
        xp = torch.zeros((R, self.nchunks * B), dtype=torch.float64,
                         device=self.device)
        xp[:, :M] = x.T
        y = torch.zeros((M, R), dtype=torch.float64, device=self.device)
        for ci, (edest, codes, ridx_w, rok_w) in enumerate(chunks):
            sends = [PC.fused_decode_gather_scatter(
                spec, edest, codes, rok_w, self._cdict,
                xp[r, ci * B:(ci + 1) * B]) for r in range(R)]
            send = sends[0][:, None] if R == 1 else torch.stack(sends, 1)
            ridx = PC.unpack_bits(ridx_w, n_recv, w_ridx)
            rok = PC.unpack_bits(rok_w, n_recv, 1).to(torch.bool)
            y.index_add_(0, ridx, torch.where(rok[:, None], send[:n_recv],
                                              0.0))
        return (y + self._diag[:, None] * x).reshape(xh.shape)

    # -- layouts ---------------------------------------------------------------

    def to_hashed(self, x) -> torch.Tensor:
        """Block (global sorted) [N] or [N, R] → hashed [1, M] or
        [1, M, R] f64 on the device."""
        xh = self.layout.to_hashed(np.asarray(x, dtype=np.float64), fill=0)
        return torch.from_numpy(xh).to(self.device)

    def from_hashed(self, xh: torch.Tensor) -> np.ndarray:
        """Hashed [1, M] or [1, M, R] → block [N] or [N, R] NumPy."""
        return self.layout.from_hashed(xh.detach().cpu().numpy())

    def matvec_global(self, x) -> np.ndarray:
        """Block-layout in/out convenience: shuffle → matvec → unshuffle."""
        return self.from_hashed(self.matvec(self.to_hashed(x)))

    def random_hashed(self, seed: int = 0,
                      cols: Optional[int] = None) -> torch.Tensor:
        """A normalized random vector in hashed layout (pads zero) — or,
        with ``cols``, a ``[1, M, cols]`` block of per-column-normalized
        vectors — seeded per shard as the JAX engine seeds it
        (``SeedSequence((seed, d))``, draws of shape ``(count, cols)``)."""
        tail = (cols,) if cols else ()
        c = int(self.counts[0])
        rng = np.random.default_rng(np.random.SeedSequence((seed, 0)))
        x = np.zeros((1, self.shard_size) + tail)
        x[0, :c] = rng.standard_normal((c,) + tail)
        xh = torch.from_numpy(x).to(self.device)
        if cols is None:
            return xh / torch.linalg.vector_norm(xh)
        return xh / torch.linalg.vector_norm(xh, dim=(0, 1), keepdim=True)

    def dot(self, ah: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
        """⟨a, b⟩ over hashed vectors or blocks (``a`` conjugated; pad
        slots are zero by invariant), as a 0-d tensor."""
        return torch.vdot(ah.reshape(-1), bh.reshape(-1))
