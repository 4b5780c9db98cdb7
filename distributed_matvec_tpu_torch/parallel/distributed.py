"""Hash-sharded matvec engine: y = H·x over D shards of the basis.

PyTorch counterpart of ``distributed_matvec_tpu/parallel/distributed.py``'s
``DistributedEngine`` in its four non-hybrid modes.  State σ lives on shard
``hash64(σ) % D``; vectors live in the *hashed* layout ``[D, M]`` (pad slots
zero), or ``[D, M, R]`` for a block of R columns, and
:class:`~.shuffle.HashedLayout` converts to and from the sorted (*block*)
order.

Two placements of the D shards:

* **One process** (no ``group``): all D shards on the engine's ``device``,
  the counterpart of the JAX engine on a single-process mesh (how its tests
  run D = 2 … 8 on virtual CPU devices).  Per-shard work runs shard by
  shard, and the exchange is a transpose.
* **One shard per rank** (``group=``, a :class:`~.mesh.ShardGroup` from
  :func:`~.mesh.init_distributed`): D is the group's world size and rank r
  holds shard r — its rows, tables, plan and vector row, as ``[1, M]`` /
  ``[1, M, R]`` so the per-shard code keeps its shape.  The basis is built
  on every rank, as the JAX engine does.  The shards meet only in
  collectives: the exchange is ``all_to_all_single``, and every build-wide
  value (histograms, capacities, codec decisions, overflow and
  out-of-basis counts) is agreed by an all-reduce or all-gather before
  anything raises, so the ranks raise together.

Either way the shards meet in :func:`all_to_all`, the one exchange
function: send buffers ``[D_src, D_dst, C, …]`` in, receive buffers
``[D_dst, D_src, C, …]`` out, JAX's ``all_to_all(sb, axis, 0, 0,
tiled=True)``; on a rank the leading axis is this rank's one shard.

The chunked modes (streamed, fused) take ``pipeline_depth`` (JAX's knob,
resolved as it resolves it): 0, the default, is the sequential schedule —
each chunk's exchange is waited for before the next chunk is produced; an
integer ≥ 2 keeps up to that many chunks' exchanges in flight.  Each
chunk's exchange starts as soon as its send side is queued (on ranks the
staged exchange, :meth:`~.mesh.ShardGroup.exchange_async`; in one process
the transpose), and it retires — wait, then the receive side's lookups and
``index_add_`` into y — strictly in chunk order once ``depth`` − 1 later
chunks have been produced, so a pipelined apply is bit-identical to the
sequential one at every depth.  The depth is clamped to the chunk count (a
clamp below 2 is 0), fused reports at most 2 (JAX's in-program pipeline
is one exchange deep), ell and compact always 0; ``eng.pipeline_depth =
v`` re-resolves it on a built engine.  ``last_pipeline`` records the last
pipelined apply (``depth``, ``chunks``, and ``barrier_ms``, the host time
spent waiting in its retires); a sequential apply sets it to None.

Modes (``mode=``):

* ``"streamed"``: a build pass resolves every row chunk's
  structure once — kernels and orbit scan, bucket routing, one exchange of
  the target states, the receive-side basis lookup — into a host-RAM plan
  (the scatter form: conj(row coefficient), as the JAX build stores it),
  encoded with the ``stream_compress`` tier's codec (``ops/plan_codec.py``:
  ``off``, ``lossless``, ``f32``, ``bf16``; dictionary-coded or raw
  coefficients; real or complex128) and kept in pinned host memory.  Every
  apply streams the encoded chunks host → device on a side stream through
  a ring of ``max(2, depth)`` buffers, and per chunk

      send[s] = decode + gather x[s] rows + multiply + scatter
      recv = all_to_all(send)
      y[d][ridx] += rok ? recv[d] : 0                             (index_add_)

  followed by the diagonal epilogue ``y += diag·x``.  The send side runs
  one of two decode paths, fixed at build time by the plan's shape and
  reported in ``stream_kernel``: ``"cuda"`` — real sector, dictionary
  codes, not the ``off`` tier, not hybrid (where JAX would let its Pallas
  kernel run) — launches the decode kernel ``fused_decode_gather_scatter``
  once per shard per chunk per column, which zeroes the send slots no entry
  writes from the chunk's per-bucket fill counts (the send side's
  occupancy, stored beside the encoded streams); ``"torch"`` — every
  other case, the
  counterpart of JAX's XLA decode — unpacks with
  :func:`~..ops.plan_codec.decode_plan_shard`, gathers ``x[row]`` (or, in
  the ``off`` tier, the implicit row ``i // T``), multiplies and scatters
  all R columns at once into a zeroed send buffer.  Complex products run
  on real components, so every element rounds alike whatever the block's
  shape, and complex receive blocks are added through ``view_as_real``.  A
  block of R > 4 columns is applied in column groups of 4, each streaming
  the plan once (JAX ``run``): per-chunk scratch grows with R, and
  streamed mode is for sectors that crowd device memory.
* ``"hybrid"``: the streamed plan for the terms a ``hybrid_split`` streams
  (``"all-stream"``, ``"all-recompute"``, ``"stream:<t,t,…>"``; the
  ``off`` tier maps to ``lossless``); the other terms are recomputed per
  chunk on the device (kernels, orbit scan, routing), and each bucket's
  j-th recompute entry takes the bucket's j-th slot the streamed entries
  left free, so the send buffer — and the apply — equal the streamed
  engine's bit for bit.  Decodes through the ``"torch"`` path.
* ``"ell"``: the static routing plan.  The build deduplicates each shard's
  remote targets per peer into query lists ``qin``; every apply is
  ``x[qin]`` → exchange → ``[x; R]`` → a per-term ELL gather·multiply·add
  (plus a tail over the rows wider than T0).  Real and complex128 sectors.
* ``"compact"``: the ELL routing plan with 4-byte sign-tagged indices for
  real sectors with one off-diagonal magnitude W; the coefficient is
  ``W·s·n(j)/n(i)``, the remote norms exchanged once at build time.
* ``"fused"``: no table; every apply re-runs the kernels per row chunk,
  routes the amplitudes and their target states through fixed-capacity
  buckets, exchanges both, and looks the targets up on the receive side.
  Overflow and out-of-basis targets are counted and checked on the first
  apply of each row-chunk size.  Real and complex128 sectors.

Unset constructor arguments come from the runtime config
(``utils/config.py``, the ``DMT_*`` knobs) where the JAX engine reads
them: ``mode`` ← ``matvec_mode`` (default ``"ell"``), ``stream_compress``
← ``stream_compress`` (default ``"off"``), ``batch_size`` ←
``matvec_batch_size``, ``pipeline_depth`` ← ``pipeline``,
``hybrid_split`` ← ``hybrid``, and the bucket sizing ←
``all_to_all_capacity_factor`` and ``remote_buffer_size``.  The config's
``stream_kernel`` is validated: ``auto`` and ``pallas`` both mean the
decode kernel wherever it is eligible, and ``xla`` — the JAX package's
switch to its plain decode — raises, since the port never sends a chunk
the kernel can take through the plain path.

The cost model (``obs/roofline.py``, priced with the rate calibration of
``obs/calibrate.py``) drives two ``"auto"`` policies, as in the JAX
engine: ``pipeline_depth="auto"`` prices the overlap of the built plan's
phase counts (:func:`~..obs.roofline.choose_pipeline_depth`), and
``hybrid_split="auto"`` — the config's ``hybrid`` default — streams
exactly the terms whose plan slice prices cheaper than recomputing them
(:func:`~..obs.roofline.choose_hybrid_split` over the build's live-entry
census, summed over the ranks).  ``tune="static"|"live"`` (the config's
``tune``, ``DMT_TUNE``) picks the streamed and hybrid knobs — row chunk,
depth, value-exact tier, split — by the same model (``tune/``); explicit
constructor arguments and config values moved off their defaults win.
Under ``"live"`` every window of applies refines the rates from the
measured walls, and a re-tune lands at the top of the next apply
(:meth:`DistributedEngine.maybe_retune`).

Telemetry (``obs/``): with the obs layer on every apply emits
``matvec_apply`` and the ``exchange_bytes`` / ``matvec_apply_ms``
series, and with ``phases`` on an ``apply_phases`` event whose
structural counts equal the JAX engine's (``_phase_counts``); streamed
applies add a per-chunk timeline from CUDA events on the plan-copy stream,
read after the apply's one end-of-apply synchronization (which phases on
adds on the card; nothing is synchronized per chunk).  With obs off the
apply takes no timing at all.  Each apply runs in an ``apply`` span and
feeds the health layer (``obs/health.py``): the probes earlier applies
queued are drained, every ``health_every``-th apply queues its nonfinite
count and norm, the overflow/invalid counters of the chunked modes ride
the same queue, and on an ``f32``/``bf16`` streamed engine the probe
applies also queue a compress-drift sample (``_probe_compress_drift``) —
all without a synchronization.  A watermark is sampled every
``memory_every``-th apply, and ``DMT_PROFILE=sampled`` wraps every
``profile_every``-th apply in a ``torch.profiler`` window.  The
construction emits ``engine_init`` and registers its tensors, the host
plan and the H2D ring in the memory ledger; a device out-of-memory
failure in the build or an apply raises ``obs.memory.OomError``.

Fault sites (``utils/faults.py``, ``DMT_FAULT``): ``exchange`` at the
head of every apply, before any device work, and ``plan_upload`` on each
plan chunk's host fetch for the H2D ring, retried with backoff
(``io_retries``, ``io_retry_base_s``).

The threaded plan prefetch and the disk tier, ``from_shards`` and the
structure and plan caches are not in the port.
"""

from __future__ import annotations

import math
import os
import time
import warnings
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models.operator import Operator
from ..obs import health as obs_health
from ..obs import memory as obs_memory
from ..obs import phases as obs_phases
from ..obs import profile as obs_profile
from ..obs import trace as obs_trace
from ..obs.events import emit, obs_enabled
from ..obs.metrics import counter, gauge, histogram
from ..ops import kernels as K
from ..ops import plan_codec as PC
from ..ops.bits import build_sorted_lookup, choose_dir_bits, shard_index
from ..ops.bits import state_index_bucketed
from ..utils import faults, u64
from ..utils.config import get_config
from ..utils.device import resolve_device
from ..utils.timers import TreeTimer
from .engine_obs import (emit_engine_init, note_applying, oom_reraise,
                         register_engine_memory)
from .shuffle import HashedLayout

__all__ = ["DistributedEngine", "SENTINEL_STATE", "all_to_all"]

#: Padding state of the hashed layout: the all-ones u64, as int64 bits.
SENTINEL_STATE = -1
_SENTINEL_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)

MODES = ("streamed", "hybrid", "ell", "compact", "fused")

#: The host plan's per-record stride is a multiple of this many bytes.
_ALIGN = 16

_OUT_OF_BASIS = ("generated matrix elements map outside the basis — "
                 "operator does not preserve the chosen sector")


def _round_up(n: int, b: int) -> int:
    return max(((n + b - 1) // b) * b, b)


def _bucket_positions(key: torch.Tensor, D: int) -> torch.Tensor:
    """Rank of each entry within its ``key`` bucket (keys in [0, D]; D marks
    dead entries), bit-identical to the JAX engine's, dead entries
    included.  For D ≤ 16 the JAX engine takes a one-hot cumsum over
    ``[N, D]``; here each bucket is one 1-D cumsum over its mask (a
    ``[N, D]`` cumsum along N runs as D sequential scans on the card), and
    a dead entry takes bucket D−1's running rank, as the one-hot form's
    clamped gather gives it.  Beyond 16 buckets both take a stable sort."""
    if D <= 16:
        pos = torch.zeros_like(key)
        for k in range(D):
            m = key == k
            rank = torch.cumsum(m, 0) - 1
            pos = torch.where(m | (key == D) if k == D - 1 else m, rank,
                              pos)
        return pos
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    starts = torch.searchsorted(
        key_s, torch.arange(D + 1, dtype=key.dtype, device=key.device))
    pos_s = (torch.arange(key_s.shape[0], device=key.device)
             - starts[torch.clamp(key_s, 0, D)])
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=key.device)
    return pos_s[inv]


def _mul(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``c · x`` elementwise, broadcasting.  A complex product runs on the
    real components, one kernel per operation, so every element rounds the
    same whatever the operands' shapes (torch's vectorized complex product
    rounds a broadcast element otherwise than a lone one on the CPU)."""
    if not c.is_complex():
        return c * x
    cr, ci, xr, xi = c.real, c.imag, x.real, x.imag
    return torch.complex(cr * xr - ci * xi, cr * xi + ci * xr)


def _check_stream_kernel() -> None:
    """Validate the config's ``stream_kernel`` (``DMT_STREAM_KERNEL``).
    ``auto`` and ``pallas`` take the CUDA decode kernel wherever it is
    eligible (the JAX package's ``auto`` is its XLA decode: one
    deliberate difference, see ``utils/config.py``).  ``xla`` asks for
    the plain decode on chunks the kernel can take, which the port does
    not do: it raises."""
    sk = str(get_config().stream_kernel).strip().lower() or "auto"
    if sk == "xla":
        raise NotImplementedError(
            "stream_kernel='xla' (DMT_STREAM_KERNEL): the port decodes "
            "every chunk the CUDA decode kernel can take with that kernel "
            "and has no switch to its plain version; unset it or pick "
            "auto|pallas")
    if sk not in ("auto", "pallas"):
        raise ValueError(f"unknown stream_kernel {sk!r}; pick "
                         "auto|xla|pallas")


def _static_hybrid_mask(split, num_terms: int) -> Optional[np.ndarray]:
    """The [T] stream mask (True = the term's entries travel in the plan)
    of a static hybrid split: ``"all-stream"``, ``"all-recompute"`` or
    ``"stream:<t,t,…>"`` (JAX ``_init_hybrid_policy`` and
    ``_static_hybrid_mask``); None for ``"auto"`` (also taken for None),
    which the build resolves from its census."""
    T = int(num_terms)
    s = "" if split is None else str(split).strip().lower()
    s = s or "auto"
    if s == "auto":
        return None
    if s == "all-stream":
        return np.ones(T, bool)
    if s == "all-recompute":
        return np.zeros(T, bool)
    bad_split = ValueError(
        f"bad hybrid split {split!r}: set tune=static (DMT_TUNE=static) "
        "to let the autotuner pick the split, or pick auto | all-stream | "
        "all-recompute | stream:<term,term,...> (DMT_HYBRID / "
        "config.hybrid)")
    if not s.startswith("stream:"):
        raise bad_split
    try:
        idx = [int(t) for t in s[len("stream:"):].split(",") if t.strip()]
    except ValueError:
        raise bad_split from None
    bad = [t for t in idx if not 0 <= t < T]
    if bad:
        raise ValueError(f"hybrid stream terms {bad} outside [0, {T})")
    mask = np.zeros(T, bool)
    mask[idx] = True
    return mask


def all_to_all(send: torch.Tensor, group=None) -> torch.Tensor:
    """The exchange: shard d's receive block s is shard s's send block d.
    ``send`` is ``[D_src, D_dst, C, …]``; returns ``[D_dst, D_src, C, …]``,
    contiguous.  Without a ``group`` all shards live on one device and it
    is a transpose (no copy at D = 1).  With a :class:`~.mesh.ShardGroup`
    ``send`` is this rank's ``[1, W_dst, C, …]`` and the result its
    ``[1, W_src, C, …]``, through ``all_to_all_single`` — at every W, 1
    included."""
    if group is None:
        return send.transpose(0, 1).contiguous()
    return group.exchange(send[0])[None]


class DistributedEngine:
    """Hash-sharded matvec over a built basis, D shards on one device.

    Usage::

        eng = DistributedEngine(op, n_devices=4, mode="ell")   # on the card
        xh = eng.to_hashed(x)                 # block [N] → hashed [D, M]
        yh = eng.matvec(xh)
        y = eng.from_hashed(yh)

    ``mode`` is one of ``streamed``, ``hybrid``, ``ell``, ``compact`` and
    ``fused`` (default: the config's ``matvec_mode``, ``"ell"``).
    ``n_devices`` is the shard count D (default 1).  ``batch_size`` is the
    row chunk B of the plan builds and the chunked applies (default: the
    config's ``matvec_batch_size``, 65536, at most M); ``stream_compress``
    the streamed codec tier (``off``, ``lossless``, ``f32``, ``bf16``;
    default: the config's, ``"off"``), and ``hybrid_split`` the split of
    ``mode="hybrid"`` (default: the config's ``hybrid``, ``"auto"``: priced
    by the cost model).  The dictionary ceiling
    is ``ops.plan_codec.DICT_MAX``, read at build time.
    ``all_to_all_capacity_factor`` and ``remote_buffer_size`` size the
    chunked modes' exchange buckets (default: the config's, 1.25 and
    150 000).  ``device`` defaults to ``cuda`` and raises when there is
    none.  ``layout`` shares
    another engine's :class:`~.shuffle.HashedLayout` of the same basis at
    the same D (bound observables do).

    ``pipeline_depth`` (streamed and fused mode): the number of chunks
    whose exchanges may be in flight at once (see the module docstring);
    0, 1 and ``"off"`` are the sequential schedule, ``"auto"`` prices the
    overlap with the calibration, and None takes the config's ``pipeline``
    (default ``"off"``).  The config's ``tune`` (``static``/``live``)
    lets the autotuner fill the streamed and hybrid knobs left unset.

    ``group`` (a :class:`~.mesh.ShardGroup`) makes this a rank engine: D is
    the group's world size, this process holds shard ``group.rank``, and
    ``device`` defaults to the group's.  Every rank constructs the engine
    and makes every call on it together — ``matvec``, ``dot``,
    ``random_hashed`` and ``from_hashed`` are collective::

        g = init_distributed(backend="gloo", device="cpu")   # under torchrun
        eng = DistributedEngine(op, mode="ell", group=g, device="cpu")
        xh = eng.to_hashed(x)                 # block [N] → this rank's [1, M]
        y = eng.from_hashed(eng.matvec(xh))   # all-gathers the rows
    """

    def __init__(self, operator: Operator, n_devices: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 mode: Optional[str] = None,
                 stream_compress: Optional[str] = None, device=None,
                 all_to_all_capacity_factor: Optional[float] = None,
                 remote_buffer_size: Optional[int] = None,
                 layout: Optional[HashedLayout] = None, group=None,
                 pipeline_depth=None, hybrid_split=None):
        if group is not None:
            if n_devices is not None and int(n_devices) != group.world_size:
                raise ValueError(
                    f"n_devices={n_devices}: a rank engine has one shard "
                    f"per rank, {group.world_size} here")
            if device is not None and resolve_device(device) != group.device:
                raise ValueError(f"device {device}: this rank's group runs "
                                 f"on {group.device}")
            n_devices, device = group.world_size, group.device
        self.device = dev = resolve_device(device)
        cfg = get_config()
        mode = mode or cfg.matvec_mode
        compress_arg = stream_compress
        if stream_compress is None:
            stream_compress = str(cfg.stream_compress).strip().lower() \
                or "off"
        if mode not in MODES:
            raise ValueError(f"unknown engine mode {mode!r}")
        D = 1 if n_devices is None else int(n_devices)
        if D < 1:
            raise ValueError(f"n_devices={n_devices}: need at least 1")
        if not operator.is_hermitian:
            raise ValueError("the engine requires a Hermitian operator")
        self.real = operator.effective_is_real
        if mode in ("streamed", "hybrid"):
            _check_stream_kernel()
        if mode in ("streamed", "hybrid") \
                and stream_compress not in PC.TIERS:
            raise ValueError(
                f"unknown stream_compress tier {stream_compress!r}; pick "
                f"one of {'|'.join(PC.TIERS)}")
        if mode == "compact" and not self.real:
            raise ValueError(
                "compact mode requires a real sector (use mode='ell' "
                "for complex-character momentum sectors)")
        tune_knob = str(cfg.tune).strip().lower() or "off"
        if tune_knob not in ("off", "0", "false", "no", "static", "live"):
            raise ValueError(
                f"unknown tune setting {cfg.tune!r}: pick off | static | "
                "live (DMT_TUNE / config.tune)")
        #: the autotuner's mode for this engine ("off" outside streamed
        #: and hybrid, whose knobs are the ones it searches)
        self._tune_mode = tune_knob if (
            tune_knob in ("static", "live")
            and mode in ("streamed", "hybrid")) else "off"
        self.operator = operator
        self.mode = mode
        self.n_devices = D
        #: the rank group (None: every shard in this process), and the
        #: shards this process holds, in local-row order
        self.group = group
        self._shards = [group.rank] if group is not None else list(range(D))
        #: bytes this process has put into the exchange so far
        self.exchange_bytes = 0
        self.stream_compress = stream_compress
        #: the tier the plan encodes at: hybrid plans need a compacted
        #: encoding (a term subset cannot ride the raw [B, T] layout), so
        #: "off" maps to "lossless", as in the JAX engine
        self._codec_tier = "lossless" if (
            mode == "hybrid" and stream_compress == "off") \
            else stream_compress
        #: the streamed decode path ("cuda" or "torch"; None in the
        #: unstreamed modes), fixed when the plan is encoded
        self._stream_kernel: Optional[str] = None
        #: hybrid: the [T] stream mask and the recompute terms' tables
        self._hybrid_mask: Optional[np.ndarray] = None
        self._hyb_tables: Optional[K.OperatorTables] = None
        self.all_to_all_capacity_factor = float(
            cfg.all_to_all_capacity_factor
            if all_to_all_capacity_factor is None
            else all_to_all_capacity_factor)
        self.remote_buffer_size = int(
            cfg.remote_buffer_size if remote_buffer_size is None
            else remote_buffer_size)
        self._dtype = torch.float64 if self.real else torch.complex128
        #: seconds of each construction phase
        self.timings: Dict[str, float] = {}
        #: the construction's and the applies' timing tree
        self.timer = TreeTimer("DistributedEngine")
        t_init = time.perf_counter()
        # pre-build watermark: the delta against the post-init sample is
        # the construction's device footprint
        obs_memory.sample_watermark("engine_init_start/distributed")
        #: matvec calls so far
        self.n_applies = 0
        #: fused mode: row-chunk sizes whose overflow and out-of-basis
        #: counters were checked (the other modes check them at build)
        self._checked: set = set()

        basis = operator.basis
        if not basis.is_built:
            basis.build()
        reps, norms = basis.representatives, basis.norms
        if layout is not None:
            if layout.n_shards != D or layout.n_global != reps.size:
                raise ValueError(
                    f"shared layout is for {layout.n_global} states on "
                    f"{layout.n_shards} shards, engine needs "
                    f"{reps.size} on {D}")
            self.layout = layout
        else:
            self.layout = HashedLayout(reps, D)
        self.n_states = int(reps.size)
        self.shard_size = M = self.layout.shard_size
        self.counts = self.layout.counts
        alphas_np = self.layout.to_hashed(reps, fill=_SENTINEL_U64)
        norms_np = self.layout.to_hashed(norms, fill=1.0)

        L = len(self._shards)
        with self.timer.scope("transfer"):
            self.tables = K.device_tables(operator, dev)
            self._alphas = u64.from_numpy(alphas_np[self._shards],
                                          dev)                 # [L, M]
            self._norms = torch.from_numpy(norms_np[self._shards]).to(dev)
        self.num_terms = int(self.tables.off.x.shape[0])
        with self.timer.scope("diag"):
            self._diag = torch.empty((L, M), dtype=torch.float64,
                                     device=dev)
            for i in range(L):
                dd = K.apply_diag(self.tables.diag, self._alphas[i])
                self._diag[i] = torch.where(
                    self._alphas[i] != SENTINEL_STATE, dd,
                    torch.zeros_like(dd))

        b = min(batch_size or cfg.matvec_batch_size, M)
        self.batch_size = _round_up(min(b, M), 8)
        self._pipeline_req = pipeline_depth
        self._pipeline_depth = 0
        #: the last pipelined apply's record (None after a sequential one)
        self.last_pipeline: Optional[Dict[str, float]] = None
        # -- telemetry: the apply index, the streamed apply's per-chunk
        #    timeline (a list while an observed apply runs), the cached
        #    phase counts and the fused apply's (B, cap)
        self._apply_idx = 0
        self._timeline: Optional[list] = None
        self._tl_events: list = []
        self._phase_count_cache: Dict[tuple, dict] = {}
        self._last_fused: Optional[Tuple[int, int]] = None
        #: the last fused apply's (overflow, invalid) device counters, and
        #: the compress-drift probe's state (None: not looked at yet)
        self._last_counters = (0, 0)
        self._drift_state = None
        # -- self-tuning: the adopted TunedConfig, the live controller, a
        #    re-tune waiting for the next safe boundary, and the rates the
        #    tuner priced with
        self._tuned = None
        self._tuner = None
        self._retune_pending = None
        self._tune_cal: Optional[dict] = None
        self._hybrid_cal: Optional[dict] = None
        self._hybrid_split_arg = hybrid_split
        tuned_split = None
        if self._tune_mode != "off":
            tuned_split = self._init_autotune(batch_size, pipeline_depth,
                                              hybrid_split, compress_arg)
        if mode == "hybrid":
            # validated before any collective: every rank raises alike
            self._hybrid_split = str(
                hybrid_split if hybrid_split is not None
                else tuned_split if tuned_split is not None
                else cfg.hybrid).strip().lower() or "auto"
            self._hybrid_mask = _static_hybrid_mask(self._hybrid_split,
                                                    self.num_terms)
        req = cfg.pipeline if self._pipeline_req is None \
            else self._pipeline_req
        if str(req).strip().lower() != "auto":
            # an explicit depth is validated before the build
            self.pipeline_depth = self._pipeline_req

        self._plan_stage_h = obs_memory.NULL_HANDLE
        self._plan_mem_h = None
        try:
            self._build_plan(alphas_np)
        except Exception as e:
            if not obs_memory.is_resource_exhausted(e):
                # the staging is freed with the frame; only a genuine OOM
                # keeps its entry for the forensics report
                self._plan_stage_h.release()
            oom_reraise(e, engine="distributed", mode=mode, phase="init",
                        n_states=int(self.n_states))
        # "auto" prices the built plan's phase counts
        self.pipeline_depth = self._pipeline_req
        emit_engine_init(self, "distributed",
                         init_s=time.perf_counter() - t_init)
        register_engine_memory(self, "distributed")
        self._register_plan_memory()
        self.timer.report()    # the tree, printed with display_timings on

    def _build_plan(self, alphas_np: np.ndarray) -> None:
        """The mode's plan: the ell/compact routing plan, or the lookup and
        (streamed, hybrid) the encoded host plan."""
        mode, group, dev = self.mode, self.group, self.device
        t0 = time.perf_counter()
        if mode in ("ell", "compact"):
            if mode == "compact":
                self._c_W = self._compact_W(alphas_np)
                if group is not None:
                    ws = group.all_gather(torch.tensor(
                        self._c_W, dtype=torch.float64, device=dev))
                    if not bool((ws == ws[0]).all()):
                        raise RuntimeError(
                            f"the ranks found different compact "
                            f"magnitudes W: {ws.tolist()}")
            with self.timer.scope("build_plan"):
                Bc = min(self.shard_size, max(self.batch_size, 8))
                cfb = 8 if self.real else 16
                stage_h = self._track_staging(
                    "plan_stream",
                    2 * (Bc * 16 + Bc * self.num_terms * (8 + cfb)),
                    -(-self.shard_size // Bc))
                self._plan_stream(compact=mode == "compact")
                stage_h.release()
            self.timings["plan_build_s"] = time.perf_counter() - t0
        else:
            self._init_lookup(alphas_np, self.operator.basis.number_bits)
            self._capacity = self._fused_capacity()
            if mode != "fused":
                self._build_streamed()

    def _track_staging(self, kind: str, nbytes: int, nchunks: int):
        """A plan build's staged buffers in the memory ledger for the
        build's duration (``plan/<kind>:<i>/staging``, the JAX paths):
        what an OOM during the build points at."""
        if obs_enabled():
            self._plan_stage_h = obs_memory.track(
                f"plan/{obs_memory.next_instance(kind)}/staging",
                int(nbytes), kind="staging", chunks=int(nchunks))
        return self._plan_stage_h

    def _register_plan_memory(self) -> None:
        """The streamed plan's host bytes (``plan/stream_plan:<i>/host``,
        device ``host``) and, on the card, the pinned H2D ring's device
        slots (``…/ring``) in the memory ledger for the engine's lifetime,
        plus the ``stream_plan_bytes`` gauge; re-registered after a
        re-tune rebuilds the plan."""
        if self._plan_mem_h is not None:
            self._plan_mem_h.release()
            self._plan_mem_h = None
        if not obs_enabled() or self.mode not in ("streamed", "hybrid"):
            return
        base = f"plan/{obs_memory.next_instance('stream_plan')}"
        h = obs_memory.track(f"{base}/host", int(self.plan_bytes),
                             device="host", kind="stream_plan", tier="ram",
                             chunks=int(self.nchunks))
        if getattr(self, "_dev_bufs", None) is not None:
            obs_memory.track(f"{base}/ring",
                             obs_memory.tensor_bytes(self._dev_bufs),
                             device="device", kind="h2d_ring",
                             slots=int(self._dev_bufs.shape[0]), handle=h)
        self._plan_mem_h = h
        weakref.finalize(self, h.release)
        gauge("stream_plan_bytes").set(int(self.plan_bytes))

    def _build_streamed(self) -> None:
        """Build, encode and stage the streamed (or hybrid) plan at the
        engine's current knobs (row chunk, tier, split): the constructor's
        streamed branch, and a re-tune's rebuild at a safe boundary.  A
        hybrid ``"auto"`` split is resolved here from the build census."""
        dev = self.device
        self._phase_count_cache = {}
        self._capacity = self._fused_capacity()
        cfb = 8 if self.real else 16
        stage_h = self._track_staging(
            "stream_build", 2 * (self.batch_size * self.num_terms
                                 * (4 + cfb) + self.n_devices
                                 * self._capacity * 5), self.nchunks)
        t0 = time.perf_counter()
        with self.timer.scope("build_plan"):
            raw = self._build_stream_plan()
        self.timings["plan_build_s"] = time.perf_counter() - t0
        if self.mode == "hybrid" and self._hybrid_mask is None:
            self._hybrid_mask = self._auto_hybrid_mask(raw)
        t0 = time.perf_counter()
        self._encode_stream_plan(raw)
        self.timings["plan_encode_s"] = time.perf_counter() - t0
        self._cdict = torch.from_numpy(np.stack(
            [self._codec.dict_device_row(d) for d in self._shards])).to(dev)
        spec = self._codec.spec
        self._stream_kernel = "cuda" if (
            self.mode == "streamed" and self.real and spec["tier"] != "off"
            and spec["coeff"] == "dict") else "torch"
        self._hyb_tables = None
        if self.mode == "hybrid":
            self._setup_hybrid_recompute()
        if dev.type == "cuda":
            if getattr(self, "_copy_stream", None) is None:
                self._copy_stream = torch.cuda.Stream(dev)
            self._dev_bufs = None
            self._grow_ring(2)
        self._drift_state = None
        stage_h.release()           # staging gone; the plan is resident
        obs_memory.sample_watermark("plan_upload/distributed")

    # -- ranks ---------------------------------------------------------------

    def _exchange(self, send: torch.Tensor) -> torch.Tensor:
        """:func:`all_to_all` over this engine's shards, counting the bytes
        put in."""
        self.exchange_bytes += send.numel() * send.element_size()
        return all_to_all(send, self.group)

    def _exchange_start(self, send: torch.Tensor
                        ) -> Callable[[], torch.Tensor]:
        """Start :func:`all_to_all` of ``send`` for a pipelined apply,
        counting the bytes put in; returns the wait that gives the receive
        block.  In one process it is the transpose, done now; on ranks the
        staged exchange, left in flight."""
        self.exchange_bytes += send.numel() * send.element_size()
        if self.group is None:
            recv = all_to_all(send)
            return lambda: recv
        pending = self.group.exchange_async(send[0])
        return lambda: pending.wait()[None]

    def _run_chunks(self, chunks, produce, consume) -> None:
        """The chunk schedule of the chunked applies.  ``produce(ci,
        chunk)`` queues chunk ci's send side and returns ``(send blocks,
        carry)``; ``consume(carry, *receive blocks)`` is its receive side.
        At depth 0 each chunk is exchanged (:meth:`_exchange`) and consumed
        before the next is produced.  At depth d ≥ 2 each chunk's
        exchanges start as soon as it is produced, and it retires — its
        waits, then ``consume`` — strictly in chunk order once d − 1 later
        chunks have been produced; the last d − 1 drain in order.  The
        host time spent in those waits goes to ``last_pipeline`` (and, in
        an observed streamed apply, to the chunk's timeline entry as its
        ``exch_ms``)."""
        d = self.pipeline_depth
        if d >= 2 and self.last_pipeline is None:
            self.last_pipeline = {"depth": d, "chunks": 0, "barrier_ms": 0.0}
        rec = self.last_pipeline
        timeline = self._timeline
        flight: list = []

        def retire():
            waits, carry, entry = flight.pop(0)
            t0 = time.perf_counter()
            recvs = [w() for w in waits]
            wait_ms = (time.perf_counter() - t0) * 1e3
            rec["barrier_ms"] += wait_ms
            rec["chunks"] += 1
            if entry is not None:
                entry["exch_ms"] = round(wait_ms, 4)
            consume(carry, *recvs)

        for ci, chunk in enumerate(chunks):
            sends, carry = produce(ci, chunk)
            if d < 2:
                consume(carry, *[self._exchange(s) for s in sends])
                continue
            # the streamed chunk source appended this chunk's entry
            entry = timeline[-1] if timeline else None
            flight.append(([self._exchange_start(s) for s in sends], carry,
                           entry))
            if len(flight) == d:
                retire()
        while flight:
            retire()

    @property
    def pipeline_depth(self) -> int:
        """The resolved pipeline depth the next apply runs at (0: the
        sequential schedule); assigning a value resolves it again."""
        return self._pipeline_depth

    @pipeline_depth.setter
    def pipeline_depth(self, value) -> None:
        self._pipeline_depth = self._resolve_pipeline_depth(value)

    @property
    def stream_kernel(self) -> Optional[str]:
        """The streamed (and hybrid) apply's send-side decode path, fixed
        by the plan's shape at build time: ``"cuda"`` — the decode kernel
        ``fused_decode_gather_scatter`` (real sector, dictionary codes, not
        ``off``, not hybrid; on CPU tensors its wrapper takes the plain
        version) — or ``"torch"``; None in the other modes."""
        return self._stream_kernel

    def _resolve_pipeline_depth(self, value) -> int:
        """JAX ``_resolve_pipeline_depth`` for this engine's chunk count:
        ell and compact have no chunk sequence and resolve 0; None, "",
        "off", 0, 1 (and "false"/"no"/"none") are 0; an integer ≥ 2 is
        clamped to the chunk count, and a clamp below 2 is 0; fused runs at
        most 2.  ``"auto"`` is the roofline policy
        (:func:`~..obs.roofline.choose_pipeline_depth` over the one-column
        phase counts under the calibration of the engine's device); on
        ranks the largest rank's answer is taken, so every rank runs one
        schedule (a collective: every rank resolves together)."""
        if self.mode not in ("fused", "streamed", "hybrid"):
            return 0
        if value is None:
            value = get_config().pipeline
        s = str(value).strip().lower()
        if s in ("", "off", "0", "1", "false", "no", "none"):
            return 0
        if s == "auto":
            from ..obs import roofline as _roofline

            depth = _roofline.choose_pipeline_depth(
                self._phase_counts(1),
                _roofline.resolve_calibration(device=self.device),
                self.nchunks, self.n_devices)
            if self.group is not None:
                depth = self._agree(depth, op="max")[0]
            s = str(depth)
            if depth < 2:
                return 0
        try:
            depth = int(s)
        except ValueError:
            raise ValueError(
                f"bad pipeline depth {value!r}: pick off | auto | an "
                "integer >= 2 (DMT_PIPELINE / config.pipeline)") from None
        if depth < 0:
            raise ValueError(f"pipeline depth must be >= 0, got {depth}")
        depth = min(depth, max(self.nchunks, 1))
        # a clamp down to one chunk leaves nothing to pipeline
        depth = depth if depth >= 2 else 0
        return min(depth, 2) if self.mode == "fused" else depth

    def reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks of the engine's group (``t`` itself
        without one): the reduction a solver's dots and norms take on a
        rank engine."""
        return t if self.group is None else self.group.all_reduce(t)

    def _agree(self, *values, op: str = "sum") -> List[int]:
        """Integer counts summed (or maximized) over the ranks, as they are
        without a group.  A check that raises on the result raises on
        every rank together: a one-sided raise would leave the others
        waiting in their next collective."""
        t = torch.stack([torch.as_tensor(v, dtype=torch.int64,
                                         device=self.device)
                         for v in values])
        if self.group is not None:
            t = self.group.all_reduce(t, op)
        return [int(v) for v in t.tolist()]

    def _local(self, d: Optional[int]) -> int:
        """The local row of global shard d (None: this process's first)."""
        if d is None:
            return 0
        if d not in self._shards:
            raise ValueError(f"shard {d} is not held here (this process "
                             f"holds {self._shards})")
        return self._shards.index(d)

    # -- shared set-up ---------------------------------------------------------

    def _init_lookup(self, alphas_np: np.ndarray, n_bits: int) -> None:
        """Per-shard bucketed lookup over each shard's real prefix, with one
        directory width for all shards (from the largest) so the stacked
        tables are uniform; pad rows repeat the last real row so a probe
        clamping past the prefix cannot match a SENTINEL query.  The probe
        count is the largest any shard needs (agreed over the ranks)."""
        M = self.shard_size
        counts = self.counts
        b_global = choose_dir_bits(int(counts.max()), n_bits)
        pairs = np.full((len(self._shards), M, 2), 0xFFFFFFFF, np.uint32)
        dirs = []
        probes, shift = 0, None
        for i, d in enumerate(self._shards):
            c = int(counts[d])
            lk = build_sorted_lookup(alphas_np[d, :c], n_bits,
                                     dir_bits=b_global)
            shift, probes = lk[2], max(probes, lk[3])
            pairs[i, :c] = lk[0]
            if 0 < c < M:
                pairs[i, c:] = lk[0][-1]
            dirs.append(lk[1])
        self._lk_pair = torch.from_numpy(pairs.astype(np.int64)).to(
            self.device)                                       # [L, M, 2]
        self._lk_dir = torch.from_numpy(np.stack(dirs)).to(self.device)
        self._lk_shift = shift
        self._lk_probes = self._agree(probes, op="max")[0]

    def _lookup(self, i: int, states: torch.Tensor):
        """(index, found) of ``states`` on local shard row i."""
        return state_index_bucketed(
            self._lk_pair[i], self._lk_dir[i], states, shift=self._lk_shift,
            probes=self._lk_probes)

    def _fused_capacity(self, batch_rows: Optional[int] = None) -> int:
        """Entries per exchange bucket of one row chunk: all of them at
        D = 1, else ``min(max(⌈factor·B·T/D⌉, 64), B·T,
        remote_buffer_size)`` (warning when that is below the mean bucket
        size), rounded up to 8."""
        D, T = self.n_devices, self.num_terms
        B = batch_rows or self.batch_size
        total = B * max(T, 1)
        if D == 1:
            return _round_up(total, 8)
        mean = total / D
        cap = int(math.ceil(mean * max(self.all_to_all_capacity_factor,
                                       1.0)))
        cap = min(max(cap, 64), total, self.remote_buffer_size)
        if cap < mean:
            # a cap below the per-chunk mean bucket size makes overflow
            # near-certain for any balanced hash; kept a warning, not an
            # error, as tiny caps are how the overflow check is exercised
            warnings.warn(
                f"fused-mode exchange capacity {cap} is below the mean "
                f"per-peer bucket size {mean:.0f} (batch {B} × {T} terms "
                f"on {D} shards) — the first apply will almost surely "
                "overflow; raise remote_buffer_size or lower batch_size",
                RuntimeWarning, stacklevel=3)
        return _round_up(cap, 8)

    @staticmethod
    def _validate_counters(overflow: int, invalid: int, key,
                           cap: int) -> None:
        """Raise when the counters report lost amplitudes."""
        if overflow:
            raise RuntimeError(
                f"{overflow} amplitudes overflowed the all_to_all "
                f"capacity {cap} (program chunk {key}); raise "
                "remote_buffer_size or all_to_all_capacity_factor")
        if invalid:
            raise RuntimeError(
                f"{invalid} generated amplitudes map outside the "
                "basis — operator does not preserve the chosen sector")

    def _route(self, betas: torch.Tensor, live: torch.Tensor, cap: int):
        """Bucket routing of one shard's chunk: ``dest`` [n] (``key·cap +
        rank``, or the drop slot ``D·cap`` for dead and overflowed
        entries) and the overflow count."""
        D = self.n_devices
        owner = shard_index(betas, D).to(torch.int64)
        key = torch.where(live, owner, D)
        pos = _bucket_positions(key, D)
        in_cap = (pos < cap) & (key < D)
        overflow = ((pos >= cap) & (key < D)).sum()
        return torch.where(in_cap, key * cap + pos, D * cap), overflow

    # -- streamed: plan build ------------------------------------------------

    @property
    def nchunks(self) -> int:
        """Row chunks per shard (streamed and fused modes)."""
        B = self.batch_size
        return (self.shard_size + B - 1) // B

    def _chunk_rows(self, i: int, ci: int, B: Optional[int] = None):
        """Local shard row i's row chunk ``ci`` padded to B (SENTINEL rows,
        unit norms)."""
        B = B or self.batch_size
        M = self.shard_size
        s, e = ci * B, min((ci + 1) * B, M)
        a, nn = self._alphas[i, s:e], self._norms[i, s:e]
        if e - s < B:
            pad = B - (e - s)
            a = torch.cat([a, torch.full((pad,), SENTINEL_STATE,
                                         dtype=a.dtype, device=a.device)])
            nn = torch.cat([nn, torch.ones(pad, dtype=nn.dtype,
                                           device=nn.device)])
        return a, nn

    def _build_chunk(self, ci: int):
        """Row chunk ``ci`` of every shard held here, as the JAX build
        program runs it: each shard's kernels + orbit scan and bucket
        routing, one exchange of the target states, each shard's
        receive-side lookup.  Returns ``({shard: raw chunk}, overflow,
        invalid)``, a raw chunk being the host arrays ``dest`` [B·T] i32,
        ``coeff`` [B, T] f64 or c128 — the scatter form, conj(row
        coefficient), as the JAX build stores it — ``ridx`` [D·Cap] i32
        and ``rok`` [D·Cap] bool."""
        D, Cap, L = self.n_devices, self._capacity, len(self._shards)
        send_b = torch.full((L, D * Cap + 1), SENTINEL_STATE,
                            dtype=torch.int64, device=self.device)
        per, overflow = {}, 0
        for i, s in enumerate(self._shards):
            a, nn = self._chunk_rows(i, ci)
            betas, gcoeff = K.gather_coefficients(self.tables, a, nn)
            nz = (gcoeff != 0) & (a != SENTINEL_STATE)[:, None]
            flat_b = betas.reshape(-1)
            dest, ov = self._route(flat_b, nz.reshape(-1), Cap)
            overflow += int(ov)
            # the trailing slot takes the dropped (dead) entries
            send_b[i, dest] = flat_b
            per[s] = {"dest": dest.to(torch.int32).cpu().numpy(),
                      "coeff": torch.where(nz, gcoeff.conj(),
                                           torch.zeros_like(gcoeff))
                      .cpu().numpy()}
        recv_b = self._exchange(send_b[:, :D * Cap].reshape(L, D, Cap))
        invalid = 0
        for i, d in enumerate(self._shards):
            rb = recv_b[i].reshape(-1)
            idx, found = self._lookup(i, rb)
            live_r = rb != SENTINEL_STATE
            okc = found & live_r
            invalid += int((live_r & ~found).sum())
            per[d]["ridx"] = torch.where(okc, idx, 0).to(
                torch.int32).cpu().numpy()
            per[d]["rok"] = okc.cpu().numpy()
        return per, overflow, invalid

    def _build_stream_plan(self):
        """Resolve every row chunk's structure once into host arrays,
        ``[{shard: raw chunk}]`` as the JAX engine keeps them; raises on
        overflow or out-of-basis targets (on every rank)."""
        chunks = []
        overflow = invalid = 0
        for ci in range(self.nchunks):
            per, ov, iv = self._build_chunk(ci)
            chunks.append(per)
            overflow += ov
            invalid += iv
        self._validate_counters(*self._agree(overflow, invalid), "streamed",
                                self._capacity)
        return chunks

    def _codec_agree(self, use_dict: bool, nd: int, fill: int,
                     n_live: int):
        """The codec's job-wide decisions (JAX ``_codec_agree``): the
        encoded shapes enter every rank's apply, so all ranks take the
        dictionary only if every rank can, and the largest dictionary,
        bucket fill and live-entry count."""
        g = self.group.all_gather(torch.tensor(
            [int(bool(use_dict)), int(nd), int(fill), int(n_live)],
            dtype=torch.int64, device=self.device)).cpu().numpy()
        return (bool(g[:, 0].min()), int(g[:, 1].max()),
                int(g[:, 2].max()), int(g[:, 3].max()))

    def _codec_check(self) -> None:
        """On ranks: the codec's tier and hybrid stream mask must be the
        same on every rank (the encoded shapes enter every rank's apply);
        all-gathered before the codec is built, so a mismatch raises on
        every rank together."""
        mask = self._hybrid_mask
        bits = np.zeros(self.num_terms, bool) if mask is None else mask
        g = self.group.all_gather(torch.tensor(
            [PC.TIERS.index(self._codec_tier), int(mask is not None),
             *bits.astype(np.int64).tolist()],
            dtype=torch.int64, device=self.device)).cpu().numpy()
        if not (g == g[0]).all():
            seen = [(PC.TIERS[r[0]], r[2:].tolist() if r[1] else None)
                    for r in g]
            raise RuntimeError(
                f"the ranks' plan codecs differ (tier, hybrid stream "
                f"mask): {seen}")

    def _record_sizes(self, spec: Dict) -> Dict[str, int]:
        """Bytes of each section of one (chunk, shard) record: the codec's
        encoded arrays and the fill counts."""
        D, B, T = self.n_devices, self.batch_size, self.num_terms
        nl, n_recv = spec["n_live"], spec["n_recv"]
        ncomp = 1 if spec["ckind"] == "real" else 2
        if spec["tier"] == "off":
            # raw dest i32 [B·T], coeff f64/c128 [B, T], ridx i32
            sizes = {"dest": 4 * B * T, "ridx": 4 * n_recv,
                     "coeff": 8 * ncomp * B * T}
        else:
            value_bytes = {"lossless": 8, "f32": 4, "bf16": 2}[spec["tier"]]
            sizes = {"dest": 4 * (PC.packed_words(nl, spec["w_dest"])
                                  + PC.packed_words(nl, spec["w_row"])),
                     "ridx": 4 * PC.packed_words(n_recv, spec["w_ridx"]),
                     "coeff": (nl * spec["code_bits"] // 8
                               if spec["coeff"] == "dict"
                               else nl * ncomp * value_bytes)}
        sizes.update(rok=4 * PC.packed_words(n_recv, 1), fill=4 * D)
        return sizes

    def _encode_stream_plan(self, raw) -> None:
        """Encode the raw chunks with the codec and pack them into one host
        buffer (pinned on CUDA) of ``[nchunks, L]`` equal-stride records,
        one per shard held here: dest | ridx | rok | coeff | fill counts,
        each section at a 16-byte offset (so a f64 or c128 section views in
        place)."""
        D, B, T = self.n_devices, self.batch_size, self.num_terms
        L = len(self._shards)
        if self.group is not None:
            self._codec_check()
        self._codec = codec = PC.PlanCodec.build(
            self._codec_tier, raw, n_dest=B * T,
            cap_build=self._capacity, n_devices=D,
            shard_size=self.shard_size, cshape=(B, T),
            ckind="real" if self.real else "complex",
            agree=None if self.group is None else self._codec_agree,
            dict_max=PC.DICT_MAX, term_mask=self._hybrid_mask)
        sizes = self._record_sizes(codec.spec)
        layout, off = {}, 0
        for k in ("dest", "ridx", "rok", "coeff", "fill"):
            layout[k] = (off, sizes[k])
            off = _round_up(off + sizes[k], _ALIGN)
        self._chunk_stride = off
        self._chunk_layout = layout
        n = self.nchunks
        self._plan_host = torch.zeros(
            (n, L, self._chunk_stride), dtype=torch.uint8,
            pin_memory=self.device.type == "cuda")
        host = self._plan_host.numpy()

        def encode(ci: int) -> int:
            """Encode chunk ci's records into the host buffer; returns the
            encoded streams' bytes, as the JAX engine counts them."""
            nbytes = 0
            for i, d in enumerate(self._shards):
                pc = raw[ci][d]
                enc = codec.encode_chunk(pc, d)
                enc["fill"] = PC.send_fill(pc["dest"], D, self._capacity)
                for k, (o, nb) in layout.items():
                    a = np.ascontiguousarray(enc[k]).reshape(-1).view(
                        np.uint8)
                    if a.size != nb:
                        raise ValueError(f"encoded {k} has {a.size} bytes, "
                                         f"the chunk layout {nb}")
                    host[ci, i, o:o + nb] = a
                del enc["fill"]
                nbytes += PC.PlanCodec.encoded_bytes(enc)
            raw[ci] = None                       # free the raw chunk
            return nbytes

        # chunks encode independently into their own records; NumPy's
        # large-array kernels release the GIL, so threads overlap them
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            enc_bytes = sum(pool.map(encode, range(n)))
        # the shards held here (on a rank engine, this rank's shard)
        self.plan_bytes = enc_bytes
        self.plan_bytes_raw = codec.raw_chunk_bytes() * n * L

    def _setup_hybrid_recompute(self) -> None:
        """The recompute side's tables (JAX ``_setup_hybrid_recompute``):
        the recompute terms' rows of the off-diagonal tables, with the
        trailing kernel columns that are zero for all of them trimmed (a
        zero column adds exactly 0, so the values are the build's bit for
        bit), and ``hybrid_stream_fraction``, the share of terms
        streamed."""
        mask = self._hybrid_mask
        sel = np.nonzero(~mask)[0]
        #: the share of the operator's terms whose entries are streamed
        self.hybrid_stream_fraction = float(mask.mean()) if mask.size \
            else 1.0
        if not sel.size:
            return
        off = self.tables.off
        idx = torch.from_numpy(sel).to(self.device)
        v = off.v[idx]
        knz = torch.nonzero((v != 0).any(dim=0)).reshape(-1)
        kmax = int(knz.max()) + 1 if knz.numel() else 1
        sub = K.OffDiagKernelTables(
            x=off.x[idx], v=v[:, :kmax], s=off.s[idx, :kmax],
            m=off.m[idx, :kmax], r=off.r[idx, :kmax])
        self._hyb_tables = K.OperatorTables(
            diag=self.tables.diag, off=sub, group=self.tables.group)

    # -- streamed: plan access ------------------------------------------------

    def _chunk_views(self, buf: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(dest, coeff, ridx, rok words, fill counts) of one (chunk,
        shard) record, as views of its bytes: ``dest`` and ``ridx`` int32
        (word streams, or the ``off`` tier's raw arrays); ``coeff`` the
        codes (uint8, or int16 for u16), or raw values — f64, f32 or bf16
        bits as int16, ``[n_live, 2]`` in a complex sector — or the ``off``
        tier's ``[B, T]`` f64/c128; ``fill`` int32 [D]."""
        spec = self._codec.spec

        def view(k, dtype):
            o, nb = self._chunk_layout[k]
            return buf[o:o + nb].view(dtype)

        cplx = spec["ckind"] == "complex"
        if spec["tier"] == "off":
            coeff = view("coeff", torch.float64)
            if cplx:
                coeff = torch.view_as_complex(coeff.reshape(-1, 2))
            coeff = coeff.reshape(self.batch_size, self.num_terms)
        elif spec["coeff"] == "dict":
            coeff = view("coeff", torch.uint8 if spec["code_bits"] == 8
                         else torch.int16)
        else:
            coeff = view("coeff", {"lossless": torch.float64,
                                   "f32": torch.float32,
                                   "bf16": torch.int16}[spec["tier"]])
            if cplx:
                coeff = coeff.reshape(-1, 2)
        return (view("dest", torch.int32), coeff, view("ridx", torch.int32),
                view("rok", torch.int32), view("fill", torch.int32))

    def plan_chunk(self, ci: int, d: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
        """Shard d's encoded chunk ``ci`` (default: the first shard held
        here) as NumPy arrays in the JAX engine's form (``dest``/``ridx``
        u32 word streams or the ``off`` tier's raw i32, ``rok`` u32 words,
        ``coeff`` u8/u16 codes or the raw f64/f32/u16/c128 values), plus
        its ``fill`` counts [D] int32."""
        dest, coeff, ridx, rok, fill = self._chunk_views(
            self._plan_host[ci, self._local(d)])
        words = np.int32 if self._codec.spec["tier"] == "off" else np.uint32
        cf = coeff.numpy()
        return {"dest": dest.numpy().view(words),
                "coeff": cf.view(np.uint16) if cf.dtype == np.int16 else cf,
                "ridx": ridx.numpy().view(words),
                "rok": rok.numpy().view(np.uint32),
                "fill": fill.numpy().copy()}

    def _grow_ring(self, slots: int) -> None:
        """Device buffers and events for an H2D ring of at least ``slots``
        plan chunks."""
        if getattr(self, "_dev_bufs", None) is not None \
                and self._dev_bufs.shape[0] >= slots:
            return
        self._dev_bufs = torch.empty(
            (slots, len(self._shards), self._chunk_stride), dtype=torch.uint8,
            device=self.device)
        self._ready = [torch.cuda.Event() for _ in range(slots)]
        self._free = [torch.cuda.Event() for _ in range(slots)]

    def _stream_chunks(self, slots: Optional[int] = None
                       ) -> Iterator[List[Tuple[torch.Tensor, ...]]]:
        """The plan's chunks as device views, in order: per chunk, the
        record views of the shards held here.  On CUDA each chunk's records
        are copied host → device in one copy on a side stream into a ring
        of ``slots`` buffers (default ``max(2, pipeline_depth)``), ``slots``
        − 1 chunks ahead of use; the compute stream waits for the copy, and
        the copy into a slot waits for the compute that last read it —
        everything queued before the consumer asks for the next chunk.  The
        applies read a chunk's records only while producing it, so the
        ring is the counterpart of the JAX engine's prefetch depth."""
        n, L = self.nchunks, len(self._shards)
        timeline = self._timeline
        # the plan_upload fault site, only while DMT_FAULT arms a site
        host = self._fetch_plan_chunk if faults.enabled() \
            else self._plan_host.__getitem__
        if self.device.type != "cuda":
            for ci in range(n):
                entry = None
                if timeline is not None:
                    # the plan never leaves host memory: nothing to wait on
                    entry = {"chunk": ci, "stall_ms": 0.0, "stage_ms": 0.0}
                    timeline.append(entry)
                    t0 = time.perf_counter()
                rec = host(ci)
                yield [self._chunk_views(rec[d]) for d in range(L)]
                if entry is not None:
                    entry["dispatch_ms"] = round(
                        (time.perf_counter() - t0) * 1e3, 4)
            return
        S = slots or max(self.pipeline_depth, 2)
        self._grow_ring(S)
        compute = torch.cuda.current_stream(self.device)
        copy = self._copy_stream
        # observed apply: per chunk three timing events — the copy's start
        # and end on the copy stream, and the compute stream's arrival at
        # its wait — read after the apply's end-of-apply synchronization
        ev = None
        if timeline is not None:
            base = len(timeline)
            need = 3 * (base + n)
            while len(self._tl_events) < need:
                self._tl_events.append(torch.cuda.Event(enable_timing=True))
            ev = self._tl_events

        def issue(ci):
            slot = ci % S
            with torch.cuda.stream(copy):
                copy.wait_event(self._free[slot])
                if ev is not None:
                    ev[3 * (base + ci)].record(copy)
                self._dev_bufs[slot].copy_(host(ci), non_blocking=True)
                self._ready[slot].record(copy)
                if ev is not None:
                    ev[3 * (base + ci) + 1].record(copy)

        copy.wait_stream(compute)
        for ci in range(min(S - 1, n)):
            issue(ci)
        for ci in range(n):
            if ci + S - 1 < n:
                # the slot of chunk ci − 1, released just below
                issue(ci + S - 1)
            slot = ci % S
            entry = None
            if ev is not None:
                entry = {"chunk": ci, "_ev": 3 * (base + ci)}
                timeline.append(entry)
                ev[3 * (base + ci) + 2].record(compute)
                t0 = time.perf_counter()
            compute.wait_event(self._ready[slot])
            yield [self._chunk_views(self._dev_bufs[slot, d])
                   for d in range(L)]
            self._free[slot].record(compute)
            if entry is not None:
                entry["dispatch_ms"] = round(
                    (time.perf_counter() - t0) * 1e3, 4)

    def _fetch_plan_chunk(self, ci: int) -> torch.Tensor:
        """The host half of one plan chunk's upload: the ``plan_upload``
        fault site and the fetch of its ``[L, stride]`` records, retried
        with backoff (``io_retries``, ``io_retry_base_s``)."""
        def fetch():
            faults.check("plan_upload", exc=RuntimeError, chunk=ci)
            return self._plan_host[ci]

        return faults.with_retries("plan_upload", fetch,
                                   exc_types=(RuntimeError,))

    # -- streamed: apply -----------------------------------------------------

    def _apply(self, xh: torch.Tensor, chunks=None) -> torch.Tensor:
        """The streamed (and hybrid) apply of at most 4 columns over
        ``chunks``, an iterable of the plan's per-chunk shard views on the
        device in chunk order (default: :meth:`_stream_chunks` streams them
        from host memory), in :meth:`_run_chunks`' schedule.  Produce: per
        chunk and shard the send side into one of ``max(1, depth)`` send
        slots (L the shards held here) — on the ``"cuda"`` path one decode
        launch per column into ``[L, R, D·cap + 1]``, on the ``"torch"``
        path :meth:`_decode_send` into ``[L, D·cap + 1, R]`` — and the
        chunk's ridx/rok decoded.  Consume: per shard one ``index_add_`` of
        its ``[n_recv, R]`` receive block.  A send slot is written again
        only after the chunk that last used it has retired."""
        D, M, B = self.n_devices, self.shard_size, self.batch_size
        L = len(self._shards)
        spec = self._codec.spec
        n_recv, cap = spec["n_recv"], spec["cap_eff"]
        x = xh.reshape(L, M, -1)                       # [L, M, R]
        R = x.shape[2]
        if chunks is None:
            chunks = self._stream_chunks()
        dt, dev = self._dtype, self.device
        S, Mp = max(self.pipeline_depth, 1), self.nchunks * B
        kernel = self._stream_kernel == "cuda"
        if kernel:
            # column-major copy: each column's chunk rows are contiguous,
            # as the kernel takes them
            xp = torch.zeros((L, R, Mp), dtype=dt, device=dev)
            xp[:, :, :M] = x.transpose(1, 2)
            sends = torch.empty((S, L, R, n_recv + 1), dtype=dt, device=dev)
        else:
            xp = torch.zeros((L, Mp, R), dtype=dt, device=dev)
            xp[:, :M] = x
            sends = torch.empty((S, L, n_recv + 1, R), dtype=dt, device=dev)
        y = torch.zeros((L, M, R), dtype=dt, device=dev)

        def produce(ci, views):
            send = sends[ci % S]
            rows = slice(ci * B, (ci + 1) * B)
            recv_side = []
            for s in range(L):
                if not kernel:
                    recv_side.append(self._decode_send(send[s], views[s], s,
                                                       ci, xp[s, rows]))
                    continue
                edest, codes, ridx_w, rok_w, fill = views[s]
                for r in range(R):
                    PC.fused_decode_gather_scatter(
                        spec, edest, codes, fill, self._cdict[s],
                        xp[s, r, rows], out=send[s, r])
                recv_side.append(PC.decode_recv(spec, ridx_w, rok_w))
            if kernel:                                 # [L, D, cap, R]
                return ((send[:, :, :n_recv].reshape(L, R, D, cap)
                         .permute(0, 2, 3, 1),), recv_side)
            return (send[:, :n_recv].reshape(L, D, cap, R),), recv_side

        def consume(recv_side, recv):
            for d, (ridx, rok) in enumerate(recv_side):
                add = torch.where(rok[:, None], recv[d].reshape(n_recv, R),
                                  0)
                if dt.is_complex:
                    # the components, added in the same order
                    torch.view_as_real(y[d]).index_add_(
                        0, ridx, torch.view_as_real(add))
                else:
                    y[d].index_add_(0, ridx, add)

        self._run_chunks(chunks, produce, consume)
        return (y + self._diag.to(dt)[:, :, None] * x).reshape(xh.shape)

    def _decode_send(self, send: torch.Tensor, views, s: int, ci: int,
                     x_c: torch.Tensor):
        """The ``"torch"`` decode path of local shard row s's chunk ci (JAX
        ``decode_send``'s XLA branch): zero the ``[D·cap + 1, R]`` send
        buffer, decode the chunk (:func:`~..ops.plan_codec.
        decode_plan_shard`), multiply each entry's coefficient by its row
        of ``x_c`` ([B, R]: ``x[row]``, or in the ``off`` tier the implicit
        row ``i // T``) and scatter by the decoded destinations (padding
        and dead entries land in the trailing drop slot); in hybrid mode
        add the recompute terms (:meth:`_recompute`).  Returns the chunk's
        decoded ``(ridx, rok)``."""
        spec = self._codec.spec
        edest, coeff, ridx_w, rok_w, _ = views
        send.zero_()
        dec = PC.decode_plan_shard(spec, edest, coeff, ridx_w, rok_w,
                                   self._cdict[s])
        if spec["tier"] == "off":
            dest, cf, ridx, rok = dec
            amps = _mul(cf[:, :, None], x_c[:, None, :])
        else:
            dest, row, cf, ridx, rok = dec
            amps = _mul(cf[:, None], x_c[row])
        send[dest] = amps.reshape(-1, x_c.shape[1])
        if self._hyb_tables is not None:
            self._recompute(send, s, ci, x_c, dest)
        return ridx, rok

    def _recompute(self, send: torch.Tensor, s: int, ci: int,
                   x_c: torch.Tensor, dest_s: torch.Tensor) -> None:
        """Hybrid's recompute side (JAX ``make_recompute``): re-derive the
        recompute terms' entries of local shard row s's chunk ci on the
        device — the build's kernels, orbit scan and bucket routing on the
        term subset, whose values equal the build's bit for bit — and
        scatter their amplitudes into ``send`` at their merged slots.  In
        the full plan each bucket's live entries hold its slot prefix in
        (row, term) order, so the recompute entries hold the slots the
        streamed entries (``dest_s``, pads at the drop slot) leave free, in
        increasing order: the j-th recompute entry of a bucket lands on its
        j-th free slot (a cumsum over the free mask)."""
        D = self.n_devices
        spec = self._codec.spec
        cap, n_recv = spec["cap_eff"], spec["n_recv"]
        dev = send.device
        a_c, n_c = self._chunk_rows(s, ci)
        betas, gcoeff = K.gather_coefficients(self._hyb_tables, a_c, n_c)
        nz = (gcoeff != 0) & (a_c != SENTINEL_STATE)[:, None]
        cf = torch.where(nz, gcoeff.conj(), torch.zeros_like(gcoeff))
        key = torch.where(nz.reshape(-1), shard_index(
            betas.reshape(-1), D).to(torch.int64), D)
        pos = _bucket_positions(key, D)
        occ = torch.zeros(n_recv + 1, dtype=torch.bool, device=dev)
        occ[dest_s] = True
        free = ~occ[:n_recv].reshape(D, cap)
        slots = torch.arange(n_recv, device=dev).reshape(D, cap)
        # slot_of[k·cap + j] = bucket k's j-th free slot (within the bucket)
        tgt = torch.where(free, slots - slots % cap
                          + torch.cumsum(free, dim=1) - 1, n_recv)
        slot_of = torch.zeros(n_recv + 1, dtype=torch.int64, device=dev)
        slot_of[tgt.reshape(-1)] = (slots % cap).reshape(-1)
        safe = key.clamp(0, D - 1) * cap + pos.clamp(max=cap - 1)
        dest_r = torch.where((key < D) & (pos < cap),
                             key * cap + slot_of[safe], n_recv)
        send[dest_r] = _mul(cf[:, :, None], x_c[:, None, :]).reshape(
            -1, x_c.shape[1])

    # -- fused ---------------------------------------------------------------

    def _apply_fused(self, x: torch.Tensor, B: int, cap: int):
        """Per row chunk: each shard re-runs the kernels, routes its
        amplitudes and their target states into ``[D, cap]`` buckets; both
        are exchanged; each shard looks the targets up and adds — in
        :meth:`_run_chunks`' schedule.  ``x`` is ``[L, M, R]``.  Returns
        (y, overflow, invalid) as tensors."""
        D, M, L = self.n_devices, self.shard_size, len(self._shards)
        R = x.shape[2]
        nchunks = (M + B - 1) // B
        dev, dtype = self.device, self._dtype
        xp = torch.zeros((L, nchunks * B, R), dtype=dtype, device=dev)
        xp[:, :M] = x
        y = torch.zeros((L, M, R), dtype=dtype, device=dev)
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        invalid = torch.zeros((), dtype=torch.int64, device=dev)

        def produce(ci, _):
            send_b = torch.full((L, D * cap + 1), SENTINEL_STATE,
                                dtype=torch.int64, device=dev)
            send_a = torch.zeros((L, D * cap + 1, R), dtype=dtype,
                                 device=dev)
            for s in range(L):
                a_c, n_c = self._chunk_rows(s, ci, B)
                x_c = xp[s, ci * B:(ci + 1) * B]              # [B, R]
                betas, gcoeff = K.gather_coefficients(self.tables, a_c, n_c)
                # scatter form: conj(row form)·x[α]; liveness is structural
                nz = (gcoeff != 0) & (a_c != SENTINEL_STATE)[:, None]
                amps = torch.where(nz[..., None],
                                   gcoeff.conj()[..., None] * x_c[:, None],
                                   0)
                flat_b = betas.reshape(-1)
                dest, ov = self._route(flat_b, nz.reshape(-1), cap)
                overflow.add_(ov)
                send_b[s, dest] = flat_b
                send_a[s, dest] = amps.reshape(-1, R)
            return (send_b[:, :D * cap].reshape(L, D, cap),
                    send_a[:, :D * cap].reshape(L, D, cap, R)), None

        def consume(_, recv_b, recv_a):
            for d in range(L):
                rb = recv_b[d].reshape(-1)
                idx, found = self._lookup(d, rb)
                live_r = rb != SENTINEL_STATE
                okc = found & live_r
                invalid.add_((live_r & ~found).sum())
                y[d].index_add_(0, torch.where(okc, idx, 0), torch.where(
                    okc[:, None], recv_a[d].reshape(-1, R), 0))

        self._run_chunks(range(nchunks), produce, consume)
        return y, overflow, invalid

    # -- ell / compact: the static routing plan -----------------------------

    def _compact_W(self, alphas_np: np.ndarray) -> float:
        """The single off-diagonal magnitude W, from a sample strided across
        the shards' real rows (the hash partition makes every shard an
        unbiased sample); raises when the sample shows more than one."""
        from .engine import compact_magnitudes

        D = self.n_devices
        per = max(1, 4096 // D)
        smp = [alphas_np[d][np.linspace(
            0, int(c) - 1, min(per, int(c))).astype(np.int64)]
            for d, c in enumerate(self.counts) if c]
        vals = compact_magnitudes(
            self.operator, sample_states=np.concatenate(smp) if smp
            else np.zeros(0, np.uint64))
        if vals.size > 1:
            raise ValueError(
                f"compact mode needs a single off-diagonal magnitude, "
                f"found {vals[:5]}; use mode='ell'")
        return float(vals[0]) if vals.size else 0.0

    def _structure_chunks(self, i: int, Bc: int):
        """Yield ``(s, e, n_c, betas, cf, nz)`` per row chunk of local shard
        row i, padded to ``Bc`` rows (SENTINEL rows carry cf == 0), as
        tensors on the device."""
        M = self.shard_size
        for ci in range((M + Bc - 1) // Bc):
            s, e = ci * Bc, min((ci + 1) * Bc, M)
            a_c, n_c = self._chunk_rows(i, ci, Bc)
            betas, cf = K.gather_coefficients(self.tables, a_c, n_c)
            nz = (cf != 0) & (a_c != SENTINEL_STATE)[:, None]
            yield s, e, n_c, betas, cf, nz

    def _resolve_targets(self, uniq, akey, compact: bool):
        """Pass 1b of the routing-plan build: resolve each shard's unique
        remote targets against the rows of the peer that owns them.

        ``uniq[i][p]`` holds local shard row i's sorted unique target keys
        on peer p (None: none).  Returns ``(reads, qstate, qnorm, bad)``:
        ``reads[i][q]`` the local indices peer q reads from shard row i;
        ``qstate[i][p]``/``qnorm[i][p]`` shard row i's targets found on
        peer p and their norms (norms in compact mode only); ``bad`` the
        targets no peer holds, as a tensor.  In one process the peers' rows
        are at hand; on ranks each list travels to its owner, is ranked
        there, and its ``ok`` mask (and norms) travel back — two or three
        variable-size exchanges."""
        D, dev = self.n_devices, self.device
        empty_i = torch.zeros(0, dtype=torch.int64, device=dev)
        empty_f = torch.zeros(0, dtype=torch.float64, device=dev)
        L = len(self._shards)
        reads = [[empty_i] * D for _ in range(L)]
        qstate = [[empty_i] * D for _ in range(L)]
        qnorm = [[empty_f] * D for _ in range(L)]
        bad = torch.zeros((), dtype=torch.int64, device=dev)

        def rank_in(keys, i):
            """Positions of ``keys`` among local shard row i's sorted keys,
            and which of them are there."""
            ip = torch.searchsorted(akey[i], keys).clamp_(0, max(
                akey[i].shape[0] - 1, 0))
            return ip, akey[i][ip] == keys

        if self.group is None:
            for d in range(D):
                for p in range(D):
                    ub = uniq[d][p]
                    if ub is None:
                        continue
                    ip, ok = rank_in(ub, p)
                    bad += (~ok).sum()
                    reads[p][d] = ip[ok]
                    qstate[d][p] = ub[ok]
                    qnorm[d][p] = self._norms[p][ip[ok]]
            return reads, qstate, qnorm, bad
        asked = self.group.exchange_lists(
            [empty_i if u is None else u for u in uniq[0]])
        oks, norms = [], []
        for q, ub in enumerate(asked):
            ip, ok = rank_in(ub, 0)
            bad += (~ok).sum()
            reads[0][q] = ip[ok]
            oks.append(ok)
            norms.append(self._norms[0][ip[ok]] if compact else empty_f)
        oks = self.group.exchange_lists(oks)
        if compact:
            norms = self.group.exchange_lists(norms)
        for p in range(D):
            if uniq[0][p] is not None:
                qstate[0][p] = uniq[0][p][oks[p]]
                if compact:
                    qnorm[0][p] = norms[p]
        return reads, qstate, qnorm, bad

    def _plan_stream(self, compact: bool) -> None:
        """The two-pass routing-plan build of the JAX engine (ELL and
        compact), bit for bit, on the device over row chunks.

        Pass 1 walks each shard's row chunks keeping per-row nnz counts and
        each peer's UNIQUE remote target states (deduplicated: entries
        reading the same remote x share one exchange slot), and checks the
        local targets; pass 1b (:meth:`_resolve_targets`) resolves the
        unique targets against each peer's rows into the query lists
        ``qin``; pass 2 packs each shard's entries into its tables — local
        index, or ``M + p·C + slot`` for a remote one — with the stable
        left-pack and the two-level split.  On ranks the nnz histogram, the
        query capacity, the tail height and the failure counts are agreed
        over the group.

        States are searched and sorted as ``σ ^ 2⁶³``: int64 order of those
        keys is the unsigned order of the states (the JAX engine's host
        NumPy sorts u64), so positions and unique lists match it."""
        from .engine import choose_ell_split

        D, M, T = self.n_devices, self.shard_size, self.num_terms
        L = len(self._shards)
        dev = self.device
        Bc = min(M, max(self.batch_size, 8))
        flip = -(1 << 63)
        # per shard held here: sorted search keys of its rows (SENTINEL
        # pads last)
        akey = self._alphas ^ flip                             # [L, M]

        def rank(keys: torch.Tensor, sorted_keys: torch.Tensor):
            """``np.searchsorted`` (left), clipped to the last index."""
            ip = torch.searchsorted(sorted_keys, keys)
            return ip.clamp_(0, max(sorted_keys.shape[0] - 1, 0))

        # -- pass 1: row-nnz counts, per-peer unique remote targets, local
        #    sector check
        nnz = torch.zeros((L, M), dtype=torch.int64, device=dev)
        uniq = [[None] * D for _ in range(L)]     # flipped keys, sorted
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        for i, d in enumerate(self._shards):
            pend = [[] for _ in range(D)]
            for s, e, n_c, betas, cf, nz in self._structure_chunks(i, Bc):
                nnz[i, s:e] = nz.sum(dim=1)[: e - s]
                flat_b = betas[nz]
                owner = shard_index(flat_b, D)
                lk = flat_b[owner == d] ^ flip
                bad += (akey[i][rank(lk, akey[i])] != lk).sum()
                for p in range(D):
                    if p != d:
                        pend[p].append(torch.unique(flat_b[owner == p]
                                                    ^ flip))
            for p in range(D):
                if p != d and pend[p]:
                    uniq[i][p] = torch.unique(torch.cat(pend[p]))
            del pend

        # -- pass 1b: resolve unique targets against each peer's rows
        reads, qstate, qnorm, bad1 = self._resolve_targets(uniq, akey,
                                                           compact)
        del uniq
        n_bad = self._agree(bad + bad1)[0]
        if n_bad:
            raise RuntimeError(f"{n_bad} {_OUT_OF_BASIS}")

        cap = self._agree(max(q.numel() for row in reads for q in row),
                          op="max")[0]
        hist = torch.bincount(nnz.reshape(-1), minlength=T + 1)
        if self.group is not None:
            hist = self.group.all_reduce(hist)
        T0, S, Tmax = choose_ell_split(hist.cpu().numpy(), D * M, T,
                                       real_rows=self.n_states)
        self._ell_T0 = T0
        self.ell_split = (T0, S, Tmax)
        Tw = Tmax - T0 if S else 0
        C = _round_up(cap, 8)
        self.query_capacity = C

        # qin[i, q] = the local indices peer q reads from shard row i
        # (0-padded)
        self._qin = torch.zeros((L, D, C), dtype=torch.int32, device=dev)
        for i, d in enumerate(self._shards):
            for q in range(D):
                if q != d:
                    ql = reads[i][q]
                    self._qin[i, q, : ql.numel()] = ql.to(torch.int32)
        del reads

        W = self._c_W if compact else 0.0
        cdtype = self._dtype
        S_max = self._agree(int((nnz > T0).sum(dim=1).max()) if S else 0,
                            op="max")[0]

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # -- pass 2: pack per-shard tables
        main, tails, n_all = [], [], []
        badw = torch.zeros((), dtype=torch.int64, device=dev)
        for i, d in enumerate(self._shards):
            g_main = None if compact else zeros((T0, M), torch.int32)
            v_main = zeros((T0, M), torch.int32 if compact else cdtype)
            rows_t = zeros(S_max, torch.int32)
            v_tail = zeros((Tw, S_max), torch.int32 if compact else cdtype)
            i_tail = None if compact else zeros((Tw, S_max), torch.int32)
            t_cursor = 0
            for s, e, n_c, betas, cf, nz in self._structure_chunks(i, Bc):
                flat_b = betas[nz]
                owner = shard_index(flat_b, D)
                gflat = torch.zeros(flat_b.shape, dtype=torch.int64,
                                    device=dev)
                nflat = torch.ones(flat_b.shape, dtype=torch.float64,
                                   device=dev)
                loc = owner == d
                ip = rank(flat_b[loc] ^ flip, akey[i])
                gflat[loc] = ip
                if compact:
                    nflat[loc] = self._norms[i][ip]
                for p in range(D):
                    if p == d:
                        continue
                    sel = owner == p
                    if not bool(sel.any()):
                        continue
                    pos = rank(flat_b[sel] ^ flip, qstate[i][p])
                    gflat[sel] = M + p * C + pos
                    if compact:
                        nflat[sel] = qnorm[i][p][pos]
                g = torch.zeros(betas.shape, dtype=torch.int64, device=dev)
                g[nz] = gflat
                cfz = torch.where(nz, cf, 0)
                if compact:
                    n_b = torch.ones(betas.shape, dtype=torch.float64,
                                     device=dev)
                    n_b[nz] = nflat
                    ratio = cfz.abs() * n_c[:, None] / n_b
                    badw += (nz & ((ratio - W).abs() > 1e-9 * W)).sum()
                # the stable left-pack: live entries first, in term order
                order = torch.argsort((~nz).to(torch.uint8), dim=1,
                                      stable=True)
                g_p = torch.where(nz, g, 0).gather(1, order)
                c_p = cfz.gather(1, order)
                r = e - s

                def pack(gg, cc):
                    if compact:
                        return torch.where(
                            cc != 0, torch.sign(cc).to(torch.int32)
                            * (gg.to(torch.int32) + 1), 0)
                    return cc

                if not compact:
                    g_main[:, s:e] = g_p[:r, :T0].T
                v_main[:, s:e] = pack(g_p[:r, :T0], c_p[:r, :T0]).T
                if S:
                    rd = torch.nonzero(nnz[i, s:e] > T0).reshape(-1)
                    k = rd.numel()
                    if k:
                        tsl = slice(t_cursor, t_cursor + k)
                        rows_t[tsl] = (s + rd).to(torch.int32)
                        if not compact:
                            i_tail[:, tsl] = g_p[rd, T0:Tmax].T
                        v_tail[:, tsl] = pack(g_p[rd, T0:Tmax],
                                              c_p[rd, T0:Tmax]).T
                        t_cursor += k
            main.append((v_main, g_main))
            if S:
                tails.append((rows_t, i_tail, v_tail))
            if compact:
                n_all_d = torch.ones(M + D * C if D > 1 else M,
                                     dtype=torch.float64, device=dev)
                n_all_d[:M] = self._norms[i]
                for p in range(D):
                    qn = qnorm[i][p]
                    if p != d and qn.numel():
                        n_all_d[M + p * C: M + p * C + qn.numel()] = qn
                n_all.append(n_all_d)
        n_badw = self._agree(badw)[0]
        if n_badw:
            raise RuntimeError(
                f"{n_badw} matrix elements violate the ±W·n(j)/n(i) form "
                f"(W={W}); the operator does not qualify for compact mode "
                "— use mode='ell'")

        if compact:
            self._c_idx = torch.stack([m[0] for m in main])   # [L, T0, M]
            self._c_tail = None
            if S:
                self._c_tail = (torch.stack([t[0] for t in tails]),
                                torch.stack([t[2] for t in tails]))
            self._c_norms = torch.stack(n_all)                 # [L, M+DC]
            self._c_inv_n = torch.reciprocal(self._norms)      # [L, M]
        else:
            self._ell_coeff = torch.stack([m[0] for m in main])
            self._ell_idx = torch.stack([m[1] for m in main])
            self._ell_tail = None
            if S:
                self._ell_tail = tuple(torch.stack([t[i] for t in tails])
                                       for i in range(3))

    def _exchange_x(self, x: torch.Tensor) -> torch.Tensor:
        """The routing plan's exchange: ``[L, M, R]`` → ``[L, R, M + D·C]``
        (``[x; R]`` per shard held here, columns first: state axis last).
        At D = 1 there is nothing to receive."""
        D, C, L = self.n_devices, self.query_capacity, len(self._shards)
        if D == 1:
            return x.transpose(1, 2)
        send = torch.stack([x[s][self._qin[s].long()] for s in range(L)])
        recv = self._exchange(send)                      # [L, D, C, R]
        xx = torch.cat([x, recv.reshape(L, D * C, -1)], dim=1)
        return xx.transpose(1, 2)

    def _apply_ell(self, x: torch.Tensor) -> torch.Tensor:
        """Per shard: ``y = diag·x``, then term by term ``y += coeff[t]·
        xx[idx[t]]`` over ``xx = [x; R]``, then the tail's rows
        (``index_add_``: the pad entries add 0 to row 0).  ``x`` is
        ``[L, M, R]`` (L the shards held here); the terms gather along the
        state axis of ``[R, ·]`` (columns first)."""
        from .engine import ell_terms

        D, M, R = x.shape
        T0 = self._ell_T0
        xx = self._exchange_x(x)
        y = torch.empty((D, R, M), dtype=self._dtype, device=self.device)
        for d in range(D):
            xd = xx[d].contiguous()                          # [R, M + DC]
            yd = ell_terms(self._diag[d].to(self._dtype) * xd[:, :M], xd,
                           self._ell_idx[d, :T0], self._ell_coeff[d, :T0])
            if self._ell_tail is not None:
                rows, idx_t, cf_t = (a[d] for a in self._ell_tail)
                acc = ell_terms(torch.zeros((R, rows.shape[0]),
                                            dtype=self._dtype,
                                            device=self.device),
                                xd, idx_t, cf_t)
                yd.index_add_(1, rows, acc)
            y[d] = yd
        return y.transpose(1, 2)

    def _apply_compact(self, x: torch.Tensor) -> torch.Tensor:
        """Per shard: sign-tagged gathers ``acc = Σ_t s·n(j)·xx(j)``, then
        ``y = diag·x + W/n(i)·acc``, and the tail's rows alike."""
        from .engine import compact_terms

        D, M, R = x.shape
        T0, W = self._ell_T0, self._c_W
        xx = self._exchange_x(x)
        y = torch.empty((D, R, M), dtype=torch.float64, device=self.device)
        for d in range(D):
            xd = xx[d].contiguous()
            n_all = self._c_norms[d]
            acc = compact_terms(
                torch.zeros((R, M), dtype=torch.float64, device=self.device),
                self._c_idx[d, :T0], xd, n_all)
            sc = W * self._c_inv_n[d]
            yd = self._diag[d] * xd[:, :M] + sc * acc
            if self._c_tail is not None:
                rows, tags = (a[d] for a in self._c_tail)
                acc_t = compact_terms(
                    torch.zeros((R, rows.shape[0]), dtype=torch.float64,
                                device=self.device), tags, xd, n_all)
                yd.index_add_(1, rows, sc[rows.long()] * acc_t)
            y[d] = yd
        return y.transpose(1, 2)

    def memory_arrays(self) -> Dict[str, object]:
        """Every resident tensor group by ledger name (the JAX engine's
        names; fused, streamed and hybrid engines carry the per-shard
        lookup instead of structure tables)."""
        out = {"operator_tables": self.tables,
               "basis_rows": (self._alphas, self._norms),
               "diag": self._diag}
        if self.mode in ("fused", "streamed", "hybrid"):
            out["lookup"] = (self._lk_pair, self._lk_dir)
        for name, arrs in self.structure_arrays().items():
            out[f"structure/{name}"] = arrs
        return out

    def structure_arrays(self) -> Dict[str, torch.Tensor]:
        """The precomputed plan tensors by name, each ``[L, …]`` over the
        shards held here (``[1, …]`` on a rank; empty in streamed and fused
        mode): ``idx``, ``coeff``, ``qin`` and the
        tail's ``tail_rows``/``tail_idx``/``tail_coeff`` in ell mode;
        ``idx`` (sign tags), ``qin``, ``inv_n``, ``norms_all`` and the
        tail's ``tail_rows``/``tail_idx`` in compact mode."""
        if self.mode == "ell":
            out = {"idx": self._ell_idx, "coeff": self._ell_coeff,
                   "qin": self._qin}
            if self._ell_tail is not None:
                rows, t_idx, t_cf = self._ell_tail
                out.update(tail_rows=rows, tail_idx=t_idx, tail_coeff=t_cf)
            return out
        if self.mode == "compact":
            out = {"idx": self._c_idx, "qin": self._qin,
                   "inv_n": self._c_inv_n, "norms_all": self._c_norms}
            if self._c_tail is not None:
                rows, t_idx = self._c_tail
                out.update(tail_rows=rows, tail_idx=t_idx)
            return out
        return {}

    @property
    def ell_nbytes(self) -> int:
        """Device memory held by the precomputed plan (0 in streamed and
        fused mode): the summed bytes of :meth:`structure_arrays`."""
        return sum(a.numel() * a.element_size()
                   for a in self.structure_arrays().values())

    # -- apply -----------------------------------------------------------------

    def matvec(self, xh: torch.Tensor, check: Optional[bool] = None
               ) -> torch.Tensor:
        """y = H·x in the hashed layout: ``[D, M]`` or a block of R columns
        ``[D, M, R]`` on the engine's device, float64 (complex128 in a
        complex sector; a real tensor is promoted there).  On a rank
        engine ``x`` is this rank's row, ``[1, M]`` or ``[1, M, R]``, and
        every rank applies together.

        In fused mode the first apply of each row-chunk size (or
        ``check=True``) checks the overflow and out-of-basis counters and
        raises if an amplitude was lost; ``check=False`` skips it.  The
        other modes checked them at build time.  Streamed mode applies a
        block of R > 4 columns in column groups of 4.

        A re-tune the live tuner proposed lands here, before any of the
        apply's work.  With the obs layer on the apply is recorded
        (``matvec_apply``; with ``phases`` on also ``apply_phases``, after
        one synchronization at the apply's end on the card)."""
        D, M = len(self._shards), self.shard_size
        if not self.real and xh.dtype == torch.float64:
            xh = xh.to(self._dtype)
        if (tuple(xh.shape[:2]) != (D, M) or xh.dim() not in (2, 3)
                or xh.dtype != self._dtype or xh.device != self.device):
            raise ValueError(
                f"matvec takes a {self._dtype} [{D}, {M}] or "
                f"[{D}, {M}, R] tensor on {self.device}, got {xh.dtype} "
                f"{tuple(xh.shape)} on {xh.device}")
        if self._retune_pending is not None:
            # the safe boundary: no device work of this apply is queued
            self.maybe_retune()
        note_applying(self)
        # chaos site for the exchange: fires BEFORE any device work, so an
        # injected "failed collective" leaves the engine state intact and
        # the next apply runs clean (every rank armed alike raises alike)
        faults.check("exchange", exc=RuntimeError, engine="distributed")
        try:
            if not obs_enabled():
                return self._matvec_body(xh, check)
            idx = self._apply_idx
            self._apply_idx += 1
            with obs_trace.span("apply", kind="apply", engine="distributed",
                                mode=self.mode, apply=idx), \
                    obs_profile.sample_window("distributed", idx,
                                              mode=self.mode):
                return self._matvec_observed(xh, check, idx)
        except Exception as e:
            oom_reraise(e, engine="distributed", mode=self.mode,
                        phase="apply", n_states=int(self.n_states))

    def _matvec_observed(self, xh: torch.Tensor, check: Optional[bool],
                         idx: int) -> torch.Tensor:
        """:meth:`_matvec_body` with its telemetry (JAX ``_matvec_inner``'s
        tail): ``matvec_apply`` with this process's exchange bytes, the
        ``exchange_bytes`` counter and ``matvec_apply_ms`` histogram, and
        with phases on one ``apply_phases`` event — the structural counts
        of :meth:`_phase_counts`, the wall over the apply to its end on the
        device, and for streamed applies the per-chunk timeline and the
        measured ``plan_h2d`` wall (and a pipelined apply's overlap
        split); then the live tuner's observation."""
        phases = obs_phases.phases_enabled()
        streamed = self.mode in ("streamed", "hybrid")
        self._timeline = [] if (phases and streamed) else None
        t0 = time.perf_counter()
        try:
            with self.timer.scope("matvec"):
                y = self._matvec_body(xh, check)
            self._health(xh, y, idx)
            if phases and self.device.type == "cuda":
                # the apply's one synchronization: the wall covers its
                # device work, and the timeline's events are complete
                torch.cuda.current_stream(self.device).synchronize()
            timeline = self._timeline
        finally:
            self._timeline = None
        dt_ms = (time.perf_counter() - t0) * 1e3
        cols = int(xh.shape[2]) if xh.dim() == 3 else 1
        nbytes = self._exchange_nbytes_tail(cols)
        counter("exchange_bytes", engine="distributed").inc(nbytes)
        emit("matvec_apply", engine="distributed", apply=idx,
             wall_ms=round(dt_ms, 4), bytes=nbytes)
        if phases:
            self._emit_phases(idx, dt_ms, cols, timeline)
        histogram("matvec_apply_ms", engine="distributed").observe(dt_ms)
        return y

    def _health(self, xh: torch.Tensor, y: torch.Tensor, idx: int) -> None:
        """The apply's health and memory tail (JAX ``_matvec_inner``):
        drain the probes earlier applies queued, queue this apply's
        exchange counters (the chunked modes), and every
        ``health_every``-th apply the output probe and, on an
        ``f32``/``bf16`` streamed engine, a compress-drift sample; every
        ``memory_every``-th apply a watermark.  Nothing here waits on the
        device."""
        obs_health.drain()
        if self.mode == "fused":
            obs_health.defer_exchange_counters("distributed", idx,
                                               *self._last_counters)
        elif self.mode in ("streamed", "hybrid"):
            # structural, validated zero at build: the series stays
            # visible (zero being the healthy reading), as in fused mode
            obs_health.defer_exchange_counters("distributed", idx, 0, 0)
        if obs_health.probe_due(idx):
            obs_health.probe_apply("distributed", y, idx)
            if self.mode in ("streamed", "hybrid") \
                    and self.stream_compress in ("f32", "bf16"):
                self._probe_compress_drift(xh, idx)
        if obs_memory.watermark_due(idx):
            obs_memory.sample_watermark("apply/distributed", apply=idx)

    # -- lossy-tier numerical-drift probe ----------------------------------

    #: the probe chunk: the drift sample is a 1-in-N subsample by
    #: construction (one chunk's live plan entries, probe-cadence applies)
    _DRIFT_CHUNK = 0

    def _drift_probe_state(self):
        """Lazy state of the compress-drift probe: the probe chunk's x-row
        indices, EXACT (lossless-path) coefficients and quantization deltas
        on the device, for the first shard held here.  None when the probe
        does not apply — not a quantized tier, a complex sector, or raw
        (non-dictionary) coefficients, whose exact values are not kept."""
        st = self._drift_state
        if st is not None:
            return st or None        # False: checked, unavailable
        self._drift_state = False
        spec = self._codec.spec
        if spec["tier"] not in ("f32", "bf16") or spec["ckind"] != "real" \
                or spec["coeff"] != "dict":
            return None
        try:
            d = self._shards[0]
            per = self.plan_chunk(self._DRIFT_CHUNK, d)
            dec = self._codec.decode_chunk_host(per, d)
            codes = np.asarray(per["coeff"], np.int64)
            exact = np.asarray(self._codec.dicts[d])[codes].real.astype(
                np.float64)
            live = np.asarray(dec["dest"]) < int(spec["n_recv"])
            exact = np.where(live, exact, 0.0)
            delta = PC._quantize(exact, spec["tier"]) - exact
            dev = self.device
            self._drift_state = {
                "rows": torch.from_numpy(np.asarray(
                    dec["row"], np.int64)).to(dev),
                "exact": torch.from_numpy(exact).to(dev),
                "delta": torch.from_numpy(delta).to(dev)}
        except Exception as e:       # a failed probe must not cost the run
            from ..utils.logging import log_warn
            log_warn(f"compress-drift probe disabled: {e!r}")
            return None
        return self._drift_state

    def _probe_compress_drift(self, xh: torch.Tensor, idx: int) -> None:
        """Queue one input-weighted drift sample of a quantized-tier apply:
        ‖Δc·x[rows]‖ / ‖c·x[rows]‖ over the probe chunk's live entries of
        the first shard held here, where Δc is the quantized-minus-exact
        coefficient — two reductions behind the apply, resolved deferred
        by the health layer (no synchronization)."""
        st = self._drift_probe_state()
        if st is None:
            return
        x = xh.reshape(len(self._shards), self.shard_size, -1)[0]  # [M, R]
        g = x[st["rows"]]                                          # [n, R]
        num = torch.linalg.vector_norm(st["delta"][:, None] * g)
        den = torch.linalg.vector_norm(st["exact"][:, None] * g)
        obs_health.defer_compress_drift("distributed", idx,
                                        self.stream_compress,
                                        self._DRIFT_CHUNK, num, den)

    def _emit_phases(self, idx: int, dt_ms: float, cols: int,
                     timeline: Optional[list]) -> None:
        """The ``apply_phases`` event of one apply (JAX
        ``_matvec_inner``), and the live tuner's observation of it."""
        measured = pipe = None
        if timeline:
            ev = self._tl_events
            for c in timeline:
                k = c.pop("_ev", None)
                if k is not None:
                    c0, c1, w = ev[k], ev[k + 1], ev[k + 2]
                    # exposed: how long the compute stream, arrived at its
                    # wait, still waited for the chunk's copy to end
                    c["stall_ms"] = round(max(w.elapsed_time(c1), 0.0), 4)
                    c["stage_ms"] = round(c0.elapsed_time(c1), 4)
            measured = {"plan_h2d": sum(c.get("stall_ms", 0.0)
                                        for c in timeline)}
        if self.pipeline_depth:
            # the measured overlap split of a pipelined apply: barrier =
            # plan staging the compute stream waited out, hidden = staging
            # that ran behind compute; the exchange waits at retire ride
            # as the measured exchange phase
            pipe = {"depth": int(self.pipeline_depth)}
            if timeline:
                barrier = sum(c.get("stall_ms", 0.0) for c in timeline)
                hidden = sum(max(c.get("stage_ms", 0.0)
                                 - c.get("stall_ms", 0.0), 0.0)
                             for c in timeline)
                measured["exchange"] = sum(c.get("exch_ms", 0.0)
                                           for c in timeline)
                pipe.update(
                    barrier_ms=barrier, hidden_ms=hidden,
                    overlap_fraction=(
                        max(0.0, min(1.0, hidden / (hidden + barrier)))
                        if hidden + barrier > 0 else None))
        counts = self._phase_counts(cols)
        obs_phases.emit_apply_phases(
            "distributed", self.mode, idx, dt_ms, counts,
            chunks=self._nchunks(), columns=cols, measured_ms=measured,
            chunk_timeline=timeline, pipeline=pipe)
        if self._tuner is not None:
            # window boundaries are deterministic in apply count, so every
            # rank joins the agreement round at the same apply
            prop = self._tuner.observe(counts, dt_ms, measured)
            if self._tuner.window_closed and self.group is not None:
                prop = self._agree_retune(prop)
            if prop is not None:
                self._retune_pending = prop

    def _matvec_body(self, xh: torch.Tensor, check: Optional[bool]
                     ) -> torch.Tensor:
        D, M = len(self._shards), self.shard_size
        self.n_applies += 1
        self.last_pipeline = None
        x = xh.reshape(D, M, -1)
        if self.mode in ("streamed", "hybrid"):
            if x.shape[2] <= 4:
                return self._apply(xh)
            # wide blocks in column groups of 4, each streaming the plan
            return torch.cat([self._apply(x[:, :, c:c + 4])
                              for c in range(0, x.shape[2], 4)],
                             dim=2).reshape(xh.shape)
        if self.mode == "ell":
            y = self._apply_ell(x)
        elif self.mode == "compact":
            y = self._apply_compact(x)
        else:
            y = self._matvec_fused(x, check)
        return y.reshape(xh.shape)

    def _matvec_fused(self, x: torch.Tensor, check: Optional[bool]):
        # wide blocks shrink the row chunk so a chunk's working set stays
        # near four columns' worth, as the JAX engine does
        R = x.shape[2]
        base = self.batch_size
        B = base if R <= 4 else min(base, _round_up(max(8, (4 * base) // R),
                                                    8))
        cap = self._capacity if B == base else self._fused_capacity(B)
        self._last_fused = (B, cap)
        y, overflow, invalid = self._apply_fused(x, B, cap)
        self._last_counters = (overflow, invalid)
        if check or (check is None and B not in self._checked):
            self._validate_counters(*self._agree(overflow, invalid), B, cap)
            self._checked.add(B)
        return y + self._diag.to(self._dtype)[:, :, None] * x

    # -- the cost model: phase counts, hybrid auto split, self-tuning ------

    def _nchunks(self) -> int:
        """Row chunks one apply runs through (1 for the single-program
        ell/compact plans; fused at its last apply's row chunk)."""
        if self.mode in ("streamed", "hybrid"):
            return self.nchunks
        if self.mode == "fused":
            B = self._last_fused[0] if self._last_fused else self.batch_size
            return -(-self.shard_size // max(int(B), 1))
        return 1

    def _group_order(self) -> int:
        """|G| for the orbit-scan pricing (1 when the basis needs no
        projection)."""
        if self.tables.group is None:
            return 1
        grp = getattr(self.operator.basis, "group", None)
        return max(len(grp), 1) if grp is not None else 1

    def _phase_counts(self, columns: int) -> dict:
        """Structural per-apply counts per phase (``obs/phases.py``), for
        the shards held here — the JAX engine's ``_phase_counts``, equal
        to its counts for the same operator, mode, D, row chunk and
        columns; cached per (mode, fused program, columns):

        * ``plan_h2d``   streamed mode's per-apply plan bytes (one full
          stream per ≤ 4-column group);
        * ``compute``    x gathers per structure entry (+ the send-side
          ``x[qin]`` gather in ell/compact; the orbit scan in fused); the
          hybrid split into ``compute_decode``/``compute_recompute``;
        * ``exchange``   :meth:`_exchange_nbytes_tail`'s send volume;
        * ``accumulate`` receive-side slots (fused and streamed) or the
          tail rows (ell/compact)."""
        key = (self.mode, self._last_fused, int(columns))
        got = self._phase_count_cache.get(key)
        if got is not None:
            return got
        D, M, T = self.n_devices, self.shard_size, self.num_terms
        nmy = len(self._shards)
        cplx = not self.real
        k = max(int(columns), 1)
        vb = 16 if cplx else 8            # one vector value
        fmul = 8 if cplx else 2           # multiply-add flops per column
        c = obs_phases.zero_counts()
        c["exchange"]["bytes"] = self._exchange_nbytes_tail(k)
        if self.mode in ("ell", "compact"):
            C = self.query_capacity
            tail = self._ell_tail if self.mode == "ell" else self._c_tail
            cfb = (16 if cplx else 8) if self.mode == "ell" else 4 + 8
            g_tail = int(tail[1].shape[1] * tail[1].shape[2]) if tail else 0
            rows_t = int(tail[0].shape[1]) if tail else 0
            g = nmy * (self._ell_T0 * M + g_tail + D * C)
            c["compute"] = {"bytes": g * (vb * k + cfb), "gathers": g,
                            "flops": g * k * fmul}
            c["accumulate"] = {"bytes": nmy * rows_t * vb * k,
                               "gathers": nmy * rows_t,
                               "flops": nmy * rows_t * k * (2 if cplx else 1)}
        else:
            nch = self._nchunks()
            if self.mode in ("streamed", "hybrid"):
                # the codec sets the apply's geometry: trimmed exchange
                # capacity, and (compressed tiers) live entries only
                spec = self._codec.spec
                B = self.batch_size
                seg = nmy * nch * int(spec["n_recv"])
            else:
                B, Cap = self._last_fused or (self.batch_size,
                                              self._capacity)
                seg = nmy * nch * D * Cap
            c["accumulate"] = {"bytes": seg * vb * k, "gathers": seg,
                               "flops": seg * k * (2 if cplx else 1)}
            ent = nmy * nch * B * T
            if self.mode in ("streamed", "hybrid"):
                if spec["tier"] != "off":
                    ent = nmy * nch * int(spec["n_live"])
                ngroups = -(-k // 4) if k > 4 else 1
                c["plan_h2d"]["bytes"] = int(self.plan_bytes) * ngroups
                if self.mode == "hybrid":
                    n_rec = int((~self._hybrid_mask).sum())
                    ent_r = nmy * nch * B * n_rec
                    G = self._group_order()
                    c["compute_decode"] = {"bytes": ent * vb * k,
                                           "gathers": ent,
                                           "flops": ent * k * fmul}
                    c["compute_recompute"] = {
                        "bytes": ent_r * vb * k, "gathers": 0,
                        "flops": ent_r * (k * fmul
                                          + G * obs_phases.ORBIT_OPS)}
                else:
                    c["compute"] = {"bytes": ent * vb * k, "gathers": 0,
                                    "flops": ent * k * fmul}
            else:
                grp = getattr(self.operator.basis, "group", None)
                G = max(len(grp), 1) if grp is not None else 1
                c["compute"] = {"bytes": ent * vb * k, "gathers": ent,
                                "flops": ent * (k * fmul
                                                + G * obs_phases.ORBIT_OPS)}
        self._phase_count_cache[key] = c
        return c

    def _exchange_nbytes_tail(self, columns: int) -> int:
        """This process's ``all_to_all`` send volume for one apply of
        ``columns`` columns (JAX ``_exchange_nbytes_tail``): the padded
        ``[D, C]`` query payload per shard in ell/compact, the trimmed
        amplitude buckets per chunk in streamed/hybrid, the
        fixed-capacity state + amplitude buckets per chunk in fused."""
        D = self.n_devices
        if D <= 1:
            return 0
        nmy = len(self._shards)
        if self.mode in ("ell", "compact"):
            return nmy * D * self.query_capacity * columns * 8
        if self.mode in ("streamed", "hybrid"):
            item = 16 if not self.real else 8
            cap = int(self._codec.spec["cap_eff"])
            return nmy * self.nchunks * D * cap * columns * item
        B, cap = self._last_fused or (self.batch_size, self._capacity)
        nchunks = -(-self.shard_size // max(B, 1))
        return nmy * nchunks * D * cap * (8 + columns * 8)

    def _auto_hybrid_mask(self, raw) -> np.ndarray:
        """The ``hybrid_split="auto"`` mask (JAX ``_hybrid_census`` and
        ``_resolve_hybrid_mask``): the per-term live-entry census of the
        raw plan, summed over chunks, shards and ranks (so every rank
        prices, and splits, alike), priced by
        :func:`~..obs.roofline.choose_hybrid_split` at the plan's bytes per
        live entry under the tuner's rates or the device's
        calibration."""
        from ..obs import roofline as _roofline

        T = self.num_terms
        ckind = "real" if self.real else "complex"
        lim = self.n_devices * self._capacity
        counts = np.zeros(T, np.int64)
        rows = 0
        for per in raw:
            for pc in per.values():
                flat = PC._canonical(pc["coeff"], ckind)
                dest = np.asarray(pc["dest"], np.int64).reshape(-1)
                live = (flat != 0) & (dest < lim)
                counts += live.reshape(-1, T).sum(axis=0)
                rows += self.batch_size
        if self.group is not None:
            tot = self.group.all_reduce(torch.from_numpy(
                np.concatenate([counts, [rows]]).astype(np.int64)).to(
                    self.device)).cpu().numpy()
            counts, rows = tot[:T], int(tot[T])
        cal = self._tune_cal or _roofline.resolve_calibration(
            device=self.device)
        self._hybrid_cal = cal
        # modeled encoded bytes of one live streamed entry: the bitpacked
        # (dest, row) pair plus the tier's coefficient bytes (a u16 code
        # for lossless); the shared ridx/rok layout streams regardless
        w = PC.bits_for(self.n_devices * self._capacity) \
            + PC.bits_for(max(self.batch_size - 1, 1))
        ncomp = 1 if self.real else 2
        coeff_b = {"lossless": 2.0, "f32": 4.0 * ncomp,
                   "bf16": 2.0 * ncomp}.get(self._codec_tier, 2.0)
        mask = _roofline.choose_hybrid_split(
            counts, rows, self._group_order(), cal, w / 8.0 + coeff_b,
            cplx=not self.real)
        return np.asarray(mask, bool)

    @property
    def hybrid_split(self) -> Optional[str]:
        """The hybrid engine's split as a ``stream:<t,t,…>`` token of its
        resolved mask (None outside hybrid mode) — the hand-set twin of an
        ``"auto"`` split."""
        if self._hybrid_mask is None:
            return None
        return "stream:" + ",".join(
            str(int(t)) for t in np.nonzero(self._hybrid_mask)[0])

    def _tune_stats(self) -> dict:
        """The structure geometry the autotuner prices from (JAX
        ``_tune_stats``): engine facts only, no rates."""
        from ..utils.artifacts import artifacts_enabled

        cfg = get_config()
        return {"shard_size": int(self.shard_size),
                "num_terms": int(self.num_terms),
                "n_my_shards": len(self._shards),
                "n_devices": int(self.n_devices),
                "pair": False,
                "cplx": not self.real,
                "columns": 1,
                "group_order": int(self._group_order()),
                "ram_budget_bytes": float(cfg.stream_plan_ram_gb) * 1e9,
                "disk_available": bool(artifacts_enabled())}

    def _init_autotune(self, batch_size_arg, pipeline_arg, hybrid_arg,
                       compress_arg) -> Optional[str]:
        """``tune=static|live`` build hook (JAX ``_init_autotune``):
        restore or run the knob search under the device's calibration (a
        learned posterior first under ``live``), agree the answer over the
        ranks, and fold the chosen knobs into the build before any plan
        exists — the plan is then built at the tuned knobs exactly as a
        hand-set engine's.  Returns the tuned hybrid split (None when the
        caller's or the config's wins)."""
        from .. import tune as _tune
        from ..obs import roofline as _roofline

        plat, kind = _roofline.device_identity(self.device)
        prior = None
        if self._tune_mode == "live":
            prior = _tune.load_posterior(plat, kind, self.mode)
        if prior is None:
            prior = _roofline.resolve_calibration(device=self.device)
        prior = dict(prior)
        prior.setdefault("device_kind", kind)
        stats = self._tune_stats()
        fp = _tune.tuning_fingerprint(stats, prior, self.mode)
        chosen = _tune.load_tuned(fp)
        search_s = 0.0
        if chosen is None:
            chosen, search_s = _tune.timed_choose(stats, prior, self.mode)
            _tune.save_tuned(fp, chosen, stats, prior, search_s)
        chosen = _tune.agree_config(chosen, self.group)
        self._tuned = chosen
        self._tune_cal = prior
        self.tune_search_s = search_s
        split = self._apply_tuned_knobs(chosen, batch_size_arg, pipeline_arg,
                                        hybrid_arg, compress_arg)
        if self._tune_mode == "live":
            self._tuner = _tune.LiveTuner(self.mode, stats, prior, chosen)
        obs_phases.emit_tune_config(
            "distributed", self.mode, chosen.knobs(), chosen.token(),
            chosen.priced_ms, chosen.source, search_s, fp)
        return split

    def _check_tuned(self, t) -> None:
        """A tuned config the port cannot build raises rather than build
        something else: the disk plan tier, and more prefetch workers than
        the RAM plan's H2D ring has chunks in flight (``max(1, depth)``),
        wait for the persistence slice's prefetcher."""
        if t.plan_tier != "ram":
            raise NotImplementedError(
                f"the autotuner picked the {t.plan_tier!r} plan tier "
                f"({t.token()}): the port keeps the streamed plan in "
                "pinned host memory; the disk tier comes with the "
                "persistence slice — raise stream_plan_ram_gb or pass "
                "explicit knobs")
        if int(t.prefetch_workers) > max(1, int(t.pipeline_depth)):
            raise NotImplementedError(
                f"the autotuner picked {t.prefetch_workers} prefetch "
                f"workers at depth {t.pipeline_depth} ({t.token()}): the "
                "port's RAM plan stages through one copy stream with at "
                "most max(1, depth) chunks in flight; threaded prefetch "
                "comes with the persistence slice")

    def _apply_tuned_knobs(self, t, batch_size_arg, pipeline_arg,
                           hybrid_arg, compress_arg) -> Optional[str]:
        """Fold a :class:`~..tune.TunedConfig` into the build with the
        JAX precedence: an explicit constructor argument always wins; a
        config knob moved off its default (env var or ``update_config``)
        is a hand pin and wins; the tuned value fills everything else.
        Returns the tuned hybrid split, or None."""
        import dataclasses as _dc

        self._check_tuned(t)
        cfg = get_config()
        defaults = {f.name: f.default for f in _dc.fields(type(cfg))}
        M = self.shard_size
        if batch_size_arg is None \
                and cfg.matvec_batch_size == defaults["matvec_batch_size"]:
            self.batch_size = _round_up(min(int(t.batch_size), M), 8)
        if pipeline_arg is None \
                and str(cfg.pipeline) == str(defaults["pipeline"]):
            self._pipeline_req = int(t.pipeline_depth)
        if compress_arg is None and str(cfg.stream_compress) \
                == str(defaults["stream_compress"]):
            self._set_compress(t.stream_compress)
        if hybrid_arg is None and str(cfg.hybrid) == str(defaults["hybrid"]) \
                and t.hybrid_split != "-":
            return t.hybrid_split
        return None

    def _set_compress(self, tier: str) -> None:
        """The streamed tier, and the tier the plan encodes at (hybrid
        maps ``off`` to ``lossless``)."""
        self.stream_compress = tier
        self._codec_tier = "lossless" if (
            self.mode == "hybrid" and tier == "off") else tier

    def _agree_retune(self, prop):
        """One window-boundary round over the ranks (JAX
        ``_agree_retune``): every rank reaches it at the same apply, and
        the first proposing rank's config is adopted by all — or the
        re-tune is dropped everywhere."""
        from ..tune.space import TunedConfig

        enc = prop.encode() if prop is not None else [0] * 6
        vec = torch.tensor([1 if prop is not None else 0] + enc,
                           dtype=torch.int64, device=self.device)
        rows = self.group.all_gather(vec).cpu().numpy()
        have = rows[:, 0] == 1
        if not have.any():
            return None
        r = int(np.argmax(have))
        return TunedConfig.decode(
            rows[r, 1:], self.mode,
            priced_ms=prop.priced_ms if prop is not None else 0.0,
            source="retune")

    def maybe_retune(self) -> bool:
        """Apply a pending drift-triggered re-tune now — at a safe
        boundary only (callers: the top of :meth:`matvec`, and the serve
        pool between jobs; on ranks every rank together).  The plan is
        rebuilt at the new knobs exactly as a fresh build at those knobs
        would be, never mid-apply; a streamed re-tune that keeps the row
        chunk and the tier keeps its plan (the depth is a schedule, not a
        plan, knob).  Returns True when the knobs changed."""
        prop = self._retune_pending
        if prop is None or self.mode not in ("streamed", "hybrid"):
            return False
        self._retune_pending = None
        self._check_tuned(prop)
        old = self._tuned
        ratio = (self._tuner.last_ratio
                 if self._tuner is not None else 0.0) or 0.0
        t0 = time.perf_counter()
        self._tuned = prop
        B = _round_up(min(int(prop.batch_size), self.shard_size), 8)
        rebuild = (self.mode == "hybrid" or B != self.batch_size
                   or prop.stream_compress != self.stream_compress)
        self.batch_size = B
        self._pipeline_req = int(prop.pipeline_depth)
        self._set_compress(prop.stream_compress)
        if self.mode == "hybrid":
            if self._tuner is not None:
                # re-key the auto split at the posterior's rates
                self._tune_cal = self._tuner.posterior.rates()
            if self._hybrid_split_arg is None and prop.hybrid_split != "-":
                self._hybrid_split = prop.hybrid_split
            self._hybrid_mask = _static_hybrid_mask(self._hybrid_split,
                                                    self.num_terms)
        if rebuild:
            self._build_streamed()
            self._register_plan_memory()
        self.pipeline_depth = self._pipeline_req
        if self._tuner is not None:
            self._tuner.note_rebuild(prop)
        obs_phases.emit_retune(
            "distributed", self.mode, self._apply_idx,
            old.token() if old is not None else "-", prop.token(),
            ratio, prop.priced_ms, time.perf_counter() - t0)
        return True

    def __call__(self, xh):
        return self.matvec(xh)

    # -- layouts ---------------------------------------------------------------

    def to_hashed(self, x) -> torch.Tensor:
        """Block (global sorted) [N] or [N, R] → hashed [D, M] or
        [D, M, R] on the device, in the engine's dtype (complex input
        stays complex); on a rank engine, this rank's row ``[1, M, …]``."""
        x = np.asarray(x)
        dt = np.complex128 if (np.iscomplexobj(x) or not self.real) \
            else np.float64
        xh = self.layout.to_hashed(x.astype(dt, copy=False), fill=0)
        if self.group is not None:
            xh = xh[self._shards]
        return torch.from_numpy(xh).to(self.device)

    def from_hashed(self, xh: torch.Tensor) -> np.ndarray:
        """Hashed [D, M] or [D, M, R] → block [N] or [N, R] NumPy.  On a
        rank engine ``xh`` is this rank's row and the rows are all-gathered
        (a collective: every rank calls it)."""
        if self.group is not None:
            xh = self.group.all_gather(xh.reshape(xh.shape[1:]))
        return self.layout.from_hashed(xh.detach().cpu().numpy())

    def matvec_global(self, x) -> np.ndarray:
        """Block-layout in/out convenience: shuffle → matvec → unshuffle."""
        return self.from_hashed(self.matvec(self.to_hashed(x)))

    def random_hashed(self, seed: int = 0,
                      cols: Optional[int] = None) -> torch.Tensor:
        """A normalized random vector in hashed layout (pads zero) — or,
        with ``cols``, a ``[D, M, cols]`` block of per-column-normalized
        vectors — seeded per shard as the JAX engine seeds it
        (``SeedSequence((seed, d))``, draws of shape ``(count_d, cols)``).
        Real in every sector, as the JAX engine's (native-complex) draws
        are.  A rank draws its own shard's row, the same draws as the
        one-process engine's row, and normalizes by the all-reduced
        norm."""
        M = self.shard_size
        tail = (cols,) if cols else ()
        x = np.zeros((len(self._shards), M) + tail)
        for i, d in enumerate(self._shards):
            rng = np.random.default_rng(np.random.SeedSequence((seed, d)))
            c = int(self.counts[d])
            x[i, :c] = rng.standard_normal((c,) + tail)
        xh = torch.from_numpy(x).to(self.device)
        if self.group is not None:
            sq = torch.sum(xh * xh, dim=(0, 1), keepdim=cols is not None)
            return xh / torch.sqrt(self.group.all_reduce(sq))
        if cols is None:
            return xh / torch.linalg.vector_norm(xh)
        return xh / torch.linalg.vector_norm(xh, dim=(0, 1), keepdim=True)

    def dot(self, ah: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
        """⟨a, b⟩ over hashed vectors or blocks (``a`` conjugated; pad
        slots are zero by invariant), as a 0-d tensor; summed over the
        ranks on a rank engine."""
        if ah.dtype != bh.dtype:
            dt = torch.promote_types(ah.dtype, bh.dtype)
            ah, bh = ah.to(dt), bh.to(dt)
        return self.reduce_sum(torch.vdot(ah.reshape(-1), bh.reshape(-1)))
