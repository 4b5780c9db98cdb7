# Ported from distributed_matvec_tpu/tune/space.py.
"""The autotuner's knob space and analytic pricing model.

Every knob the streamed/hybrid apply path exposes — row-chunk size,
pipeline depth, stream-compress tier, hybrid split policy, prefetch
worker count, and the RAM/disk plan-tier split — collected into one
:class:`TunedConfig`, plus the cross-product enumerator
(:func:`knob_grid`) and the pricer (:func:`price_config`) that turns a
candidate into an estimated ms/apply through the SAME
``obs/roofline.py`` bounds the phase-attribution report uses.

The search space is deliberately restricted to **bit-identity-preserving
choices**: compress tiers ``off``/``lossless`` only (both decode
value-exact — the quantized f32/bf16 tiers are never auto-selected),
pipeline depths whose accumulation order is unchanged (pipelined applies
retire in chunk order), and hybrid splits that are bit-identical to pure
streamed.  Whatever the tuner picks, the apply's numbers equal a
hand-set engine's with the same knobs bit for bit.

The count model here mirrors ``DistributedEngine._phase_counts``'s
streamed branch as a pure function of the knobs (the engine's counts are
exact for the plan it built; the tuner prices *before* any plan exists),
with the plan-bytes/live-entry constants shared with the capacity model
(``serve/capacity.py``) so both answer from one model.

The grid, the constants and the prices equal the JAX package's
``tune/space.py``: they are model constants, not measurements of any
device, and the CPU parity tests hold the search's answer to the JAX
one under the same rates.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Iterator, List, Optional

__all__ = [
    "TunedConfig",
    "BATCH_CANDIDATES",
    "DEPTH_CANDIDATES",
    "WORKER_CANDIDATES",
    "COMPRESS_CANDIDATES",
    "HYBRID_SPLIT_CANDIDATES",
    "LIVE_FRACTION",
    "PIPELINE_OVERHEAD_FRACTION",
    "DISK_PLAN_BYTES_PER_S",
    "plan_bytes_per_row",
    "knob_grid",
    "model_counts",
    "price_config",
]

#: Row-chunk sizes the search prices (clamped to the shard size and
#: deduplicated — a 12-site test sector collapses to the single-chunk
#: candidate).  The engine rounds to multiples of 8 exactly as a
#: hand-set ``matvec_batch_size`` would.
BATCH_CANDIDATES = (1 << 13, 1 << 14, 1 << 15, 1 << 16, 1 << 17)

#: Pipeline depths (0 = the sequential schedule; 2 = classic double
#: buffer; 4 = the deep plan-staging pipeline — the same ladder the
#: existing ``pipeline="auto"`` policy picks from, which this search
#: generalizes).
DEPTH_CANDIDATES = (0, 2, 4)

#: Prefetch worker counts for the pipelined plan stream (RAM tier; the
#: disk tier is pinned to 1 worker).
WORKER_CANDIDATES = (1, 2, 4)

#: Codec tiers the tuner may select: both value-exact (bit-identical
#: applies).  The quantized tiers (f32/bf16) trade numbers for bytes and
#: are an explicit operator decision, never an autotuner one.
COMPRESS_CANDIDATES = ("off", "lossless")

#: Hybrid split policies the search prices.  ``auto`` re-prices per term
#: off the live census at build time (the hybrid policy, fed the tuner's
#: posterior rates); the degenerate pins bracket it.  Explicit
#: ``stream:i,j,...`` lists are caller pins, never searched.
HYBRID_SPLIT_CANDIDATES = ("auto", "all-stream", "all-recompute")

#: Live-entry share of a compacted plan — the same documented model
#: constant as the capacity model's (about half the entries are live on
#: Heisenberg chains; an engine's measured census wins whenever present).
LIVE_FRACTION = 0.55

#: Pipeline bookkeeping cost as a share of the sequential bound (split
#: programs, prefetch threads, per-chunk dispatch): the JAX package's
#: model constant (its CPU rig's figure), kept so both packages price
#: alike; the live posterior corrects the total either way.
PIPELINE_OVERHEAD_FRACTION = 0.07

#: Modeled disk-tier chunk read-back rate (sequential h5py reads + CRC).
#: A documented model constant, not a hardware truth — the posterior's
#: measured plan_h2d walls correct it within a window either way.
DISK_PLAN_BYTES_PER_S = 1.5e9


def plan_bytes_per_row(num_terms: int, pair: bool, tier: str) -> float:
    """HOST bytes per padded basis row of the resolved plan at codec
    ``tier`` — the capacity model's ``stream_plan_bytes_per_row``
    model (dest index + coefficient per (row, term); receive layout
    folded into a flat overhead; compacted tiers store LIVE entries
    only, bitpacked, with dictionary coefficients)."""
    cf = 16 if pair else 8
    if tier in (None, "", "off"):
        return num_terms * (4 + cf) * 1.10
    return num_terms * (4.0 + 2.0) * LIVE_FRACTION * 1.08


@dataclass(frozen=True)
class TunedConfig:
    """One point of the knob cross-product, plus its price.

    The *knob* fields are the engine-facing values (constructor
    arguments / config fields they stand in for); ``priced_ms`` is the
    roofline estimate the search ranked it by, and ``source`` says where
    the config came from (``search`` | ``artifact`` | ``retune``).
    """

    mode: str = "streamed"
    batch_size: int = 1 << 16           # row-chunk size B
    pipeline_depth: int = 0             # 0 = sequential
    stream_compress: str = "off"        # off | lossless (value-exact only)
    hybrid_split: str = "auto"          # hybrid mode only; "-" otherwise
    prefetch_workers: int = 1           # pipelined plan staging threads
    plan_tier: str = "ram"              # ram | disk
    priced_ms: float = 0.0
    source: str = "search"

    def token(self) -> str:
        """Compact identity string (events, logs, equality in tests)."""
        return (f"B{self.batch_size}|pipe{self.pipeline_depth}"
                f"|c{self.stream_compress}|hyb[{self.hybrid_split}]"
                f"|w{self.prefetch_workers}|{self.plan_tier}")

    def knobs(self) -> dict:
        """The knob fields alone (no price/provenance) — what equality
        between a tuned and a hand-set engine is judged on."""
        return {"mode": self.mode, "batch_size": int(self.batch_size),
                "pipeline_depth": int(self.pipeline_depth),
                "stream_compress": self.stream_compress,
                "hybrid_split": self.hybrid_split,
                "prefetch_workers": int(self.prefetch_workers),
                "plan_tier": self.plan_tier}

    def same_knobs(self, other: Optional["TunedConfig"]) -> bool:
        return other is not None and self.knobs() == other.knobs()

    # -- fixed-width numeric encoding (cross-rank agreement) ------------

    _COMPRESS_CODE = {"off": 0, "lossless": 1}
    _SPLIT_CODE = {"-": 0, "auto": 1, "all-stream": 2, "all-recompute": 3}
    _TIER_CODE = {"ram": 0, "disk": 1}

    def encode(self) -> List[int]:
        """Fixed-width int vector for an all-gather round —
        every rank can adopt rank 0's row and decode the identical
        config (the agreement pattern of ``agree_restored``)."""
        return [int(self.batch_size), int(self.pipeline_depth),
                self._COMPRESS_CODE[self.stream_compress],
                self._SPLIT_CODE.get(self.hybrid_split, 1),
                int(self.prefetch_workers),
                self._TIER_CODE[self.plan_tier]]

    @classmethod
    def decode(cls, vec, mode: str, priced_ms: float = 0.0,
               source: str = "search") -> "TunedConfig":
        rev_c = {v: k for k, v in cls._COMPRESS_CODE.items()}
        rev_s = {v: k for k, v in cls._SPLIT_CODE.items()}
        rev_t = {v: k for k, v in cls._TIER_CODE.items()}
        return cls(mode=mode, batch_size=int(vec[0]),
                   pipeline_depth=int(vec[1]),
                   stream_compress=rev_c[int(vec[2])],
                   hybrid_split=rev_s[int(vec[3])],
                   prefetch_workers=int(vec[4]),
                   plan_tier=rev_t[int(vec[5])],
                   priced_ms=float(priced_ms), source=source)

    def to_dict(self) -> dict:
        return dict(self.knobs(), priced_ms=round(float(self.priced_ms), 6),
                    source=self.source)

    @classmethod
    def from_dict(cls, d: dict) -> "TunedConfig":
        return cls(mode=str(d.get("mode", "streamed")),
                   batch_size=int(d["batch_size"]),
                   pipeline_depth=int(d["pipeline_depth"]),
                   stream_compress=str(d["stream_compress"]),
                   hybrid_split=str(d.get("hybrid_split", "-")),
                   prefetch_workers=int(d.get("prefetch_workers", 1)),
                   plan_tier=str(d.get("plan_tier", "ram")),
                   priced_ms=float(d.get("priced_ms", 0.0)),
                   source=str(d.get("source", "artifact")))


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def knob_grid(stats: dict, mode: str) -> Iterator[TunedConfig]:
    """Enumerate the feasible knob cross-product for ``stats``.

    Candidates are canonicalized before yield (batch clamped to the
    shard size and rounded to 8 exactly as the engine would; depth
    clamped to the chunk count with degenerate depths resolving to 0;
    workers pinned to 1 when nothing is pipelined or the plan sits on
    the disk tier) and deduplicated — so two grid points that would
    build the identical engine are priced once, and the argmin is a
    canonical config."""
    M = int(stats["shard_size"])
    seen = set()
    batches = sorted({min(_round_up(min(b, M), 8), _round_up(M, 8))
                      for b in BATCH_CANDIDATES + (M,)})
    tiers = COMPRESS_CANDIDATES if mode == "streamed" else ("lossless",)
    splits = HYBRID_SPLIT_CANDIDATES if mode == "hybrid" else ("-",)
    for B in batches:
        nchunks = -(-M // B)
        for depth in DEPTH_CANDIDATES:
            d = min(depth, nchunks)
            if d < 2:
                d = 0
            for comp in tiers:
                for split in splits:
                    plan_b = (stats["n_my_shards"] * nchunks * B
                              * plan_bytes_per_row(
                                  int(stats["num_terms"]),
                                  bool(stats.get("pair")), comp))
                    plan_tiers = ["ram"]
                    if (plan_b > float(stats.get("ram_budget_bytes",
                                                 math.inf))
                            and stats.get("disk_available")):
                        plan_tiers = ["disk"]
                    elif stats.get("disk_available"):
                        plan_tiers = ["ram", "disk"]
                    for tier in plan_tiers:
                        workers = WORKER_CANDIDATES \
                            if (d >= 2 and tier == "ram") else (1,)
                        for w in workers:
                            cand = TunedConfig(
                                mode=mode, batch_size=B, pipeline_depth=d,
                                stream_compress=comp, hybrid_split=split,
                                prefetch_workers=min(w, max(d, 1)),
                                plan_tier=tier)
                            key = cand.token()
                            if key in seen:
                                continue
                            seen.add(key)
                            yield cand


def model_counts(stats: dict, cfg: TunedConfig) -> Dict[str, dict]:
    """Structural per-apply counts for one candidate — the pure-function
    mirror of ``DistributedEngine._phase_counts``'s streamed branch
    (same phase taxonomy, same byte/gather/flop charging), evaluated at
    the candidate's knobs instead of a built plan's geometry."""
    from ..obs import phases as obs_phases

    M = int(stats["shard_size"])
    T = int(stats["num_terms"])
    nmy = int(stats["n_my_shards"])
    B = int(cfg.batch_size)
    nch = -(-M // B)
    rows = nmy * nch * B
    cplx = bool(stats.get("cplx") or stats.get("pair"))
    k = max(int(stats.get("columns", 1)), 1)
    vb = 16 if cplx else 8
    fmul = 8 if cplx else 2
    c = obs_phases.zero_counts()
    # exchange: the capacity-factor-padded all_to_all send volume (the
    # engine's measured count wins when the stats carry one)
    xbytes = stats.get("exchange_bytes")
    if xbytes is None:
        xbytes = int(1.25 * rows * (8 + vb * k)) \
            if int(stats.get("n_devices", 1)) > 1 else 0
    c["exchange"]["bytes"] = int(xbytes)
    seg = int(1.25 * rows) if int(stats.get("n_devices", 1)) > 1 else rows
    c["accumulate"] = {"bytes": seg * vb * k, "gathers": seg,
                       "flops": seg * k * (2 if cplx else 1)}
    plan_b = int(rows * plan_bytes_per_row(T, bool(stats.get("pair")),
                                           cfg.stream_compress))
    ngroups = -(-k // 4) if k > 4 else 1
    ent = rows * T
    if cfg.stream_compress != "off" or cfg.mode == "hybrid":
        ent = int(ent * float(stats.get("live_fraction", LIVE_FRACTION)))
    if cfg.mode == "hybrid":
        # split the T terms per the candidate policy: `auto` is priced at
        # the per-term model's break-even share when a census is absent
        frac = {"all-stream": 1.0, "all-recompute": 0.0}.get(
            cfg.hybrid_split,
            float(stats.get("hybrid_stream_fraction", 1.0)))
        ent_s = int(ent * frac)
        n_rec = int(T * (1.0 - frac))
        ent_r = rows * n_rec
        G = max(int(stats.get("group_order", 1)), 1)
        plan_b = int(plan_b * max(frac, 0.4))  # shared-receive-layout floor
        c["compute_decode"] = {"bytes": ent_s * vb * k, "gathers": ent_s,
                               "flops": ent_s * k * fmul}
        c["compute_recompute"] = {
            "bytes": ent_r * vb * k, "gathers": 0,
            "flops": ent_r * (k * fmul + G * obs_phases.ORBIT_OPS)}
    else:
        c["compute"] = {"bytes": ent * vb * k, "gathers": 0,
                        "flops": ent * k * fmul}
    c["plan_h2d"]["bytes"] = plan_b * ngroups
    return c


def price_config(stats: dict, cfg: TunedConfig, cal: dict) -> float:
    """Estimated steady ms/apply for one candidate at rates ``cal`` —
    the roofline bounds (:func:`obs.roofline.phase_bounds_ms`) of the
    modeled counts, adjusted for what the candidate's pipeline hides
    (the overlap model: exchange under compute saves
    ``min(comp, exch)·(1−1/nchunks)``; a depth-d plan stream with w
    workers hides up to ``(1−1/d)·min(h2d, comp·w)`` of the staging —
    workers bound the concurrent fetches, so extra workers stop paying
    once the fetch rate saturates compute) and the disk tier's chunk
    read-back."""
    from ..obs import roofline as _roofline

    counts = model_counts(stats, cfg)
    bounds = _roofline.phase_bounds_ms(counts, cal)
    comp = (bounds.get("compute", 0.0) + bounds.get("compute_decode", 0.0)
            + bounds.get("compute_recompute", 0.0))
    exch = bounds.get("exchange", 0.0)
    h2d = bounds.get("plan_h2d", 0.0)
    if cfg.plan_tier == "disk":
        h2d += counts["plan_h2d"]["bytes"] / DISK_PLAN_BYTES_PER_S * 1e3
    total = comp + exch + h2d + bounds.get("accumulate", 0.0)
    nch = -(-int(stats["shard_size"]) // int(cfg.batch_size))
    d = int(cfg.pipeline_depth)
    if d >= 2 and nch >= 2:
        overlap = min(comp, exch) * (1.0 - 1.0 / nch) \
            if int(stats.get("n_devices", 1)) > 1 else 0.0
        hide = (1.0 - 1.0 / d) * min(h2d, comp * int(cfg.prefetch_workers))
        total = total - overlap - hide \
            + PIPELINE_OVERHEAD_FRACTION * total
    return float(total)


def priced(stats: dict, cfg: TunedConfig, cal: dict) -> TunedConfig:
    """The candidate with its price filled in."""
    return replace(cfg, priced_ms=price_config(stats, cfg, cal))
