# Ported from distributed_matvec_tpu/tune/search.py.
"""Static knob search + tuning artifacts.

:func:`choose_config` prices the whole feasible cross-product from
``tune/space.py`` through the calibrated roofline and returns the argmin
— a pure function of (structure stats, rates, mode), so every rank of a
multi-controller job computes the identical answer from the identical
inputs, and the same search tomorrow returns the same config.  The
result is persisted as a content-addressed **tuning artifact** under the
same ``utils/artifacts.py`` root as the structure/XLA caches
(``tuning/<fp>.json``), so a repeat build skips the search; the
fingerprint folds the rates in at 6 significant digits (the hybrid
token's convention), so a re-calibration — or a live posterior that
drifted — is a *miss*, never a stale hit.

Agreement: the search is deterministic, but a multi-controller build
still runs one explicit :func:`agree_config` allgather and adopts rank
0's row — the ``agree_restored`` pattern — so a rank whose artifact
cache disagrees (one warm disk, one cold) can never split the fleet into
two programs.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import List, Optional, Tuple

from ..obs.roofline import RATE_FIELDS
from ..utils.logging import _process_index, log_debug, log_warn
from .space import TunedConfig, knob_grid, price_config

__all__ = [
    "TUNER_VERSION",
    "STAT_FIELDS",
    "choose_config",
    "tuning_fingerprint",
    "tuned_artifact_path",
    "save_tuned",
    "load_tuned",
    "find_tuned",
    "agree_config",
]

#: Bump on any change to the knob grid, the pricing model, or the stats
#: schema — old artifacts must miss, not mis-apply.
TUNER_VERSION = 1

#: The structure facts the search prices from (and the fingerprint
#: hashes): everything is engine geometry, nothing is a rate.
STAT_FIELDS = ("shard_size", "num_terms", "n_my_shards", "n_devices",
               "pair", "cplx", "columns", "group_order",
               "ram_budget_bytes", "disk_available", "live_fraction",
               "hybrid_stream_fraction", "exchange_bytes")


def _canonical_stats(stats: dict) -> dict:
    out = {}
    for k in STAT_FIELDS:
        v = stats.get(k)
        if v is None:
            continue
        if isinstance(v, bool):
            out[k] = v
        elif isinstance(v, float):
            out[k] = f"{v:.6g}"
        else:
            out[k] = int(v)
    return out


def _canonical_rates(cal: dict) -> dict:
    # 6 significant digits — the hybrid rate-token convention: enough to
    # distinguish any real re-calibration, immune to float repr noise
    return {k: f"{float(cal[k]):.6g}" for k in RATE_FIELDS if k in cal}


def tuning_fingerprint(stats: dict, cal: dict, mode: str) -> str:
    """Content address of one tuning decision: tuner version + mode +
    structure geometry + rates (+ backend/device kind).  Any input that
    would change the argmin changes the fingerprint."""
    doc = {"v": TUNER_VERSION, "mode": str(mode),
           "stats": _canonical_stats(stats),
           "rates": _canonical_rates(cal),
           "backend": str(cal.get("backend", "")),
           "device_kind": str(cal.get("device_kind", ""))}
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()


def choose_config(stats: dict, calibration: dict,
                  mode: str) -> TunedConfig:
    """Price every feasible knob combination and return the argmin.

    Ties break on the config token (lexicographic) so the answer is a
    total order — two ranks, or two runs, can never pick different
    configs from equal prices."""
    best: Optional[Tuple[float, str, TunedConfig]] = None
    n = 0
    for cand in knob_grid(stats, mode):
        ms = price_config(stats, cand, calibration)
        n += 1
        key = (ms, cand.token())
        if best is None or key < (best[0], best[1]):
            from dataclasses import replace

            best = (ms, cand.token(), replace(cand, priced_ms=ms))
    if best is None:
        raise ValueError(
            f"autotune search found no feasible config for mode={mode!r} "
            f"(stats={_canonical_stats(stats)}) — the shard is larger "
            "than every plan tier; lower the problem size or pass "
            "explicit knobs")
    log_debug(f"autotune search: {n} candidates priced for {mode}, "
              f"argmin {best[2].token()} at {best[0]:.3f} ms/apply")
    return best[2]


# ---------------------------------------------------------------------------
# tuning artifacts


def tuned_artifact_path(fingerprint: str) -> Optional[str]:
    """``<artifact root>/tuning/<fp>.json``, or None when the layer is
    off/unwritable (a broken cache disk degrades to re-searching — the
    search is milliseconds, never an error)."""
    from ..utils.artifacts import artifact_path, artifacts_enabled

    if not artifacts_enabled():
        return None
    try:
        return artifact_path("tuning", fingerprint, ".json")
    except OSError as e:
        log_debug(f"tuning artifact cache unavailable: {e!r}")
        return None


def save_tuned(fingerprint: str, cfg: TunedConfig, stats: dict,
               cal: dict, search_s: float = 0.0) -> Optional[str]:
    """Persist one tuning decision (atomic write, soft-fail, process 0
    only under multi-controller — the standard artifact contract).  The
    record carries the inputs alongside the answer so capacity planning
    can surface *why* a tuned row prices the way it does."""
    path = tuned_artifact_path(fingerprint)
    if not path:
        return None
    if _process_index() != 0:
        return None
    doc = {"v": TUNER_VERSION, "fingerprint": fingerprint,
           "mode": cfg.mode, "config": cfg.to_dict(),
           "stats": _canonical_stats(stats),
           "rates": {k: float(cal[k]) for k in RATE_FIELDS if k in cal},
           "backend": str(cal.get("backend", "")),
           "device_kind": str(cal.get("device_kind", "")),
           "rate_source": str(cal.get("source", "default")),
           "search_s": round(float(search_s), 6)}
    try:
        with open(path + ".tmp", "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(path + ".tmp", path)
    except OSError as e:
        log_warn(f"tuning artifact save skipped ({path}): {e!r}")
        return None
    from ..utils.artifacts import record_cache_event

    record_cache_event("tuning", "save")
    log_debug(f"tuning artifact saved to {path}")
    return path


def load_tuned(fingerprint: str) -> Optional[TunedConfig]:
    """Restore a prior search result for this exact fingerprint; None on
    miss/corrupt (corruption goes through the standard quarantine tally
    so a bad file stops being retried)."""
    from ..utils.artifacts import note_artifact_corrupt, record_cache_event

    path = tuned_artifact_path(fingerprint)
    if not path or not os.path.exists(path):
        if path:
            record_cache_event("tuning", "miss")
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
        if int(doc.get("v", -1)) != TUNER_VERSION:
            record_cache_event("tuning", "miss")
            return None
        cfg = TunedConfig.from_dict(dict(doc["config"], source="artifact"))
    except (OSError, json.JSONDecodeError, KeyError, ValueError) as e:
        note_artifact_corrupt(path, "tuning", e)
        return None
    record_cache_event("tuning", "hit")
    return cfg


def find_tuned(mode: Optional[str] = None,
               backend: Optional[str] = None) -> List[dict]:
    """Scan the tuning-artifact tree and return the decoded records
    (most recent first) — capacity planning and the serve
    admission path read the fleet's tuned configs this way without
    re-deriving fingerprints."""
    from ..utils.artifacts import artifact_root, artifacts_enabled

    if not artifacts_enabled():
        return []
    root = os.path.join(artifact_root(), "tuning")
    if not os.path.isdir(root):
        return []
    recs = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != ".quarantine"]
        for fn in filenames:
            if not fn.endswith(".json"):
                continue
            p = os.path.join(dirpath, fn)
            try:
                with open(p) as f:
                    doc = json.load(f)
                if int(doc.get("v", -1)) != TUNER_VERSION:
                    continue
                if mode and str(doc.get("mode")) != mode:
                    continue
                if backend and str(doc.get("backend")) != backend:
                    continue
                doc["_path"] = p
                doc["_mtime"] = os.path.getmtime(p)
                recs.append(doc)
            except (OSError, json.JSONDecodeError, ValueError):
                continue
    recs.sort(key=lambda d: d.get("_mtime", 0.0), reverse=True)
    return recs


# ---------------------------------------------------------------------------
# cross-rank agreement


def agree_config(cfg: TunedConfig, group=None) -> TunedConfig:
    """Adopt rank 0's config group-wide (no-op without a rank group).

    The search itself is deterministic, so ranks *should* already agree
    — this round exists for the case the artifact caches diverge (one
    rank restores a saved config, another re-searches under a freshly
    measured calibration).  Rank 0's knobs win: every rank of a
    :class:`~..parallel.mesh.ShardGroup` all-gathers the fixed-width
    encoding and decodes row 0."""
    if group is None or group.world_size < 2:
        return cfg
    import torch

    vec = torch.tensor(cfg.encode(), dtype=torch.int64, device=group.device)
    rows = group.all_gather(vec).cpu().numpy()
    agreed = TunedConfig.decode(rows[0], cfg.mode, priced_ms=cfg.priced_ms,
                                source=cfg.source)
    if not agreed.same_knobs(cfg):
        log_warn(f"autotune: adopting rank 0 config "
                 f"{agreed.token()} over local {cfg.token()}")
    return agreed


def timed_choose(stats: dict, calibration: dict,
                 mode: str) -> Tuple[TunedConfig, float]:
    """:func:`choose_config` plus its wall time (the ``tune_search_s``
    metric bench records)."""
    t0 = time.perf_counter()
    cfg = choose_config(stats, calibration, mode)
    return cfg, time.perf_counter() - t0
