# Ported from distributed_matvec_tpu/obs/roofline.py (RATE_FIELDS, load_calibration, price_term_split) and obs/phases.py (ORBIT_OPS).
"""The rate calibration and the per-term pricing the admission model reads.

The JAX package's ``obs/roofline.py`` is the analytical roofline model over
``apply_phases`` events; the port carries only what the solve service's
admission pricing (``serve/capacity.py``) needs:

* :data:`RATE_FIELDS` — the measured rates a calibration carries;
* :func:`load_calibration` — a rates JSON read from an explicit path.  The
  content-addressed default sidecar of the JAX package waits for
  ``utils/artifacts.py``; without a path there is no calibration and
  admission prices memory only;
* :func:`price_term_split` — the per-term recompute-vs-stream cost model
  of the hybrid mode, which the capacity model prices the hybrid row with.

The rest (phase bounds, attribution, ``choose_pipeline_depth``,
``choose_hybrid_split`` and the report) needs an H100 calibration of its
own and is not in the port.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..utils.logging import log_warn

__all__ = ["RATE_FIELDS", "ORBIT_OPS", "load_calibration",
           "price_term_split"]

#: Rate fields every calibration carries (units in the name).
RATE_FIELDS = ("gather_rows_per_s", "h2d_bytes_per_s",
               "exchange_bytes_per_s", "flops_per_s")

#: Modeled flops of one orbit-scan step per term per basis row (the JAX
#: package's ``obs/phases.ORBIT_OPS``).
ORBIT_OPS = 16


def load_calibration(path: Optional[str] = None) -> Optional[dict]:
    """Read a calibration JSON; None when ``path`` is None, absent or
    unreadable, or when it lacks a rate field."""
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            cal = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        log_warn(f"calibration sidecar unreadable ({path}): {e!r}")
        return None
    if not all(k in cal for k in RATE_FIELDS):
        log_warn(f"calibration sidecar {path} missing rate fields; ignored")
        return None
    return cal


def price_term_split(live_per_term, rows: int, group_order: int,
                     cal: dict, bytes_per_live_entry: float,
                     cplx: bool = False) -> dict:
    """Per-term recompute-vs-stream pricing — the hybrid mode's cost
    model, shared by the JAX engine's ``auto`` split and the capacity
    model, so both answer the same question from the same rates.

    Per term ``t`` (all times in ms, per apply, across all ``rows``
    padded basis rows):

    * **stream**: the term's plan slice travels H2D and decodes —
      ``live[t] · (bytes_per_live_entry / h2d + 1/gather + fmul/flops)``
      (each live entry is streamed bytes, one ``x[row]`` gather, and the
      multiply);
    * **recompute**: the term's structure is re-derived on device —
      ``rows · ((G·ORBIT_OPS + fmul) / flops)`` (the orbit scan runs on
      every row whether or not the term fires there).

    ``live_per_term`` is the global live-entry census ([T] ints);
    ``rows`` the matching global padded row total.  Returns
    ``{stream_ms, recompute_ms, stream_mask}`` — ``stream_mask[t]`` True
    when streaming term ``t`` prices cheaper or equal."""
    live = np.asarray(live_per_term, np.float64).reshape(-1)
    g = float(cal["gather_rows_per_s"])
    h = float(cal["h2d_bytes_per_s"])
    fl = float(cal["flops_per_s"])
    fmul = 8.0 if cplx else 2.0
    per_entry_s = bytes_per_live_entry / h + 1.0 / g + fmul / fl
    stream_ms = live * per_entry_s * 1e3
    recompute_ms = np.full(
        live.shape,
        float(rows) * (max(int(group_order), 1) * ORBIT_OPS + fmul)
        / fl * 1e3)
    return {"stream_ms": stream_ms, "recompute_ms": recompute_ms,
            "stream_mask": stream_ms <= recompute_ms}
