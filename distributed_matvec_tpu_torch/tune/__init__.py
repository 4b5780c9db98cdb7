# Ported from distributed_matvec_tpu/tune/__init__.py.
"""Self-tuning runtime: close the loop from the
calibrated roofline cost model to live knob selection.

Three layers, smallest import surface first:

* ``space``  — the knob cross-product (:class:`TunedConfig`,
  :func:`knob_grid`) and the analytic pricer (:func:`price_config`)
  that mirrors the engine's ``_phase_counts`` through
  ``obs/roofline.py``;
* ``search`` — the deterministic static search
  (:func:`choose_config`), content-addressed tuning artifacts, and the
  cross-rank :func:`agree_config` round;
* ``live``   — the :class:`RatePosterior` (calibration-as-prior,
  log-EMA over measured walls) and :class:`LiveTuner` (drift-triggered
  re-tune proposals the engine applies only at safe boundaries).

Engines consult this package when ``tune=static|live``
(``DMT_TUNE``); everything here is pure host-side pricing, so importing
it never touches a device.
"""

from .live import (DRIFT_BAND, POSTERIOR_ALPHA, LiveTuner, RatePosterior,
                   load_posterior, posterior_path, save_posterior,
                   tune_window)
from .search import (TUNER_VERSION, agree_config, choose_config,
                     find_tuned, load_tuned, save_tuned, timed_choose,
                     tuning_fingerprint)
from .space import (TunedConfig, knob_grid, model_counts,
                    plan_bytes_per_row, price_config)

__all__ = [
    "TunedConfig",
    "knob_grid",
    "model_counts",
    "plan_bytes_per_row",
    "price_config",
    "TUNER_VERSION",
    "choose_config",
    "timed_choose",
    "tuning_fingerprint",
    "save_tuned",
    "load_tuned",
    "find_tuned",
    "agree_config",
    "RatePosterior",
    "LiveTuner",
    "POSTERIOR_ALPHA",
    "DRIFT_BAND",
    "posterior_path",
    "save_posterior",
    "load_posterior",
    "tune_window",
]
