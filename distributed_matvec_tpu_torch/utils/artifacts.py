# Ported from distributed_matvec_tpu/utils/artifacts.py (the JSON half: record_cache_event, the corrupt/quarantine policy, artifacts_enabled, artifact_root, artifact_path, within_size_cap).
"""Content-addressed on-disk artifact cache — default ON.

The decision products the cost model writes live here, under one root:

  calibration/ measured hardware rates (``obs/roofline.py`` sidecars,
               written by ``python -m distributed_matvec_tpu_torch.obs.
               calibrate``);
  tuning/      autotuner decisions (``tune/search.py``: the chosen knob
               config per (structure, rates, mode) fingerprint) and the
               live rate posteriors (``tune/live.py``,
               ``*.posterior.json``) that serve admission prices from.

The root resolves (first hit wins) as

  ``DMT_ARTIFACT_DIR`` env var > ``artifact_dir`` config field >
  ``~/.cache/distributed_matvec_tpu/artifacts``

and the whole layer is switched by the ``artifact_cache`` config knob
(``DMT_ARTIFACT_CACHE=off`` to disable).  Every write is atomic and fails
soft: a read-only checkout must never turn a cache write into an engine
error.

Not in this module yet: the JAX package's HDF5 products — the basis
checkpoint (``make_or_restore_basis``), the structure sidecars
(``default_structure_cache``, ``soft_save_structure``) and
``basis_fingerprint`` — come with the persistence slice (they need
``h5py``).  ``ensure_compilation_cache`` points XLA's compilation cache,
which the port does not have (as it has no AOT program cache).
"""

from __future__ import annotations

import os

from .config import get_config
from .logging import log_warn

__all__ = [
    "artifact_root",
    "artifacts_enabled",
    "artifact_path",
    "within_size_cap",
    "record_cache_event",
    "note_artifact_ok",
    "note_artifact_corrupt",
    "quarantine_artifact",
]


def record_cache_event(kind: str, event: str) -> None:
    """One artifact-cache outcome into the metrics registry
    (``artifact_cache{kind=calibration|tuning, event=hit|miss|save|...}``)
    — the single call site the cache users share."""
    from ..obs.metrics import counter

    counter("artifact_cache", kind=kind, event=event).inc()


_DEFAULT_ROOT = os.path.join(os.path.expanduser("~"), ".cache",
                             "distributed_matvec_tpu", "artifacts")

# per-path corrupt-read tally for the retry/quarantine policy: one failure
# is counted (transient disks happen), a second moves the file out of the
# cache's way
_read_failures: dict = {}


def note_artifact_ok(path: str) -> None:
    """Clear the corruption tally for ``path`` (after a successful write:
    a re-saved artifact starts with a clean record)."""
    _read_failures.pop(path, None)


def note_artifact_corrupt(path: str, kind: str, error=None) -> bool:
    """Record a corrupt/unreadable artifact read and apply the quarantine
    policy: every failure bumps ``artifact_cache{kind=...,event=corrupt}``
    and emits an ``artifact_cache`` corrupt event; the SECOND failure on
    the same path moves the file into a ``.quarantine/`` sibling directory
    (:func:`quarantine_artifact`) so the cache stops serving it.  Returns
    True when the file was quarantined."""
    record_cache_event(kind, "corrupt")
    try:
        from ..obs.events import emit

        # "kind" is an envelope key: the artifact kind rides as
        # artifact_kind (as in the counter's labels)
        emit("artifact_cache", artifact_kind=kind, event="corrupt",
             path=path, error=repr(error))
    except Exception:
        pass
    n = _read_failures.get(path, 0) + 1
    _read_failures[path] = n
    if n < 2:
        log_warn(f"corrupt {kind} artifact {path} ({error!r}); rebuilding "
                 "— a second failure will quarantine the file")
        return False
    return quarantine_artifact(path, kind, reason=repr(error))


def quarantine_artifact(path: str, kind: str, reason: str = "") -> bool:
    """Move a bad artifact into ``.quarantine/`` next to it (same
    filesystem, atomic rename) and emit an ``artifact_quarantine`` event.
    Fails soft: an unmovable file logs one warning and stays — readers
    already treat it as a miss."""
    if not os.path.exists(path):
        return False
    qdir = os.path.join(os.path.dirname(os.path.abspath(path)),
                        ".quarantine")
    try:
        os.makedirs(qdir, exist_ok=True)
        dest = os.path.join(qdir, os.path.basename(path))
        i = 1
        while os.path.exists(dest):
            dest = os.path.join(qdir, f"{os.path.basename(path)}.{i}")
            i += 1
        os.replace(path, dest)
    except OSError as e:
        log_warn(f"quarantine of {path} failed: {e!r}")
        return False
    _read_failures.pop(path, None)
    record_cache_event(kind, "quarantine")
    try:
        from ..obs.events import emit

        emit("artifact_quarantine", artifact_kind=kind, path=path,
             moved_to=dest, reason=reason)
    except Exception:
        pass
    try:
        from ..obs.flight import flight_dump

        flight_dump("quarantine", artifact_kind=kind, path=path,
                    moved_to=dest, error=reason)
    except Exception:
        pass
    log_warn(f"quarantined corrupt {kind} artifact: {path} -> {dest}")
    return True


def artifacts_enabled() -> bool:
    """Whether the default-on artifact layer is active.

    The env var is consulted directly (not just through the config
    snapshot) so a harness can flip it for a subprocess without racing
    the config cache."""
    env = os.environ.get("DMT_ARTIFACT_CACHE")
    knob = env if env is not None else get_config().artifact_cache
    knob = str(knob).strip().lower()
    if knob in ("on", "1", "true", "yes", ""):
        return True
    if knob not in ("off", "0", "false", "no"):
        # fail SOFT and closed: an unrecognized value (a typo for "off",
        # most likely) must not crash an engine build, and caching when
        # the user tried to disable would be the surprising direction
        import warnings

        warnings.warn(f"unknown artifact_cache setting {knob!r} "
                      "(use on | off); treating as off", stacklevel=2)
    return False


def artifact_root() -> str:
    """Resolve the artifact root directory (no filesystem side effects)."""
    return (os.environ.get("DMT_ARTIFACT_DIR")
            or get_config().artifact_dir
            or _DEFAULT_ROOT)


def artifact_path(kind: str, fingerprint: str, suffix: str = "") -> str:
    """``root/<kind>/<fp[:2]>/<fp><suffix>`` with the directory created.

    The two-hex-char shard keeps any one directory from accumulating an
    unbounded flat listing on long-lived caches."""
    d = os.path.join(artifact_root(), kind, fingerprint[:2])
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, fingerprint + suffix)


def within_size_cap(nbytes: int) -> bool:
    """Whether a default-path artifact of ``nbytes`` may be written (the
    ``artifact_max_gb`` knob; explicit paths are never capped)."""
    return nbytes <= get_config().artifact_max_gb * 1e9
