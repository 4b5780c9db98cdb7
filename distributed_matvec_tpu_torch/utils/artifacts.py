# Ported from distributed_matvec_tpu/utils/artifacts.py (all but ensure_compilation_cache).
"""Content-addressed on-disk artifact cache — default ON.

An engine spends far longer being constructed than applied, yet its two
expensive construction products are pure functions of content that rarely
changes:

  basis/       representative + norm arrays, keyed by the basis JSON
               (sector, symmetries, particle content) — the
               ``makeBasisStates`` restore of Diagonalize.chpl:227-246,
               automatic (:func:`make_or_restore_basis`);
  structure/   ``LocalEngine``'s ELL/compact structure sidecars, keyed by
               the engine's ``_structure_fingerprint()`` (basis content +
               operator term tables + mode/dtype/padding).

Both are HDF5 files and need ``h5py``; without it every engine builds as
before, and nothing else is written in their place.  The decision
products the cost model writes live under the same root:

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
(``DMT_ARTIFACT_CACHE=off`` to disable).  Engines consult this layer only
when the caller did not pass an explicit ``structure_cache`` path;
explicit paths keep their loud save errors, while default-path saves fail
soft — a read-only checkout must never turn a cache write into an engine
error.  The basis artifact's :func:`basis_fingerprint` is the JAX
package's, so the two packages share one cache entry for one basis (the
structure sidecars are keyed apart: see ``LocalEngine``).

``ensure_compilation_cache`` is not ported: it points XLA's compilation
cache, which the port does not have (as it has no AOT program cache).
"""

from __future__ import annotations

import os
from typing import Optional

from .config import get_config
from .logging import log_debug, log_warn

__all__ = [
    "artifact_root",
    "artifacts_enabled",
    "artifact_path",
    "hdf5_cache_enabled",
    "default_structure_cache",
    "basis_fingerprint",
    "soft_save_structure",
    "make_or_restore_basis",
    "within_size_cap",
    "record_cache_event",
    "note_artifact_ok",
    "note_artifact_corrupt",
    "quarantine_artifact",
]


def record_cache_event(kind: str, event: str) -> None:
    """One artifact-cache outcome into the metrics registry
    (``artifact_cache{kind=basis|structure|calibration|tuning,
    event=hit|miss|save|evict|...}``) — the single call site the cache
    users share."""
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


def hdf5_cache_enabled() -> bool:
    """Whether the layer is on and can write its HDF5 products (basis
    checkpoints, structure sidecars): ``h5py`` imports."""
    if not artifacts_enabled():
        return False
    from ..io.hdf5 import _h5py

    try:
        _h5py()
    except RuntimeError as e:
        log_debug(f"HDF5 artifacts disabled: {e!r}")
        return False
    return True


def default_structure_cache(fingerprint: str) -> Optional[str]:
    """Content-addressed base path for an engine structure sidecar, or
    ``None`` when the layer is off or h5py is missing (or the root is
    uncreatable — a broken cache disk must degrade to a plain rebuild, not
    an engine error)."""
    if not hdf5_cache_enabled():
        return None
    try:
        return artifact_path("structure", fingerprint)
    except OSError as e:
        log_debug(f"artifact cache unavailable: {e!r}")
        return None


def within_size_cap(nbytes: int) -> bool:
    """Whether a DEFAULT-path structure sidecar of ``nbytes`` may be written
    (the ``artifact_max_gb`` knob; explicit paths are never capped)."""
    return nbytes <= get_config().artifact_max_gb * 1e9


def soft_save_structure(sidecar: str, fingerprint: str, mode: str,
                        payload: dict) -> bool:
    """DEFAULT-path (artifact cache) structure sidecar save: honors the
    ``artifact_max_gb`` size cap and degrades to a warning on I/O errors
    — a read-only checkout or a full cache disk must never turn a cache
    write into an engine-construction error.  True when written."""
    nbytes = sum(getattr(v, "nbytes", 0) for v in payload.values())
    if not within_size_cap(nbytes):
        record_cache_event("structure", "evict")
        log_debug(f"structure artifact save skipped: {nbytes/1e9:.1f} GB "
                  "exceeds artifact_max_gb")
        return False
    from ..io.hdf5 import save_engine_structure

    try:
        save_engine_structure(sidecar, fingerprint, mode, payload)
    except OSError as e:
        log_warn(f"structure artifact save skipped: {e!r}")
        return False
    record_cache_event("structure", "save")
    return True


def basis_fingerprint(basis) -> str:
    """Identity of a basis *definition* (not its enumerated output): the
    JSON dict that also seeds the engines' structure fingerprints — the
    JAX package's digest, so both packages key one basis alike."""
    import hashlib
    import json

    h = hashlib.sha256()
    h.update(json.dumps(basis._json_dict(), sort_keys=True,
                        default=str).encode())
    h.update(b"|basis-v1")
    return h.hexdigest()


def _rank_zero() -> bool:
    """Whether this process writes shared artifacts: rank 0 of an
    initialized ``torch.distributed`` group, or the only process."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def make_or_restore_basis(basis, path: Optional[str] = None,
                          save: bool = True) -> bool:
    """Build ``basis``, restoring representatives from the artifact cache
    when a matching checkpoint exists (True = restored).

    ``path=None`` resolves the content-addressed default; an explicit path
    is read and written alike.  Saves go through an atomic temp-file +
    ``os.replace`` so concurrent processes warming the same basis can
    never interleave partial writes (only rank 0 of a
    ``torch.distributed`` run writes at all).  Everything fails soft: with
    the layer off, h5py missing, or the cache dir unwritable this is
    exactly ``basis.build()``.
    """
    if basis.is_built:
        return False
    from ..io.hdf5 import _h5py, restore_representatives, save_basis

    try:
        if path is None:
            if not hdf5_cache_enabled():
                basis.build()
                return False
            path = artifact_path("basis", basis_fingerprint(basis), ".h5")
        else:
            _h5py()
    except (OSError, RuntimeError) as e:
        log_debug(f"basis artifact cache unavailable: {e!r}")
        basis.build()
        return False
    # a persistently corrupt checkpoint falls through to the rebuild
    # path and the corrupt/quarantine tally
    if restore_representatives(basis, path, require_norms=True):
        record_cache_event("basis", "hit")
        log_debug(f"basis representatives restored from {path}")
        return True
    record_cache_event("basis", "miss")
    basis.build()
    if not save or not _rank_zero():
        return False
    try:
        import tempfile

        from . import faults

        faults.check("artifact_save", path=path)
        d = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(suffix=".h5.tmp", dir=d)
        os.close(fd)
        os.chmod(tmp, 0o644)
        try:
            save_basis(tmp, basis.representatives, basis.norms)
            os.replace(tmp, path)
            note_artifact_ok(path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        record_cache_event("basis", "save")
        log_debug(f"basis representatives checkpointed to {path}")
    except OSError as e:
        log_warn(f"basis artifact save skipped: {e!r}")
    return False
