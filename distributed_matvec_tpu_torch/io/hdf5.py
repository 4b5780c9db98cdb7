# Ported from distributed_matvec_tpu/io/hdf5.py (h5py imported when a file is read or written; tensors leave the card before h5py sees them).
"""HDF5 I/O + representative checkpoint/restore.

The counterpart of the reference's ``MyHDF5.chpl`` and the
compute-or-restore logic of ``Diagonalize.chpl:227-246``, with the JAX
package's file layout, so either package reads the other's files:

  * output file layout (groups created by Diagonalize.chpl:276-279):
      /basis/representatives        u64 [N]
      /basis/norms                  f64 [N]
      /hamiltonian/eigenvalues      f64 [k]
      /hamiltonian/eigenvectors     f64/c128 [k, N]  (block order)
      /hamiltonian/residuals        f64 [k]
      /observables/<name>           f64 scalar ⟨ψ₀|O|ψ₀⟩ per YAML observable
  * golden-file layout (input_for_matvec.py:28-46): /representatives, /x, /y.

Basis states are written as the u64 view of their bits, whether they come
as the host basis's u64 array or as the int64 bit patterns the port keeps
on the card (``utils/u64.py``); the readers return them as int64 bit
patterns.  Tensors are copied to the host (``.cpu().numpy()``) before h5py
sees them; complex sectors are native complex128 (the JAX (re, im) pair
form is not ported).

``h5py`` is imported by each function that touches a file; where it is not
installed, those raise the JAX package's ``RuntimeError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "save_basis",
    "load_basis",
    "save_eigen",
    "load_eigen",
    "save_golden",
    "load_golden",
    "save_observables",
    "make_or_restore_representatives",
    "save_engine_structure",
    "load_engine_structure",
]


def _h5py():
    try:
        import h5py
        return h5py
    except ImportError as e:
        raise RuntimeError(
            "h5py is required for HDF5 I/O; it is unavailable in this "
            "environment"
        ) from e


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a host NumPy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _u64(states) -> np.ndarray:
    """Basis states as u64 with the same bits: the host basis's u64 array,
    or int64 bit patterns (a NumPy array or a tensor)."""
    a = np.ascontiguousarray(_host(states))
    if a.dtype == np.int64:
        return a.view(np.uint64)
    return np.asarray(a, np.uint64)


def _bits(states: np.ndarray) -> np.ndarray:
    """u64 states read from a file as int64 bit patterns."""
    return np.ascontiguousarray(states.astype(np.uint64)).view(np.int64)


def save_engine_structure(path: str, fingerprint: str, mode: str,
                          payload: dict) -> None:
    """Checkpoint a precomputed engine structure under /engine_structure.

    The ELL/compact structure build is a pure function of (basis,
    operator, mode) — captured in ``fingerprint`` — so a rerun can restore
    it in I/O time.  Scalars go to attrs, arrays (host copies of tensors)
    to datasets; None values are skipped.

    The sidecar is written to a temp file in the same directory and then
    ``os.replace``d onto ``path``: concurrent writers (every rank
    constructing the same engine) each produce a complete file and the
    rename is atomic, so a reader never observes an interleaved
    half-write.  The fingerprint is still written last as a second line of
    defence against a writer killed mid-save.
    """
    import os
    import tempfile

    from ..utils import faults

    h5py = _h5py()
    faults.check("ckpt_write", path=path)
    dirname = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(suffix=".h5.tmp", dir=dirname)
    os.close(fd)
    # mkstemp creates 0600; a fixed conventional mode (reading the umask
    # would mutate process-global state)
    os.chmod(tmp, 0o644)
    try:
        with h5py.File(tmp, "w") as f:
            g = f.create_group("engine_structure")
            g.attrs["mode"] = mode
            for k, v in payload.items():
                if v is None:
                    continue
                if np.isscalar(v):
                    g.attrs[k] = v
                else:
                    g.create_dataset(k, data=_host(v))
            # fingerprint LAST: a partially written file (killed mid-save)
            # then fails the fingerprint check instead of restoring garbage
            g.attrs["fingerprint"] = fingerprint
        faults.check("ckpt_rename", path=path)
        os.replace(tmp, path)
        # a complete fresh file landed: clear any corruption history so
        # the healed path is not one transient blip away from quarantine
        from ..utils.artifacts import note_artifact_ok

        note_artifact_ok(path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_engine_structure(path: str, fingerprint: str) -> Optional[dict]:
    """Restore a structure checkpoint; None unless the fingerprint matches
    (a stale checkpoint for a different basis/operator/mode is ignored, not
    an error)."""
    import os

    from ..utils import faults

    if not path or not os.path.exists(path):
        return None
    h5py = _h5py()

    def _read():
        faults.check("artifact_read", path=path)
        with h5py.File(path, "r") as f:
            if "engine_structure" not in f:
                return None
            g = f["engine_structure"]
            if str(g.attrs.get("fingerprint", "")) != fingerprint:
                return None
            out = {k: g.attrs[k] for k in g.attrs}
            for k in g:
                out[k] = g[k][...]
            return out

    try:
        # bounded retry for the transient case; a persistently
        # truncated/corrupt checkpoint rebuilds AND feeds the
        # corrupt/quarantine tally (utils/artifacts.py)
        return faults.with_retries("artifact_read", _read)
    except OSError as e:
        from ..utils.artifacts import note_artifact_corrupt

        note_artifact_corrupt(path, "structure", e)
        return None


def save_basis(path: str, representatives,
               norms=None) -> None:
    """Write /basis/representatives (u64) + norms — the checkpoint side of
    ``makeBasisStates`` (Diagonalize.chpl:237-243, MyHDF5.chpl:309-333)."""
    h5 = _h5py()
    with h5.File(path, "a") as f:
        g = f.require_group("basis")
        for name in ("representatives", "norms"):
            if name in g:
                del g[name]
        g.create_dataset("representatives", data=_u64(representatives))
        if norms is not None:
            g.create_dataset("norms",
                             data=np.asarray(_host(norms), np.float64))


def load_basis(path: str) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """(representatives as int64 bits, norms|None) if the checkpoint
    exists, else None — the restore probe of Diagonalize.chpl:228-235."""
    import os

    h5 = _h5py()
    if not os.path.exists(path):
        return None
    with h5.File(path, "r") as f:
        if "basis/representatives" not in f:
            return None
        reps = _bits(f["basis/representatives"][...])
        norms = (f["basis/norms"][...].astype(np.float64)
                 if "basis/norms" in f else None)
        return reps, norms


def restore_representatives(basis, path: str,
                            require_norms: bool = False) -> bool:
    """Set ``basis``'s representatives from the checkpoint at ``path``
    (True), or leave the basis unbuilt (False) for the caller to build and
    save.  The read is retried under the ``artifact_read`` fault site
    (transient disk blips); a persistently corrupt checkpoint goes to the
    corrupt/quarantine tally.  ``require_norms`` refuses a checkpoint
    without ``/basis/norms``."""
    import os

    from ..utils import faults
    from ..utils.artifacts import note_artifact_corrupt

    def _load():
        if os.path.exists(path):
            faults.check("artifact_read", path=path)
        return load_basis(path)

    try:
        got = faults.with_retries("artifact_read", _load)
    except OSError as e:
        note_artifact_corrupt(path, "basis", e)
        return False
    if got is None or (require_norms and got[1] is None):
        return False
    reps, norms = got
    basis.unchecked_set_representatives(reps.view(np.uint64), norms)
    return True


def make_or_restore_representatives(basis, path: Optional[str],
                                    save: bool = True) -> bool:
    """Build the basis, restoring representatives from ``path`` when present
    (exact ``makeBasisStates`` semantics, Diagonalize.chpl:227-246).

    Returns True if restored from checkpoint, False if computed (and, when a
    path is given and ``save`` is True, checkpointed).  In a multi-process
    run every rank should RESTORE from the same path (so all ranks agree on
    the representative set even against a stale checkpoint) but only one
    rank should ``save``.

    The restore is :func:`restore_representatives`: a persistently corrupt
    checkpoint degrades to a rebuild + the corrupt/quarantine tally."""
    if path is not None and restore_representatives(basis, path):
        return True
    basis.build()
    if path is not None and save:
        from ..utils.artifacts import note_artifact_ok

        try:
            save_basis(path, basis.representatives, basis.norms)
            note_artifact_ok(path)
        except OSError as e:
            # a corrupt pre-existing file refuses h5py appends too — move
            # it aside (it already failed its read above) and write fresh;
            # if even that fails, the checkpoint is lost but the run lives
            from ..utils.artifacts import quarantine_artifact
            from ..utils.logging import log_warn

            if quarantine_artifact(path, "basis", reason=repr(e)):
                try:
                    save_basis(path, basis.representatives, basis.norms)
                    note_artifact_ok(path)
                except OSError as e2:
                    log_warn(f"basis checkpoint save skipped: {e2!r}")
            else:
                log_warn(f"basis checkpoint save skipped: {e!r}")
    return False


def save_eigen(path: str, eigenvalues, eigenvectors=None,
               residuals=None) -> None:
    """Write /hamiltonian/{eigenvalues,eigenvectors,residuals}
    (Diagonalize.chpl:248-256); eigenvectors are ``[k, N]`` in block
    order."""
    h5 = _h5py()
    with h5.File(path, "a") as f:
        g = f.require_group("hamiltonian")
        for name in ("eigenvalues", "eigenvectors", "residuals"):
            if name in g:
                del g[name]
        g.create_dataset("eigenvalues", data=_host(eigenvalues))
        if eigenvectors is not None:
            g.create_dataset("eigenvectors", data=_host(eigenvectors))
        if residuals is not None:
            g.create_dataset("residuals", data=_host(residuals))


def load_eigen(path: str):
    h5 = _h5py()
    with h5.File(path, "r") as f:
        g = f["hamiltonian"]
        return (
            g["eigenvalues"][...],
            g["eigenvectors"][...] if "eigenvectors" in g else None,
            g["residuals"][...] if "residuals" in g else None,
        )


def save_observables(path: str, values) -> dict:
    """Write ⟨ψ|O|ψ⟩ scalars under /observables (Diagonalize.chpl:276-279's
    output group).  ``values`` is a sequence of (name, value); duplicate
    names are disambiguated with a numeric suffix so no result is silently
    dropped.  Returns the name → value mapping actually written."""
    h5 = _h5py()
    written = {}
    for name, val in values:
        key, k = name, 2
        while key in written:
            key = f"{name}_{k}"
            k += 1
        written[key] = float(val)
    with h5.File(path, "a") as f:
        g = f.require_group("observables")
        for key, val in written.items():
            if key in g:
                del g[key]
            g.create_dataset(key, data=val)
    return written


def save_golden(path: str, representatives, x, y) -> None:
    """Write a golden matvec file: /representatives, /x, /y=Hx — the layout
    the reference's generator emits (input_for_matvec.py:28-46) and its
    matvec test consumes (TestMatrixVectorProduct.chpl:25-59).  ``x``/``y``
    are stored as [k, N] batches (rank-1 input is promoted to k=1, matching
    the generator's transposed layout, :43-46)."""
    h5 = _h5py()
    x = np.atleast_2d(_host(x))
    y = np.atleast_2d(_host(y))
    with h5.File(path, "w") as f:
        f.create_dataset("representatives", data=_u64(representatives))
        f.create_dataset("x", data=x)
        f.create_dataset("y", data=y)


def load_golden(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(representatives as int64 bits, x [k, N], y [k, N]) from a golden
    matvec file."""
    h5 = _h5py()
    with h5.File(path, "r") as f:
        return (_bits(f["representatives"][...]),
                np.atleast_2d(f["x"][...]), np.atleast_2d(f["y"][...]))
