# Ported from distributed_matvec_tpu/io/sharded_io.py (h5py imported when a file is read or written; tensors leave the card before h5py sees them).
"""Chunked / per-shard vector I/O for sectors too large for one array.

The reference reads and writes big datasets in hyperslab chunks and
per-locale blocks (``MyHDF5.chpl:105-162, 272-333``) because no locale can
hold a global array.  The analogs here, with the JAX package's file layout:

* :func:`stream_block_to_shards` — a block-order (global sorted) dataset,
  e.g. a golden ``/x`` next to ``/representatives``, is read in hyperslab
  chunks, hash-routed (``localeIdxOf``), and appended to per-shard
  datasets; chunks ascend, so each shard lands in the per-shard sorted
  order the engine consumes (``arrFromBlockToHashed``,
  BlockToHashed.chpl:87-208, as streaming I/O).
* :func:`save_hashed_vector` / :func:`load_hashed_shard` — a hashed
  ``[D, M(, k)]`` array (eigenvectors, checkpoint state) written one shard
  at a time with the pad rows stripped, and read back per shard.  In a
  multi-process run (an initialized ``torch.distributed`` group of more
  than one rank) each process writes its own file ``path.r<rank>`` holding
  only the shards it was given.

Vectors may be tensors on any device (copied to the host first), NumPy
arrays, or ``{d: rows}`` dicts of host pieces.  ``h5py`` is imported by
each function that touches a file; where it is not installed they raise
the ``RuntimeError`` of ``io/hdf5.py``.
"""

from __future__ import annotations

import contextlib
import glob
import os
import tempfile
from typing import Optional

import numpy as np

from ..enumeration.host import shard_index
from .hdf5 import _h5py, _host

__all__ = ["stream_block_to_shards", "save_hashed_vector",
           "save_hashed_vectors", "load_hashed_shard",
           "load_hashed_meta", "hashed_vector_counts",
           "hashed_shard_reader"]

_CHUNK = 1 << 20


def _process_rank() -> Optional[int]:
    """This process's rank when a ``torch.distributed`` group of more than
    one rank is initialized (the JAX ``jax.process_count() > 1`` test),
    else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return int(dist.get_rank())
    return None


def stream_block_to_shards(src_path: str, out_path: str, n_shards: int,
                           x_dataset: str = "x",
                           reps_dataset: str = "representatives",
                           name: str = "v",
                           chunk: int = _CHUNK) -> np.ndarray:
    """Route a block-order dataset into per-shard datasets, chunk by chunk.

    ``src_path[x_dataset]`` may be rank-1 [N] or a batch [k, N] (the golden
    generator's transposed layout, input_for_matvec.py:43-46); the output
    shard datasets are [c_d] or [c_d, k].  Returns the per-shard counts.
    """
    h5py = _h5py()

    with h5py.File(src_path, "r") as fin, h5py.File(out_path, "w") as fout:
        reps = fin[reps_dataset]
        xd = fin[x_dataset]
        batch = xd.ndim == 2
        n = reps.shape[0]
        if (xd.shape[-1] if batch else xd.shape[0]) != n:
            raise ValueError(
                f"{x_dataset} has {xd.shape} entries for {n} representatives")
        counts = np.zeros(n_shards, np.int64)
        g = fout.create_group(f"vector_shards/{name}")
        dsets = []
        for d in range(n_shards):
            shape = (0, xd.shape[0]) if batch else (0,)
            maxshape = (None, xd.shape[0]) if batch else (None,)
            chunks = (min(chunk, _CHUNK),) + ((xd.shape[0],) if batch else ())
            dsets.append(g.create_dataset(str(d), shape=shape,
                                          maxshape=maxshape, dtype=xd.dtype,
                                          chunks=chunks))
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            r_c = reps[s:e]
            x_c = xd[:, s:e].T if batch else xd[s:e]
            owner = shard_index(np.asarray(r_c, np.uint64), n_shards)
            order = np.argsort(owner, kind="stable")
            x_s = x_c[order]
            bounds = np.searchsorted(owner[order], np.arange(n_shards + 1))
            for d in range(n_shards):
                lo, hi = bounds[d], bounds[d + 1]
                if lo == hi:
                    continue
                ds = dsets[d]
                o = ds.shape[0]
                ds.resize((o + hi - lo,) + ds.shape[1:])
                ds[o:] = x_s[lo:hi]
                counts[d] += hi - lo
        fout.attrs["counts"] = counts
        fout.attrs["n_shards"] = n_shards
    return counts


def save_hashed_vector(path: str, xh, counts, name: str = "v") -> None:
    """Write a hashed ``[D, M(, k)]`` array one shard at a time, pad rows
    stripped (pass the ``counts`` the layout/manifest carries).  In a
    multi-process run each rank writes its OWN file (``path.r<rank>``);
    :func:`load_hashed_shard` finds a shard in whichever file holds it."""
    save_hashed_vectors(path, {name: xh}, counts)


def _shard_rows(xh, d: int):
    """Shard ``d``'s padded host rows of ``xh`` (a ``{d: rows}`` dict of
    host pieces, or a whole ``[D, M, …]`` tensor or array), or None when
    the dict does not hold it (another process's shard)."""
    if isinstance(xh, dict):
        piece = xh.get(d)
        return None if piece is None else _host(piece)
    return _host(xh[d])


def save_hashed_vectors(path: str, vectors: dict, counts,
                        meta: Optional[dict] = None) -> None:
    """Write several named hashed arrays in ONE atomic file pass.

    The whole file is built at a temp path and ``os.replace``d, so a crash
    mid-save can't leave a corrupt or mixed-generation vector file, and
    each rewritten group is recreated wholesale so stale shard datasets
    from an earlier save with a different D/counts can't survive.  All
    other file content (other vector groups, co-located datasets/groups,
    root attrs) is carried over; an unreadable previous file is an error —
    silently replacing it would destroy co-located data.

    ``meta`` (scalars/small arrays) is written under ``/ckpt_meta`` in the
    SAME atomic pass, replacing any previous meta — so checkpoint metadata
    and the vectors it describes can never be of mixed generations (the
    solvers' multi-process checkpoints, ``solve/lanczos.py``).  Each
    vector is a ``[D, M, …]`` tensor or array, or a ``{d: rows}`` dict of
    the shards this process holds."""
    from ..utils import faults

    h5py = _h5py()
    counts = np.asarray(counts, np.int64)
    D = counts.size
    rank = _process_rank()
    if rank is not None:
        path = f"{path}.r{rank}"
    faults.check("ckpt_write", path=path)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)) or ".", suffix=".tmp")
    os.close(fd)
    try:
        with h5py.File(tmp, "w") as fout:
            if os.path.exists(path):
                with h5py.File(path, "r") as fin:
                    for k in fin:
                        if k == "vector_shards":
                            dst = fout.require_group("vector_shards")
                            for other in fin["vector_shards"]:
                                if other not in vectors:
                                    fin.copy(f"vector_shards/{other}", dst,
                                             name=other)
                        elif k == "ckpt_meta" and meta is not None:
                            pass             # replaced wholesale below
                        else:
                            fin.copy(k, fout, name=k)
                    for k, v in fin.attrs.items():
                        if k not in ("counts", "n_shards"):
                            fout.attrs[k] = v
            for name, xh in vectors.items():
                g = fout.require_group(f"vector_shards/{name}")
                for d in range(D):
                    shard = _shard_rows(xh, d)
                    if shard is None:
                        continue            # another process's shard
                    g.create_dataset(str(d), data=shard[: counts[d]])
            if meta is not None:
                g = fout.require_group("ckpt_meta")
                for k, v in meta.items():
                    if isinstance(v, str):
                        g.attrs[k] = v      # h5py rejects numpy str scalars
                        continue
                    a = np.asarray(v)
                    if a.ndim == 0:
                        g.attrs[k] = a[()]
                    else:
                        g.create_dataset(k, data=a)
            fout.attrs["counts"] = counts
            fout.attrs["n_shards"] = D
        faults.check("ckpt_rename", path=path)
        os.replace(tmp, path)
        from ..utils.artifacts import note_artifact_ok

        note_artifact_ok(path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _candidates(path: str):
    return [path] + sorted(glob.glob(f"{path}.r*"))


def load_hashed_meta(path: str,
                     expected_fingerprint: Optional[str] = None
                     ) -> Optional[dict]:
    """The ``/ckpt_meta`` group of a hashed-vector file (attrs + datasets),
    searched across ``path`` and any per-rank ``path.r*`` files; None when
    absent.  ``expected_fingerprint`` keeps the scan going past candidates
    whose ``fingerprint`` attr doesn't match — so a stale base-path file
    from an earlier single-process run does not mask valid per-rank
    ``.r*`` checkpoints."""
    h5py = _h5py()

    for cand in _candidates(path):
        try:
            with h5py.File(cand, "r") as f:
                if "ckpt_meta" not in f:
                    continue
                if not _fingerprint_ok(f, expected_fingerprint):
                    continue
                g = f["ckpt_meta"]
                out = {k: g.attrs[k] for k in g.attrs}
                for k in g:
                    out[k] = g[k][...]
                return out
        except OSError:
            continue
    return None


def _fingerprint_ok(f, expected_fingerprint: Optional[str]) -> bool:
    """True when ``expected_fingerprint`` is unset or matches the file's
    ``/ckpt_meta`` fingerprint attr."""
    if expected_fingerprint is None:
        return True
    if "ckpt_meta" not in f:
        return False
    return (str(f["ckpt_meta"].attrs.get("fingerprint", ""))
            == expected_fingerprint)


def _generation_ok(f, match_meta: Optional[dict]) -> bool:
    """True when the file's own ``/ckpt_meta`` generation scalars
    (``m``, ``total_iters``) agree with the metadata the caller already
    selected.  Per-rank ``.r*`` files are written without a barrier, so a
    crash between rank saves leaves files of MIXED generations that all
    pass the fingerprint filter — and a thick restart SHRINKS ``m``, so a
    stale file could satisfy every shard fetch of a newer, smaller
    checkpoint and splice old basis rows into the resume."""
    if match_meta is None:
        return True
    if "ckpt_meta" not in f:
        return False
    attrs = f["ckpt_meta"].attrs
    for k in ("m", "total_iters"):
        if k not in match_meta:
            continue
        if k not in attrs or int(attrs[k]) != int(match_meta[k]):
            return False
    return True


@contextlib.contextmanager
def hashed_shard_reader(path: str,
                        expected_fingerprint: Optional[str] = None,
                        match_meta: Optional[dict] = None):
    """Scan-once, open-once shard reader over ``path`` and its per-rank
    ``path.r*`` files.  Candidates are opened and filtered ONE time — by
    ``expected_fingerprint`` AND by the generation of each file's own
    ``/ckpt_meta`` against ``match_meta`` (mixed generations are refused:
    :func:`_generation_ok`) — then the yielded ``fetch(d, name)`` serves
    every per-(row, shard) read from the open files.  A shard absent from
    every same-generation file raises ``KeyError``."""
    h5py = _h5py()

    files = []
    try:
        for cand in _candidates(path):
            try:
                f = h5py.File(cand, "r")
            except OSError:
                continue
            if (_fingerprint_ok(f, expected_fingerprint)
                    and _generation_ok(f, match_meta)):
                files.append(f)
            else:
                f.close()

        def fetch(d: int, name: str = "v") -> np.ndarray:
            key = f"vector_shards/{name}"
            sd = str(d)
            for f in files:
                if key in f and sd in f[key]:
                    return f[key][sd][...]
            raise KeyError(
                f"shard {d} of {name!r} not found under {path}(.r*) in "
                "the restored checkpoint generation")

        yield fetch
    finally:
        for f in files:
            f.close()


def load_hashed_shard(path: str, d: int, name: str = "v",
                      expected_fingerprint: Optional[str] = None
                      ) -> np.ndarray:
    """One shard's rows of a saved hashed vector (pad rows NOT included).
    Looks in ``path`` first, then in any per-rank ``path.r*`` files;
    ``expected_fingerprint`` skips files whose ``/ckpt_meta`` fingerprint
    differs (checkpoint consumers pass it)."""
    h5py = _h5py()

    key = f"vector_shards/{name}"
    for cand in _candidates(path):
        try:
            with h5py.File(cand, "r") as f:
                if not _fingerprint_ok(f, expected_fingerprint):
                    continue
                if key in f and str(d) in f[key]:
                    return f[key][str(d)][...]
        except OSError:
            continue
    raise KeyError(f"shard {d} of {name!r} not found under {path}(.r*)")


def hashed_vector_counts(path: str,
                         expected_fingerprint: Optional[str] = None
                         ) -> Optional[np.ndarray]:
    """The ``counts`` attr of a hashed-vector file, searched across ``path``
    and any per-rank ``path.r*`` files (every rank's file carries the full
    counts array), with :func:`load_hashed_shard`'s stale-file filter."""
    h5py = _h5py()

    for cand in _candidates(path):
        try:
            with h5py.File(cand, "r") as f:
                if not _fingerprint_ok(f, expected_fingerprint):
                    continue
                return np.asarray(f.attrs["counts"], np.int64)
        except (OSError, KeyError):
            continue
    return None
