# Ported from distributed_matvec_tpu/parallel/distributed.py (the plan sidecars' names, checksum and prefetcher; the sidecar stores are new).
"""What the engine's plan caches share: sidecar names, the per-record
checksum, the stores the sidecars live in, and the plan prefetcher.

A ``DistributedEngine`` keeps its ell/compact routing plan in a
*structure* sidecar and its streamed (or hybrid) plan in a *stream*
sidecar, both next to one base path: ``path + ".dist{D}.{kind}.h5"``
(:func:`sidecar_name`), and ``….r<rank>`` per rank when a
``torch.distributed`` group of more than one rank is up.  The JAX engine
names its sidecars the same way; the port's fingerprints carry a port tag,
so neither package restores the other's.

A sidecar is one group ``engine_structure`` of attributes (scalars, the
fingerprint last) and datasets, written atomically.  Where it lives is a
*store*:

* :class:`Hdf5SidecarStore` — HDF5 files through ``io/hdf5.py`` (the
  default; ``h5py`` is imported when a file is opened or written);
* :class:`_MemorySidecarStore` — the same attributes and datasets in host
  memory, keyed by path.  Module-private: the engine takes it only through
  its private ``_sidecar_store=`` argument, for a machine without
  ``h5py`` where the disk tier's checks, staging and rebuild must still
  run.  No public entry point falls back to it.

:class:`PlanPrefetcher` fetches a streamed plan's chunks on worker threads
ahead of a pipelined apply (the disk tier's reads and checksums, and any
injected ``plan_upload`` latency), while the apply thread alone records
events and queues copies.
"""

from __future__ import annotations

import fnmatch
import glob
import os
import re
import threading
import time
import zlib
from typing import Dict, Optional

import numpy as np

__all__ = ["sidecar_name", "SIDECAR_RE", "STREAM_ARRAYS", "plan_chunk_crc",
           "close_plan_files", "process_rank", "Hdf5SidecarStore",
           "PlanPrefetcher"]


# Copied from distributed_matvec_tpu/parallel/distributed.py (_sidecar_name).
def sidecar_name(d: int, kind: str) -> str:
    """The per-D plan-sidecar suffix — the one definition; :data:`SIDECAR_RE`
    parses the device count back out."""
    return f".dist{d}.{kind}.h5"


#: inverse of :func:`sidecar_name`: the device count of a sidecar of either
#: kind (JAX ``_SIDECAR_RE``)
SIDECAR_RE = re.compile(r"\.dist(\d+)\.(?:stream|structure)\.h5$")

#: the four arrays of one (chunk, shard) record in the JAX engine's form,
#: in the checksum's order (JAX ``DistributedEngine._STREAM_ARRAYS``)
STREAM_ARRAYS = ("dest", "coeff", "ridx", "rok")


# Copied from distributed_matvec_tpu/parallel/distributed.py (_plan_chunk_crc).
def plan_chunk_crc(pc: dict, keys=STREAM_ARRAYS) -> int:
    """CRC32 over one (chunk, shard) record's arrays in ``keys`` order — the
    check the disk tier makes on every read and a RAM restore once."""
    c = 0
    for k in keys:
        c = zlib.crc32(np.ascontiguousarray(pc[k]).tobytes(), c)
    return c


# Copied from distributed_matvec_tpu/parallel/distributed.py (_close_plan_files).
def close_plan_files(files: dict) -> None:
    """Close a streamed engine's cached disk-tier handles (the engine's
    ``weakref.finalize`` target: a process building many disk-tier engines
    must not accumulate open descriptors)."""
    for f in files.values():
        try:
            f.close()
        except Exception:
            pass
    files.clear()


def process_rank() -> Optional[int]:
    """This process's rank when a ``torch.distributed`` group of more than
    one rank is up (the JAX ``jax.process_count() > 1`` test), else None:
    the ``.r<rank>`` suffix of a rank's own sidecar."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return int(dist.get_rank())
    return None


# -- stores ---------------------------------------------------------------------


class Hdf5SidecarStore:
    """Sidecars as HDF5 files: ``save`` is ``io/hdf5.py``'s atomic
    ``save_engine_structure`` (a soft save through
    ``utils/artifacts.py::soft_save_structure``, capped by
    ``artifact_max_gb``), ``open`` an ``h5py.File`` whose
    ``["engine_structure"]`` group the engine reads, and a corrupt read
    feeds the artifact layer's corrupt/quarantine tally."""

    @staticmethod
    def glob(pattern: str):
        return sorted(glob.glob(pattern))

    @staticmethod
    def exists(path: str) -> bool:
        return os.path.exists(path)

    @staticmethod
    def open(path: str):
        from ..io.hdf5 import _h5py

        return _h5py().File(path, "r")

    @staticmethod
    def save(path: str, fingerprint: str, mode: str, payload: dict,
             soft: bool) -> bool:
        if soft:
            from ..utils.artifacts import soft_save_structure
            return soft_save_structure(path, fingerprint, mode, payload)
        from ..io.hdf5 import save_engine_structure
        save_engine_structure(path, fingerprint, mode, payload)
        return True

    @staticmethod
    def note_corrupt(path: str, kind: str, error) -> bool:
        from ..utils.artifacts import note_artifact_corrupt
        return note_artifact_corrupt(path, kind, error)


class _MemGroup:
    """An ``engine_structure`` group held in memory: ``attrs`` and the
    datasets by name, read as ``g[name][...]``."""

    def __init__(self, attrs: dict, data: Dict[str, np.ndarray]):
        self.attrs = attrs
        self.data = data

    def __contains__(self, name: str) -> bool:
        return name in self.data

    def __getitem__(self, name: str) -> np.ndarray:
        return self.data[name]

    def __iter__(self):
        return iter(self.data)


class _MemFile:
    """A handle on one in-memory sidecar, shaped like an ``h5py.File``."""

    def __init__(self, group: _MemGroup):
        self._group = group

    def __contains__(self, name: str) -> bool:
        return name == "engine_structure"

    def __getitem__(self, name: str) -> _MemGroup:
        if name != "engine_structure":
            raise KeyError(name)
        return self._group

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass

    def close(self) -> None:
        pass


class _MemorySidecarStore:
    """Sidecars in host memory, keyed by path: the same attributes and
    datasets an HDF5 sidecar holds (host copies, the fingerprint set last),
    read through the same group interface.  A corrupt read is counted
    (``artifact_cache{event=corrupt}``); a second one on the same path drops
    the entry, as the file store quarantines its file."""

    def __init__(self):
        self.files: Dict[str, _MemGroup] = {}
        self._failures: Dict[str, int] = {}

    def glob(self, pattern: str):
        return sorted(p for p in self.files if fnmatch.fnmatchcase(p, pattern))

    def exists(self, path: str) -> bool:
        return path in self.files

    def open(self, path: str) -> _MemFile:
        try:
            return _MemFile(self.files[path])
        except KeyError:
            raise FileNotFoundError(path) from None

    def save(self, path: str, fingerprint: str, mode: str, payload: dict,
             soft: bool) -> bool:
        from ..io.hdf5 import _host

        if soft:
            from ..utils.artifacts import within_size_cap
            nbytes = sum(getattr(v, "nbytes", 0) for v in payload.values())
            if not within_size_cap(nbytes):
                return False
        attrs, data = {"mode": mode}, {}
        for k, v in payload.items():
            if v is None:
                continue
            if np.isscalar(v):
                attrs[k] = v
            else:
                data[k] = np.array(_host(v), copy=True)
        attrs["fingerprint"] = fingerprint
        self.files[path] = _MemGroup(attrs, data)
        self._failures.pop(path, None)
        return True

    def note_corrupt(self, path: str, kind: str, error) -> bool:
        from ..utils.artifacts import record_cache_event
        from ..utils.logging import log_warn

        record_cache_event(kind, "corrupt")
        n = self._failures.get(path, 0) + 1
        self._failures[path] = n
        if n < 2:
            log_warn(f"corrupt {kind} sidecar {path} in memory ({error!r})")
            return False
        self.files.pop(path, None)
        self._failures.pop(path, None)
        record_cache_event(kind, "quarantine")
        return True


# -- the prefetcher ---------------------------------------------------------------


# Copied from distributed_matvec_tpu/parallel/distributed.py (_PlanPrefetcher).
class PlanPrefetcher:
    """Depth-bounded background fetch of streamed plan chunks — the
    pipelined apply's host side.

    Worker threads run :meth:`DistributedEngine._fetch_plan_chunk` (with
    ``degrade=False``) up to ``depth`` chunks ahead of the consumer, so the
    disk tier's read and checksum (and any injected ``plan_upload``
    latency) overlap the apply; the consumer's measured :meth:`get` wait is
    the exposed part.  One worker on the disk tier (h5py handles are not
    thread-safe), else ``min(prefetch_workers or depth, depth, 4)``.  The
    workers only fetch and pack host bytes: the apply thread records every
    event and queues every copy.  A read failure comes back as a
    ``"degrade"`` marker, repaired on the apply thread; any other worker
    error is re-raised there."""

    def __init__(self, eng, nchunks: int, depth: int, start: int = 0):
        self._eng = eng
        self._n = int(nchunks)
        self._depth = max(int(depth), 1)
        self._cv = threading.Condition()
        self._ready: dict = {}
        self._consumed = int(start) - 1
        self._next = int(start)
        self._stop = False
        tuned_w = getattr(eng, "_tune_workers", None)
        n_workers = 1 if eng._plan_disk is not None \
            else min(tuned_w or self._depth, self._depth, 4)
        self._threads = [
            threading.Thread(target=self._work, daemon=True,
                             name=f"dmt-plan-prefetch-{k}")
            for k in range(min(n_workers, self._n - int(start)) or 1)]
        for t in self._threads:
            t.start()

    def _work(self) -> None:
        while True:
            with self._cv:
                while (not self._stop and self._next < self._n
                       and self._next > self._consumed + self._depth):
                    self._cv.wait()
                if self._stop or self._next >= self._n:
                    return
                ci = self._next
                self._next += 1
            t0 = time.perf_counter()
            try:
                res = ("ok", self._eng._fetch_plan_chunk(ci, degrade=False),
                       (time.perf_counter() - t0) * 1e3)
            except (OSError, KeyError, ValueError) as e:
                # a read failure whose repair belongs on the apply thread
                res = ("degrade", e, (time.perf_counter() - t0) * 1e3)
            except BaseException as e:       # re-raised by the consumer
                res = ("err", e, 0.0)
            with self._cv:
                self._ready[ci] = res
                self._cv.notify_all()

    def get(self, ci: int):
        """Block until chunk ``ci`` is fetched; returns ``(kind, value,
        stage_ms, wait_ms)``: ``kind`` ``"ok"`` (value: the chunk's host
        records) or ``"degrade"`` (value: the read failure), the worker's
        fetch wall and the consumer's exposed wait.  Worker errors
        re-raise here."""
        t0 = time.perf_counter()
        with self._cv:
            while ci not in self._ready:
                self._cv.wait()
            kind, val, stage_ms = self._ready.pop(ci)
            self._consumed = max(self._consumed, ci)
            self._cv.notify_all()
        if kind == "err":
            self.close()
            raise val
        return kind, val, stage_ms, (time.perf_counter() - t0) * 1e3

    def close(self, join: bool = False) -> None:
        """Stop the workers; ``join=True`` also waits them out, so none
        still holds the sidecar handles a repair is about to touch."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if join:
            for t in self._threads:
                t.join()
