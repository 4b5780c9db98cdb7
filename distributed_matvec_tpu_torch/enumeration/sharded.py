# Ported from distributed_matvec_tpu/enumeration/sharded.py (the routing loop split from its HDF5 sink; the in-memory sink is the port's own).
"""Distributed-memory enumeration: representatives stream INTO shards.

The reference enumerates representatives *into* distributed memory — per-chunk
locale masks/counts, a count-matrix exchange, then a counting-sort scatter
with one PUT per destination locale (StatesEnumeration.chpl:305-514); no node
ever holds the global array.  This module is the single-host analog with the
same memory property: the native enumeration kernel streams survivor slabs
(bounded buffers), each slab is hash-routed to its owning shard
(``localeIdxOf``, StatesEnumeration.chpl:129-136) and appended to that
shard's on-disk dataset.  Peak memory is one slab + the append buffers —
never the global representative array.

Because the enumeration ranges are disjoint and ascending, each shard's
dataset is automatically SORTED — exactly the per-shard order
:class:`~..parallel.shuffle.HashedLayout` produces, so the shards can feed a
:class:`~..parallel.distributed.DistributedEngine` directly
(``DistributedEngine.from_shards``).

The shard file doubles as a checkpoint (the ``makeBasisStates`` restore
semantics, Diagonalize.chpl:227-246, one level down): re-running with the
same parameters restores instead of re-enumerating.  Totals are validated
against :meth:`SymmetryGroup.sector_dimension_census` — a pure-combinatorics
count (projector trace over the fixed-hamming space) sharing nothing with
the enumeration kernels.  The file layout and the fingerprint are the JAX
package's, so a file written by either package restores in the other.

The routing loop (:func:`_route`) writes through a *sink* — an object with
``append(d, states, norms)`` and ``close(attrs)``.  :func:`enumerate_to_shards`
uses the HDF5 sink; the module-private :class:`_MemorySink` keeps the
shards as host arrays for a machine without ``h5py`` (see its docstring).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Optional

import numpy as np

from . import native as _native
from .host import shard_index
from ..io.hdf5 import _h5py
from ..utils.logging import log_debug as _log_debug

__all__ = ["enumerate_to_shards", "load_shard", "shard_manifest",
           "finalize_shard_parts", "reshard_shards"]

_CHUNK = 1 << 20     # h5py append granularity (8 MB of u64)


def _fingerprint(n_sites, hamming_weight, group, n_shards,
                 norm_tol) -> str:
    h = hashlib.sha256()
    h.update(json.dumps(
        [n_sites, hamming_weight, n_shards, float(norm_tol)]).encode())
    for p in group.perms:
        h.update(np.asarray(p.perm, np.int64).tobytes())
    h.update(np.ascontiguousarray(group.characters).tobytes())
    h.update(np.ascontiguousarray(group.flip).tobytes())
    return h.hexdigest()


def _attrs(n_shards, counts, n_sites, hamming_weight) -> dict:
    """The manifest attributes every shard file carries (the fingerprint
    is written after them, last)."""
    return {"n_shards": n_shards, "counts": counts,
            "total": int(counts.sum()), "n_sites": n_sites,
            "hamming_weight": -1 if hamming_weight is None
            else int(hamming_weight)}


class _H5Sink:
    """Per-shard growable ``representatives`` (u64) and ``norms`` (f64)
    datasets under ``/shards/<d>`` of an open HDF5 file; ``close`` writes
    the manifest attributes with the fingerprint last (the crash-
    consistency convention of the engine-structure sidecars)."""

    def __init__(self, f, n_shards: int):
        self.f = f
        g = f.create_group("shards")
        self.dsets = []
        for d in range(n_shards):
            gd = g.create_group(str(d))
            self.dsets.append((
                gd.create_dataset("representatives", shape=(0,),
                                  maxshape=(None,), dtype=np.uint64,
                                  chunks=(_CHUNK,)),
                gd.create_dataset("norms", shape=(0,), maxshape=(None,),
                                  dtype=np.float64, chunks=(_CHUNK,)),
            ))

    def append(self, d: int, states: np.ndarray, norms: np.ndarray) -> None:
        ds, dn = self.dsets[d]
        o = ds.shape[0]
        ds.resize((o + states.size,))
        dn.resize((o + states.size,))
        ds[o:] = states
        dn[o:] = norms

    def close(self, attrs: dict) -> None:
        fp = attrs.pop("fingerprint")
        for k, v in attrs.items():
            self.f.attrs[k] = v
        self.f.attrs["fingerprint"] = fp


class _MemorySink:
    """The shards as host arrays, in place of the file: what a machine
    without ``h5py`` routes the enumeration into, so the routing loop and
    the shard-native engine build run there on the same code as the
    file route.  Module-private: it is not exported from the package, no
    CLI reaches it, and nothing persists — the enumeration is lost with
    the process.  After ``close`` it gives ``manifest`` (the dict
    :func:`shard_manifest` returns for a file) and ``load(d)`` (what
    :func:`load_shard` returns), which ``DistributedEngine`` takes as its
    private ``_shard_source=(manifest, load)``."""

    def __init__(self, n_shards: int):
        self._parts = [([], []) for _ in range(n_shards)]
        self._shards = None
        self.manifest = None

    def append(self, d: int, states: np.ndarray, norms: np.ndarray) -> None:
        self._parts[d][0].append(states)
        self._parts[d][1].append(norms)

    def close(self, attrs: dict) -> None:
        self._shards = [
            (np.concatenate(s) if s else np.empty(0, np.uint64),
             np.concatenate(n) if n else np.empty(0, np.float64))
            for s, n in self._parts]
        self._parts = None
        self.manifest = {"counts": [int(c) for c in attrs["counts"]],
                         "total": int(attrs["total"]),
                         "n_shards": int(attrs["n_shards"]),
                         "fingerprint": str(attrs["fingerprint"]),
                         "restored": False}

    def load(self, d: int):
        return self._shards[d]


def _route(slabs, n_shards: int, sink, flush_elems: int,
           timings: Optional[dict] = None) -> np.ndarray:
    """Hash-route ascending survivor slabs into ``sink``, one shard's
    pending slices flushed together once ``flush_elems`` accumulate;
    returns the per-shard counts.  A stable argsort by owner keeps each
    shard's slice in the slab's ascending state order, so every shard
    arrives sorted.  ``timings`` (optional) gets ``enumerate_s`` (time
    spent waiting for the next slab) and ``route_s`` (the routing and
    the sink's appends)."""
    D = n_shards
    counts = np.zeros(D, dtype=np.int64)
    pend_s = [[] for _ in range(D)]
    pend_n = [[] for _ in range(D)]
    pending = np.zeros(D, dtype=np.int64)
    t_route = 0.0

    def flush(d):
        if not pending[d]:
            return
        sink.append(d, np.concatenate(pend_s[d]), np.concatenate(pend_n[d]))
        pend_s[d].clear()
        pend_n[d].clear()
        pending[d] = 0

    done = 0
    t_all = time.perf_counter()
    for slab_s, slab_n in slabs:
        t0 = time.perf_counter()
        owner = shard_index(slab_s, D)
        # single-pass scatter: stable sort by owner keeps each shard's
        # slice in the slab's (ascending) state order
        order = np.argsort(owner, kind="stable")
        s_sorted = slab_s[order]
        n_sorted = slab_n[order]
        bounds = np.searchsorted(owner[order], np.arange(D + 1))
        for d in range(D):
            lo, hi = bounds[d], bounds[d + 1]
            if lo == hi:
                continue
            pend_s[d].append(s_sorted[lo:hi])
            pend_n[d].append(n_sorted[lo:hi])
            pending[d] += hi - lo
            counts[d] += hi - lo
            if pending[d] >= flush_elems:
                flush(d)
        done += slab_s.size
        t_route += time.perf_counter() - t0
    t0 = time.perf_counter()
    for d in range(D):
        flush(d)
    t_route += time.perf_counter() - t0
    _log_debug(f"sharded enumeration: {done} representatives routed")
    if timings is not None:
        timings["route_s"] = t_route
        timings["enumerate_s"] = time.perf_counter() - t_all - t_route
    return counts


def _census(group, hamming_weight, total: int, what: str) -> None:
    want = group.sector_dimension_census(hamming_weight)
    if total != want:
        raise RuntimeError(
            f"{what} {total} representatives but the sector-dimension "
            f"census says {want} — enumeration and combinatorics disagree")


def _native_lib():
    lib = _native._load()
    if lib is None:
        raise RuntimeError(
            "sharded enumeration needs the native kernel (g++); "
            "it is not available on this host"
        )
    return lib


def enumerate_to_shards(
    n_sites: int,
    hamming_weight: Optional[int],
    group,
    n_shards: int,
    path: str,
    norm_tol: float = 1e-12,
    n_chunks: Optional[int] = None,
    n_threads: Optional[int] = None,
    census_check: bool = True,
    flush_elems: int = 4 << 20,
    rank: int = 0,
    n_ranks: int = 1,
    _timings: Optional[dict] = None,
) -> dict:
    """Enumerate representatives of the sector straight into per-shard
    datasets at ``path`` (HDF5).  Returns the manifest dict
    ``{"counts": [D], "total": N, "fingerprint": ..., "restored": bool}``.

    Requires the native kernel (the pure-NumPy fallback would make the
    ≥10⁸-candidate configs this exists for intractable).  The file is
    written at ``path + ".tmp"`` and ``os.replace``d: a crash mid-run
    leaves the previous file (if any) in place.

    **Multi-process enumeration**: with ``n_ranks > 1`` this call
    enumerates only rank ``rank``'s CYCLIC set of 64·R equal-index-work
    chunks (``native.rank_state_ranges``) and writes it to
    ``path.part<rank>``; every rank runs the same call concurrently, then
    ONE caller runs :func:`finalize_shard_parts` to census-validate the
    union and write the manifest at ``path``.  Each rank's shard stream
    is internally sorted, but ranks interleave in state space —
    :func:`load_shard` merge-sorts the per-rank slices.

    ``_timings`` (private) receives the enumeration's and the routing's
    seconds apart (``enumerate_s``, ``route_s``).
    """
    h5py = _h5py()

    if not (0 <= rank < n_ranks):
        raise ValueError(f"rank {rank} outside 0..{n_ranks - 1}")
    fp = _fingerprint(n_sites, hamming_weight, group, n_shards, norm_tol)
    state_ranges = None
    if n_ranks > 1:
        path = f"{path}.part{rank}"
        fp = f"{fp}|part{rank}/{n_ranks}c64"   # c64 = cyclic-chunk layout
        census_check = False     # only the union can be censused
        state_ranges = _native.rank_state_ranges(
            n_sites, hamming_weight, rank, n_ranks)
    if os.path.exists(path):
        man = shard_manifest(path)
        if man is not None and man.get("fingerprint") == fp:
            _log_debug(f"sharded enumeration restored from {path}")
            man["restored"] = True
            return man
        # stale file: left in place until the fresh enumeration succeeds
        # (os.replace below swaps it atomically)

    lib = _native_lib()
    D = n_shards
    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        sink = _H5Sink(f, D)
        counts = _route(_native._stream_native(
            lib, n_sites, hamming_weight, group,
            n_chunks=n_chunks, n_threads=n_threads, norm_tol=norm_tol,
            batch_tasks=32, state_ranges=state_ranges), D, sink,
            flush_elems, _timings)
        total = int(counts.sum())
        if census_check:
            _census(group, hamming_weight, total,
                    "sharded enumeration found")
        attrs = _attrs(D, counts, n_sites, hamming_weight)
        if n_ranks > 1:
            attrs["rank"] = rank
            attrs["n_ranks"] = n_ranks
        attrs["fingerprint"] = fp
        sink.close(attrs)
    os.replace(tmp, path)
    _log_debug(f"sharded enumeration: {total} representatives in {D} "
               f"shards at {path}")
    return {"counts": counts.tolist(), "total": total, "fingerprint": fp,
            "restored": False}


def _enumerate_in_memory(n_sites: int, hamming_weight: Optional[int],
                         group, n_shards: int, norm_tol: float = 1e-12,
                         n_chunks: Optional[int] = None,
                         n_threads: Optional[int] = None,
                         census_check: bool = True,
                         flush_elems: int = 4 << 20):
    """The routing of :func:`enumerate_to_shards` into a
    :class:`_MemorySink` — the same slabs, routing, census and
    fingerprint, no file.  Returns ``(sink, timings)``: ``sink.manifest``
    and ``sink.load`` are the engine's ``_shard_source``; ``timings``
    holds ``enumerate_s`` and ``route_s``.  Module-private (see
    :class:`_MemorySink`)."""
    lib = _native_lib()
    sink = _MemorySink(n_shards)
    timings: dict = {}
    counts = _route(_native._stream_native(
        lib, n_sites, hamming_weight, group, n_chunks=n_chunks,
        n_threads=n_threads, norm_tol=norm_tol, batch_tasks=32),
        n_shards, sink, flush_elems, timings)
    if census_check:
        _census(group, hamming_weight, int(counts.sum()),
                "sharded enumeration found")
    attrs = _attrs(n_shards, counts, n_sites, hamming_weight)
    attrs["fingerprint"] = _fingerprint(n_sites, hamming_weight, group,
                                        n_shards, norm_tol)
    sink.close(attrs)
    return sink, timings


def finalize_shard_parts(
    n_sites: int,
    hamming_weight: Optional[int],
    group,
    n_shards: int,
    path: str,
    n_ranks: int,
    norm_tol: float = 1e-12,
    census_check: bool = True,
) -> dict:
    """Combine ``n_ranks`` per-rank part files (from
    :func:`enumerate_to_shards` with ``n_ranks > 1``) into a manifest at
    ``path``.  Run by ONE process after every rank's part exists.

    The manifest holds only counts/attrs and the part count — shard data
    stays in the part files; :func:`load_shard` merge-sorts a shard's
    per-rank slices.  The union total is validated against the
    sector-dimension census.
    """
    h5py = _h5py()

    fp = _fingerprint(n_sites, hamming_weight, group, n_shards, norm_tol)
    man = shard_manifest(path)
    if man is not None and man.get("fingerprint") == fp:
        _log_debug(f"sharded enumeration manifest restored from {path}")
        return man
    counts = np.zeros(n_shards, np.int64)
    for r in range(n_ranks):
        pman = shard_manifest(f"{path}.part{r}")
        want_fp = f"{fp}|part{r}/{n_ranks}c64"
        if pman is None or pman.get("fingerprint") != want_fp:
            raise RuntimeError(
                f"part file {path}.part{r} is missing or does not match "
                "this sector/shard-count/rank-split — run every rank's "
                "enumerate_to_shards first"
            )
        counts += np.asarray(pman["counts"], np.int64)
    total = int(counts.sum())
    if census_check:
        want = group.sector_dimension_census(hamming_weight)
        if total != want:
            raise RuntimeError(
                f"union of {n_ranks} enumeration parts holds {total} "
                f"representatives but the sector-dimension census says "
                f"{want} — a part is incomplete or ranks overlapped"
            )
    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        for k, v in _attrs(n_shards, counts, n_sites,
                           hamming_weight).items():
            f.attrs[k] = v
        f.attrs["parts"] = n_ranks
        f.attrs["fingerprint"] = fp
    os.replace(tmp, path)
    _log_debug(f"sharded enumeration: combined {n_ranks} parts, {total} "
               f"representatives in {n_shards} shards at {path}")
    return {"counts": counts.tolist(), "total": total, "fingerprint": fp,
            "n_shards": n_shards, "parts": n_ranks, "restored": False}


def shard_manifest(path: str) -> Optional[dict]:
    """Counts/total/fingerprint of a shard file, or None if unreadable."""
    h5py = _h5py()

    try:
        with h5py.File(path, "r") as f:
            if "fingerprint" not in f.attrs:
                return None
            man = {"counts": list(map(int, f.attrs["counts"])),
                   "total": int(f.attrs["total"]),
                   "n_shards": int(f.attrs["n_shards"]),
                   "fingerprint": str(f.attrs["fingerprint"]),
                   "restored": True}
            if "parts" in f.attrs:
                man["parts"] = int(f.attrs["parts"])
            return man
    except OSError:
        return None


def reshard_shards(src_path: str, dst_path: str, n_shards: int,
                   group=None, norm_tol: float = 1e-12) -> dict:
    """Re-route an existing shard file onto a different shard count.

    New shard ``d`` collects every state with ``hash64 % n_shards == d``
    from each old shard, and is sorted again afterwards (appends from
    successive old shards interleave in state space).  Peak memory is one
    old shard plus one new shard, never the global array.

    With ``group`` the new file carries the exact fingerprint a direct
    enumeration at ``n_shards`` would (restore-compatible) — after the
    group is checked against the source file's fingerprint; without it a
    derived ``reshard(<old_fp>, D)`` fingerprint.  The total is validated
    against the source manifest.
    """
    h5py = _h5py()

    man = shard_manifest(src_path)
    if man is None:
        raise ValueError(f"no shard manifest at {src_path}")
    old_D = man["n_shards"]
    with h5py.File(src_path, "r") as f:
        n_sites = int(f.attrs["n_sites"])
        hamming_weight = int(f.attrs["hamming_weight"])
    if hamming_weight < 0:
        hamming_weight = None
    if group is not None:
        # the total-vs-manifest check below is group-independent and
        # cannot catch a wrong momentum sector
        want_src = _fingerprint(n_sites, hamming_weight, group, old_D,
                                norm_tol)
        if man["fingerprint"] != want_src:
            raise ValueError(
                "the given symmetry group does not match the source shard "
                f"file at {src_path} (fingerprint mismatch) — pass the "
                "group the file was enumerated with, or omit it to get a "
                "derived reshard fingerprint")
        fp = _fingerprint(n_sites, hamming_weight, group, n_shards, norm_tol)
    else:
        fp = hashlib.sha256(
            f"reshard({man['fingerprint']},{n_shards})".encode()).hexdigest()
    existing = shard_manifest(dst_path)
    if existing is not None and existing.get("fingerprint") == fp:
        _log_debug(f"reshard manifest restored from {dst_path}")
        return existing
    counts = np.zeros(n_shards, np.int64)
    tmp = dst_path + ".tmp"
    with h5py.File(tmp, "w") as fout:
        # pass 1: one scan of the source, each old shard's rows appended
        # to the owning new shards
        sink = _H5Sink(fout, n_shards)
        for d_old in range(old_D):
            s, w = load_shard(src_path, d_old)
            own = shard_index(s, n_shards)
            order = np.argsort(own, kind="stable")
            bounds = np.searchsorted(own[order], np.arange(n_shards + 1))
            for d_new in range(n_shards):
                lo, hi = bounds[d_new], bounds[d_new + 1]
                if lo == hi:
                    continue
                sink.append(d_new, s[order[lo:hi]], w[order[lo:hi]])
                counts[d_new] += hi - lo
            _log_debug(f"reshard: routed old shard {d_old} ({s.size} "
                       "states)")
        # pass 2: restore each new shard's sorted order (a k-way merge
        # done as a stable argsort, one new shard in memory at a time)
        for d_new in range(n_shards):
            ds, dn = sink.dsets[d_new]
            s = ds[...]
            if s.size and not (s[:-1] <= s[1:]).all():
                order = np.argsort(s, kind="stable")
                ds[:] = s[order]
                dn[:] = dn[...][order]
            _log_debug(f"reshard: new shard {d_new} holds {s.size} states")
        total = int(counts.sum())
        if total != man["total"]:
            raise RuntimeError(
                f"reshard routed {total} states, source manifest says "
                f"{man['total']} — hash routing disagrees with the source")
        attrs = _attrs(n_shards, counts, n_sites, hamming_weight)
        attrs["fingerprint"] = fp
        sink.close(attrs)
    os.replace(tmp, dst_path)
    _log_debug(f"reshard: {old_D} → {n_shards} shards at {dst_path}")
    return {"counts": counts.tolist(), "total": total, "fingerprint": fp,
            "n_shards": n_shards, "restored": False}


def load_shard(path: str, d: int):
    """(representatives, norms) of one shard — sorted ascending, u64 and
    f64; only this shard's data is read into memory.  For a multi-process
    manifest the shard is the MERGE of the part files' slices (each
    internally sorted, interleaved in state space: a stable argsort over
    the concatenation restores the per-shard order)."""
    h5py = _h5py()

    with h5py.File(path, "r") as f:
        if "parts" in f.attrs:
            n_ranks = int(f.attrs["parts"])
        else:
            g = f["shards"][str(d)]
            return g["representatives"][...], g["norms"][...]
    reps, norms = [], []
    for r in range(n_ranks):
        with h5py.File(f"{path}.part{r}", "r") as f:
            g = f["shards"][str(d)]
            reps.append(g["representatives"][...])
            norms.append(g["norms"][...])
    reps = np.concatenate(reps)
    norms = np.concatenate(norms)
    if reps.size and not (reps[:-1] <= reps[1:]).all():
        order = np.argsort(reps, kind="stable")
        reps, norms = reps[order], norms[order]
    return reps, norms
