# Copied from distributed_matvec_tpu/enumeration/native.py.
"""ctypes loader + runner for the C++ enumeration kernel (``_native.cpp``).

The reference's enumeration is native (Haskell/C kernels called in 10240-state
batches, StatesEnumeration.chpl:158-200) and parallel (dynamic chunking over
tasks, :321-334).  This wrapper:

  * compiles ``_native.cpp`` on first use with g++ (-O3 -march=native) and
    caches the .so in the checkout's git-ignored ``build/`` directory (falls
    back to the pure-NumPy path in ``host.py`` if no compiler is available),
  * splits the search range into equal-*index*-work chunks via the
    fixed-hamming rank/unrank (``determineEnumerationRanges``,
    StatesEnumeration.chpl:94-113),
  * orders group elements cheap-first (ascending network width) so the
    early-exit orbit scan rejects most candidates after a couple of cheap
    translations before ever touching expensive elements,
  * streams: memory is bounded by the per-chunk survivor buffers, never by
    the candidate count.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import sys
import threading
from typing import Optional, Tuple

import numpy as np

from . import host as _host
from ..utils.build import build_dir

log_debug = logging.getLogger(__name__).debug

__all__ = ["native_available", "enumerate_representatives_native",
           "lookup_owners", "full_state_range", "rank_state_ranges"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "_native.cpp")
_SO_NAME = f"_native_{sys.platform}.so"
_lock = threading.Lock()
_lib = None
_lib_failed = False


class _Group(ctypes.Structure):
    _fields_ = [
        ("mask", ctypes.POINTER(ctypes.c_uint64)),
        ("lshift", ctypes.POINTER(ctypes.c_uint64)),
        ("rshift", ctypes.POINTER(ctypes.c_uint64)),
        ("xor_mask", ctypes.POINTER(ctypes.c_uint64)),
        ("char_real", ctypes.POINTER(ctypes.c_double)),
        ("g", ctypes.c_int64),
        ("s", ctypes.c_int64),
    ]


def _build() -> Optional[str]:
    so_path = os.path.join(build_dir("dmt_torch_native"), _SO_NAME)
    if os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(_SRC):
        return so_path
    # compile to a temp name and rename: writing the .so in place would
    # clobber the text mapping of any process that already dlopened it
    # (a long-running enumeration would SIGBUS mid-flight)
    tmp = so_path + f".build{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-o", tmp, _SRC, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return so_path
    except Exception as e:  # no compiler / read-only FS → NumPy fallback
        log_debug(f"native enumeration unavailable ({e}); using NumPy path")
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def _load():
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = _build()
        if so is None:
            _lib_failed = True
            return None
        lib = ctypes.CDLL(so)
        lib.dmt_enumerate_ranges.restype = ctypes.c_int64
        lib.dmt_enumerate_ranges.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(_Group), ctypes.c_double,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]
        lib.dmt_fill_fixed_hamming.restype = ctypes.c_int64
        lib.dmt_fill_fixed_hamming.argtypes = [
            ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ]
        lib.dmt_lookup_owners.restype = ctypes.c_int64
        lib.dmt_lookup_owners.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _group_tables_cheap_first(group):
    """Shift/mask tables with elements sorted by network width (identity
    first) — the early-exit scan meets cheap translations before expensive
    reflections."""
    ls, rs, ms, xor = group.shift_mask_tables()
    widths = np.array([(m != 0).sum() for m in ms])
    widths[0] = -1  # identity stays first
    order = np.argsort(widths, kind="stable")
    return (ls[order], rs[order], ms[order], xor[order],
            group.characters.real[order].copy())


def _ranges(lo: int, hi: int, hamming: Optional[int], n_chunks: int):
    """Equal-index-work split of [lo, hi] (determineEnumerationRanges)."""
    if hamming is None or hamming == 0:
        edges = np.linspace(lo, hi + 1, n_chunks + 1, dtype=np.uint64)
        starts = edges[:-1].copy()
        ends = np.maximum(edges[1:], 1) - 1
        keep = starts <= ends
        return starts[keep], ends[keep]
    r_lo = int(_host.fixed_hamming_rank(np.uint64(lo))[0])
    r_hi = int(_host.fixed_hamming_rank(np.uint64(hi))[0])
    total = r_hi - r_lo + 1
    n_chunks = max(1, min(n_chunks, total))
    idx = np.linspace(r_lo, r_hi + 1, n_chunks + 1).astype(np.int64)
    starts, ends = [], []
    for i in range(n_chunks):
        if idx[i] >= idx[i + 1]:
            continue
        starts.append(_host.fixed_hamming_unrank(idx[i], hamming))
        ends.append(_host.fixed_hamming_unrank(idx[i + 1] - 1, hamming))
    return (np.array(starts, dtype=np.uint64), np.array(ends, dtype=np.uint64))


def full_state_range(n_sites: int, hamming_weight: Optional[int]):
    """[lo, hi] of the full candidate range for the sector."""
    lo = (1 << hamming_weight) - 1 if hamming_weight else 0
    hi = (lo << (n_sites - hamming_weight)) if hamming_weight \
        else (1 << n_sites) - 1
    if hamming_weight == 0:
        lo = hi = 0
    return lo, hi


def rank_state_ranges(n_sites: int, hamming_weight: Optional[int],
                      rank: int, n_ranks: int, oversub: int = 64):
    """CYCLIC equal-index-work chunk assignment for one rank of ``n_ranks``
    enumerating processes — the cross-process analog of the reference's
    per-locale dynamic chunk scheduling (StatesEnumeration.chpl:321-334),
    split in fixed-hamming *index* space (determineEnumerationRanges,
    :94-113).

    Equal candidate counts are NOT equal representative counts: canonical
    (orbit-minimal) representatives pile up at numerically small states,
    so one contiguous slice per rank would hand essentially all survivors
    to rank 0 (measured: 4 707 968 of 4 707 969 on chain_32_symm).
    ``oversub``·n_ranks chunks dealt round-robin average the density out
    while keeping each rank's chunk sequence ascending — every rank's
    part file stays internally sorted, and :func:`..sharded.load_shard`
    merge-sorts the per-rank slices.  Returns a (possibly empty) list of
    inclusive (lo, hi) ranges."""
    lo, hi = full_state_range(n_sites, hamming_weight)
    starts, ends = _ranges(lo, hi, hamming_weight, n_ranks * oversub)
    return [(int(s), int(e))
            for i, (s, e) in enumerate(zip(starts, ends))
            if i % n_ranks == rank]


def _stream_native(
    lib,
    n_sites: int,
    hamming_weight: Optional[int],
    group,
    n_chunks: Optional[int] = None,
    n_threads: Optional[int] = None,
    norm_tol: float = 1e-12,
    batch_tasks: int = 256,
    state_ranges=None,
):
    """Generator over (states, norms) survivor slabs in ascending state
    order — the chunk ranges are disjoint and ascending, so concatenating
    the slabs (or routing them anywhere) preserves global sortedness.
    Memory is bounded by one task batch's buffers.

    ``state_ranges=[(lo, hi), ...]`` restricts the scan to the given
    ascending disjoint sub-ranges (inclusive) — the multi-process
    enumeration path hands each rank its cyclic chunk set
    (:func:`rank_state_ranges`)."""
    lo, hi = full_state_range(n_sites, hamming_weight)

    ls, rs, ms, xor, chr_ = _group_tables_cheap_first(group)
    G, S = ms.shape
    grp = _Group(
        ms.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ls.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        rs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        np.ascontiguousarray(xor).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint64)),
        np.ascontiguousarray(chr_).ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)),
        G, S,
    )
    # keep the numpy arrays alive for the duration of the call
    keepalive = (ls, rs, ms, xor, chr_)

    n_threads = n_threads or os.cpu_count() or 1
    if n_chunks is None:
        n_chunks = max(4 * n_threads, 64)
    if state_ranges is not None:
        if not state_ranges:
            return
        per = max(1, n_chunks // len(state_ranges))
        parts = [_ranges(rlo, rhi, hamming_weight, per)
                 for rlo, rhi in state_ranges]
        starts = np.concatenate([p[0] for p in parts])
        ends = np.concatenate([p[1] for p in parts])
    else:
        starts, ends = _ranges(lo, hi, hamming_weight, n_chunks)
    ntasks = starts.size
    if ntasks == 0:
        return

    # Survivor capacity per task: candidates/G is the expectation; give 4×
    # headroom + constant. On overflow (-1) retry with the exact bound.
    # process tasks in batches to bound memory (smaller batches yield
    # earlier — at huge candidate counts the first, representative-dense
    # ranges alone can take many minutes)
    batch = max(1, min(ntasks, batch_tasks))
    use_h = 1 if hamming_weight not in (None, 0) else 0
    for b0 in range(0, ntasks, batch):
        b1 = min(b0 + batch, ntasks)
        nb = b1 - b0
        s_b = np.ascontiguousarray(starts[b0:b1])
        e_b = np.ascontiguousarray(ends[b0:b1])
        # per-task capacity: index span (exact candidate count) if cheap,
        # else a heuristic; overflow retries below with bigger buffers.
        if use_h:
            spans = (_host.fixed_hamming_rank(e_b).astype(np.int64)
                     - _host.fixed_hamming_rank(s_b).astype(np.int64) + 1)
        else:
            spans = (e_b - s_b + 1).astype(np.int64)
        caps = np.minimum(spans, np.maximum(spans // max(G // 4, 1), 4096))
        while True:
            offsets = np.zeros(nb, dtype=np.int64)
            offsets[1:] = np.cumsum(caps)[:-1]
            total_cap = int(caps.sum())
            buf_s = np.empty(total_cap, dtype=np.uint64)
            buf_n = np.empty(total_cap, dtype=np.float64)
            counts = np.zeros(nb, dtype=np.int64)
            rc = lib.dmt_enumerate_ranges(
                s_b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                e_b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                nb, use_h, ctypes.byref(grp), norm_tol,
                buf_s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                buf_n.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                caps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                int(n_threads),
            )
            if rc == 0:
                break
            caps = spans  # exact upper bound — cannot overflow
        for t in range(nb):
            o, c = offsets[t], counts[t]
            if c:
                yield buf_s[o:o + c].copy(), buf_n[o:o + c].copy()
    del keepalive


def enumerate_representatives_native(
    n_sites: int,
    hamming_weight: Optional[int],
    group,
    n_chunks: Optional[int] = None,
    n_threads: Optional[int] = None,
    norm_tol: float = 1e-12,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Streaming native enumeration; None if the kernel is unavailable.

    Matches :func:`host.enumerate_representatives` exactly (same order,
    same norms) — property-tested in tests/test_enumeration.py.
    """
    lib = _load()
    if lib is None:
        return None
    parts_s, parts_n = [], []
    for s, n in _stream_native(lib, n_sites, hamming_weight, group,
                               n_chunks, n_threads, norm_tol):
        parts_s.append(s)
        parts_n.append(n)
    if not parts_s:
        return (np.empty(0, np.uint64), np.empty(0, np.float64))
    return np.concatenate(parts_s), np.concatenate(parts_n)


def lookup_owners(betas: np.ndarray, alphas: np.ndarray,
                  counts: np.ndarray,
                  n_threads: Optional[int] = None):
    """(owner, idx, found) for each state in ``betas`` against the per-shard
    sorted representative prefixes ``alphas[d][:counts[d]]`` — the routing
    plan's host loop in one threaded native pass.  Returns None when the
    kernel is unavailable (callers fall back to NumPy)."""
    lib = _load()
    if lib is None:
        return None
    betas = np.ascontiguousarray(betas, np.uint64)
    alphas = np.ascontiguousarray(alphas, np.uint64)
    counts = np.ascontiguousarray(counts, np.int64)
    D, M = alphas.shape
    n = betas.size
    owner = np.empty(n, np.int32)
    idx = np.empty(n, np.int32)
    found = np.empty(n, np.uint8)
    lib.dmt_lookup_owners(
        betas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n,
        alphas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        D, M,
        owner.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        found.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(n_threads or os.cpu_count() or 1),
    )
    return owner, idx, found.astype(bool)
