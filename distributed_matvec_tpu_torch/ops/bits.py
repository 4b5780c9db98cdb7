"""Bit manipulation on basis states: popcount, shard hashing, state lookup.

PyTorch counterpart of ``distributed_matvec_tpu/ops/bits.py``.  States are
u64 bit patterns held in int64 tensors; the unsigned operations go through
:mod:`..utils.u64`.  :func:`choose_dir_bits` and :func:`build_sorted_lookup`
are host NumPy, copied from the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import u64

__all__ = ["popcount64", "sign_from_parity", "hash64", "shard_index",
           "choose_dir_bits", "build_sorted_lookup", "state_index_bucketed"]

_SPLITMIX_1 = u64.as_signed(0xBF58476D1CE4E5B9)
_SPLITMIX_2 = u64.as_signed(0x94D049BB133111EB)


def popcount64(x: torch.Tensor) -> torch.Tensor:
    return u64.popcount(x)


def sign_from_parity(x: torch.Tensor) -> torch.Tensor:
    """(−1)^popcount(x) as f64: +1 for even parity, −1 for odd."""
    return 1.0 - 2.0 * (popcount64(x) & 1).to(torch.float64)


def hash64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer — bit-exact with ``enumeration.host.hash64``
    (the int64 multiply wraps exactly as the u64 one)."""
    x = (x ^ u64.srl(x, 30)) * _SPLITMIX_1
    x = (x ^ u64.srl(x, 27)) * _SPLITMIX_2
    return x ^ u64.srl(x, 31)


def shard_index(states: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owning shard of each state: ``hash64(σ) % D`` taken unsigned."""
    if n_shards == 1:
        return torch.zeros(states.shape, dtype=torch.int32,
                           device=states.device)
    return u64.umod(hash64(states), n_shards).to(torch.int32)


# Copied from distributed_matvec_tpu/ops/bits.py (host NumPy).
def choose_dir_bits(n: int, n_bits: int, max_dir_bits: int = 24) -> int:
    """Directory width for an ``n``-entry basis over ``n_bits``-bit states:
    ~1-entry average buckets, capped by the state width and a memory bound
    (2^24 × i32 = 64 MB)."""
    return min(max(n_bits, 1),
               max(int(np.ceil(np.log2(max(n, 2)))) + 1, 1), max_dir_bits)


# Copied from distributed_matvec_tpu/ops/bits.py (host NumPy).
def build_sorted_lookup(reps, n_bits: int, max_dir_bits: int = 24,
                        dir_bits: int | None = None):
    """Precompute the bucket-directory lookup structure for a sorted basis:
    a directory over the top ``b`` state bits yields a ≲ few-entry bucket,
    and the remaining probes compare (hi, lo) u32 pairs.

    Returns ``(pair [N,2] u32, dir [2^b+1] i32, shift, probes)`` — arrays
    are NumPy, ``shift``/``probes`` are Python ints.
    """
    reps = np.asarray(reps, dtype=np.uint64)
    n = int(reps.size)
    b = dir_bits if dir_bits is not None \
        else choose_dir_bits(n, n_bits, max_dir_bits)
    shift = n_bits - b
    edges = np.arange(1 << b, dtype=np.uint64) << np.uint64(shift)
    dir_tab = np.empty((1 << b) + 1, np.int32)
    dir_tab[: 1 << b] = np.searchsorted(reps, edges)
    dir_tab[1 << b] = n                     # 2^n_bits would overflow u64
    max_bucket = int((dir_tab[1:] - dir_tab[:-1]).max()) if n else 0
    probes = max(1, int(np.ceil(np.log2(max_bucket + 1)))) if max_bucket \
        else 1
    pair = np.stack([(reps >> np.uint64(32)).astype(np.uint32),
                     reps.astype(np.uint32)], axis=1)
    return pair, dir_tab, shift, probes


def state_index_bucketed(pair: torch.Tensor, dir_tab: torch.Tensor,
                         states: torch.Tensor, *, shift: int, probes: int):
    """(index, found) of each state via the directory from
    :func:`build_sorted_lookup`.

    ``pair`` is the [N, 2] (hi, lo) u32 table widened to int64, ``dir_tab``
    the [2^b + 1] directory (any integer type).  Out-of-range states (e.g.
    SENTINEL-derived garbage) clamp into the last bucket and report
    ``found=False``.  Returns (int64 index, bool found).
    """
    n = pair.shape[0]
    # clamp unsigned BEFORE indexing: a garbage state (e.g. SENTINEL) would
    # otherwise index the directory from the end
    k = u64.umin(u64.srl(states, shift), dir_tab.shape[0] - 2)
    lo = dir_tab[k].to(torch.int64)
    hi = dir_tab[k + 1].to(torch.int64)
    s_hi = u64.srl(states, 32)
    s_lo = states & 0xFFFFFFFF
    for _ in range(probes):
        mid = (lo + hi) >> 1
        g = pair[torch.clamp(mid, max=n - 1)]
        ge = (g[..., 0] > s_hi) | ((g[..., 0] == s_hi) & (g[..., 1] >= s_lo))
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    idx = torch.clamp(lo, max=max(n - 1, 0))
    g = pair[idx]
    found = (g[..., 0] == s_hi) & (g[..., 1] == s_lo)
    return idx, found
