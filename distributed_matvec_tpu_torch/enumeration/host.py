# Copied from distributed_matvec_tpu/enumeration/host.py
"""Host-side (NumPy) basis-state enumeration.

Re-implements the behavior of ``reference src/StatesEnumeration.chpl``:
  * ``next_state_fixed_hamming`` — bit trick (StatesEnumeration.chpl:31-34),
  * fixed-Hamming rank/unrank (combinatorial number system) used for equal-work
    range splitting (``determineEnumerationRanges``, StatesEnumeration.chpl:94-113;
    the reference calls into ``ls_hs_fixed_hamming_state_to_index``),
  * the splitmix64-finalizer shard hash (StatesEnumeration.chpl:122-136),
  * the three enumeration paths — projected (batched is_representative,
    StatesEnumeration.chpl:158-200), unprojected with spin-inversion bound
    tightening (:201-224), and the general full-range path.

Instead of the serial next-state loop, the full fixed-Hamming state list is
produced by a *colexicographic recursion*::

    S(n, k) = S(n-1, k)  ⊎  (S(n-1, k-1) | 1<<(n-1))

which emits states in increasing numeric order using pure array concatenation —
the vectorized, cache-friendly equivalent of the reference's bit-trick loop.
The streaming C++ kernel (``_native.cpp`` via ``native.py``) takes over for
projected sectors; this module is the portable reference path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "next_state_fixed_hamming",
    "fixed_hamming_states",
    "fixed_hamming_rank",
    "fixed_hamming_unrank",
    "hash64",
    "shard_index",
    "enumerate_representatives",
]

_U1 = np.uint64(1)


def next_state_fixed_hamming(v: int) -> int:
    """Next integer with the same popcount (StatesEnumeration.chpl:31-34)."""
    v = int(v)
    t = v | (v - 1)
    ctz = (v & -v).bit_length() - 1
    return ((t + 1) | (((~t & (t + 1)) - 1) >> (ctz + 1))) & 0xFFFFFFFFFFFFFFFF


# ---------------------------------------------------------------------------
# Binomials / rank / unrank (exact in uint64 — C(64,32) < 2^64)
# ---------------------------------------------------------------------------

def _binomial_table(nmax: int = 65) -> np.ndarray:
    c = np.zeros((nmax, nmax), dtype=np.uint64)
    c[:, 0] = 1
    for n in range(1, nmax):
        for k in range(1, n + 1):
            c[n, k] = c[n - 1, k - 1] + c[n - 1, k]
    return c


_BINOM = _binomial_table()


def fixed_hamming_rank(states: np.ndarray) -> np.ndarray:
    """Rank in the sorted list of same-popcount integers (combinatorial number
    system) — behavior of ``ls_hs_fixed_hamming_state_to_index``
    (reference src/FFI.chpl:165)."""
    states = np.atleast_1d(np.asarray(states, dtype=np.uint64))
    rank = np.zeros(states.shape, dtype=np.uint64)
    rem = states.copy()
    idx = np.zeros(states.shape, dtype=np.uint64)
    while True:
        nz = rem != 0
        if not nz.any():
            break
        # position of lowest set bit
        low = rem & (~rem + _U1)
        pos = np.zeros_like(rem)
        for sh in (32, 16, 8, 4, 2, 1):
            big = low >= (_U1 << np.uint64(sh))
            pos = np.where(big, pos + np.uint64(sh), pos)
            low = np.where(big, low >> np.uint64(sh), low)
        idx_next = idx + _U1
        rank = np.where(nz, rank + _BINOM[pos.astype(np.int64), idx_next.astype(np.int64)], rank)
        rem = np.where(nz, rem & (rem - _U1), rem)
        idx = np.where(nz, idx_next, idx)
    return rank


def fixed_hamming_unrank(rank: int, hamming_weight: int) -> int:
    """Inverse of :func:`fixed_hamming_rank` for a single rank
    (``ls_hs_fixed_hamming_index_to_state``, FFI.chpl:166)."""
    state = 0
    r = int(rank)
    for i in range(hamming_weight, 0, -1):
        # largest p with C(p, i) <= r
        p = i - 1
        while p < 64 and int(_BINOM[p + 1, i]) <= r:
            p += 1
        state |= 1 << p
        r -= int(_BINOM[p, i])
    return state


# ---------------------------------------------------------------------------
# State-list generation
# ---------------------------------------------------------------------------

def fixed_hamming_states(n_bits: int, weight: int) -> np.ndarray:
    """All ``n_bits``-bit states with popcount ``weight``, ascending (colex recursion)."""
    if weight < 0 or weight > n_bits:
        return np.empty(0, dtype=np.uint64)
    if weight == 0:
        return np.zeros(1, dtype=np.uint64)
    if n_bits == weight:
        return np.array([(1 << n_bits) - 1], dtype=np.uint64)
    lo = fixed_hamming_states(n_bits - 1, weight)
    hi = fixed_hamming_states(n_bits - 1, weight - 1) | np.uint64(1 << (n_bits - 1))
    return np.concatenate([lo, hi])


def all_states(n_bits: int, weight: Optional[int]) -> np.ndarray:
    if weight is None:
        if n_bits > 28:
            raise ValueError("unconstrained enumeration above 28 bits on host")
        return np.arange(1 << n_bits, dtype=np.uint64)
    return fixed_hamming_states(n_bits, weight)


# ---------------------------------------------------------------------------
# Shard hash (data distribution)
# ---------------------------------------------------------------------------

def hash64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — exactly ``hash64_01`` (StatesEnumeration.chpl:122-127)."""
    x = np.asarray(x, dtype=np.uint64).copy()
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def shard_index(states: np.ndarray, n_shards: int) -> np.ndarray:
    """Owning-shard of each state — ``localeIdxOf`` (StatesEnumeration.chpl:129-136)."""
    if n_shards == 1:
        return np.zeros(np.asarray(states).shape, dtype=np.int32)
    return (hash64(states) % np.uint64(n_shards)).astype(np.int32)


# ---------------------------------------------------------------------------
# Representative enumeration
# ---------------------------------------------------------------------------

def enumerate_representatives(
    n_sites: int,
    hamming_weight: Optional[int],
    group,  # SymmetryGroup
    batch_size: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Enumerate symmetry-sector representatives; returns (states, norms).

    Mirrors ``_enumerateStates`` dispatch (StatesEnumeration.chpl:257-265):
    trivial group → plain state list (norm 1); otherwise batched
    ``is_representative`` filtering (:158-200).  States ascend.
    """
    if batch_size is None:
        from ..utils.config import get_config

        # the reference's kIsRepresentativeBatchSize (CommonParameters.chpl:5)
        batch_size = max(get_config().is_representative_batch_size, 1)
    candidates = all_states(n_sites, hamming_weight)
    if group is None or group.is_trivial:
        return candidates, np.ones(candidates.size, dtype=np.float64)
    # Spin-inversion-only fast path (BatchedOperator.chpl:119-161 analog):
    if len(group.perms) == 2 and group.flip[1] and group.networks[1].shifts == (0,):
        mask = np.uint64(group.inversion_mask)
        keep = candidates < (candidates ^ mask)
        reps = candidates[keep]
        return reps, np.full(reps.size, np.sqrt(0.5))
    out_states = []
    out_norms = []
    for start in range(0, candidates.size, batch_size):
        batch = candidates[start : start + batch_size]
        flags, norms = group.is_representative(batch)
        keep = flags & (norms > 0)
        out_states.append(batch[keep])
        out_norms.append(norms[keep])
    states = np.concatenate(out_states) if out_states else np.empty(0, np.uint64)
    norms = np.concatenate(out_norms) if out_norms else np.empty(0, np.float64)
    return states, norms
