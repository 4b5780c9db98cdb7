# Copied from distributed_matvec_tpu/parallel/shuffle.py (its host part).
"""Block ↔ hashed layout conversion.

Every distributed array has two layouts: *block* — the globally sorted
index space (I/O order) — and *hashed* — state σ lives on shard
``hash64(σ) % D`` (compute order).  A layout is a precomputed permutation:
``perm[d, j]`` = global (block) index of the j-th element of shard d, padded
with −1.  Conversion is one gather, on the host; the engine moves the result
to its device.
"""

from __future__ import annotations

import numpy as np

from ..enumeration.host import shard_index

__all__ = ["HashedLayout"]


class HashedLayout:
    """Hash-shard layout descriptor for a sorted global state array.

    ``counts[d]`` — number of real elements on shard d;
    ``perm[d, j]`` — block-layout index held at hashed position (d, j), −1 pad;
    ``inverse[i]`` — (d, j) flattened position of block index i.
    """

    def __init__(self, states: np.ndarray, n_shards: int,
                 pad_multiple: int = 128):
        states = np.asarray(states, dtype=np.uint64)
        n = states.size
        owner = shard_index(states, n_shards)
        counts = np.bincount(owner, minlength=n_shards).astype(np.int64)
        m = int(counts.max(initial=0))
        m = max(((m + pad_multiple - 1) // pad_multiple) * pad_multiple,
                pad_multiple)
        perm = np.full((n_shards, m), -1, dtype=np.int64)
        for d in range(n_shards):
            idx = np.flatnonzero(owner == d)
            perm[d, : idx.size] = idx
        self.n_global = n
        self.n_shards = n_shards
        self.shard_size = m
        self.counts = counts
        self.perm = perm
        flat = perm.reshape(-1)
        real = flat >= 0
        inverse = np.empty(n, dtype=np.int64)
        inverse[flat[real]] = np.flatnonzero(real)
        self.inverse = inverse

    # -- host (NumPy) --------------------------------------------------------

    def to_hashed(self, arr: np.ndarray, fill=0) -> np.ndarray:
        """Block → hashed: [N, ...] → [D, M, ...]."""
        arr = np.asarray(arr)
        out_shape = (self.n_shards, self.shard_size) + arr.shape[1:]
        out = np.full(out_shape, fill, dtype=arr.dtype)
        mask = self.perm >= 0
        out[mask] = arr[self.perm[mask]]
        return out

    def from_hashed(self, arr: np.ndarray) -> np.ndarray:
        """Hashed → block: [D, M, ...] → [N, ...]."""
        arr = np.asarray(arr)
        flat = arr.reshape((self.n_shards * self.shard_size,) + arr.shape[2:])
        return flat[self.inverse]
