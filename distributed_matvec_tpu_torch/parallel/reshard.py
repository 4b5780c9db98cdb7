# Ported from distributed_matvec_tpu/parallel/reshard.py (the exchange runs on the owner engine's device through parallel/distributed.py::all_to_all; complex rows are complex128, without the (re, im) pair tail).
"""Topology-portable checkpoint resharding: D source shards → D′ shards.

A checkpoint written at D shards stores each Krylov/LOBPCG row as
per-shard slices of the hash partition ``shard_index(σ, D)``.  The
partition is *deterministic*: state σ lives on shard ``hash64(σ) % D``
(``localeIdxOf``, StatesEnumeration.chpl:129-136), and within a shard rows
sit in ascending state order.  So redistribution from D to D′ is a
**computable permutation** — no solver state is approximate or lost — and
a restore becomes

1. **gather-from-source-shards**: target shard ``p`` hosts the saved
   slices of source shards ``{s : s ≡ p (mod D′)}`` as one zero-padded
   slab (each slice read straight from the checkpoint file(s); the
   per-rank ``path.r*`` files of the old topology are all scanned), then
2. **the exchange**: each slab entry is gathered into its destination
   bucket (``[D′_src, D′_dst, C]``), the buckets go through the engine's
   exchange (:func:`~.distributed.all_to_all`: a transpose with every
   shard on one device, ``all_to_all_single`` over a
   :class:`~.mesh.ShardGroup`), and every received entry is scattered into
   its target row slot, on the owner engine's device.

The routing (send indices, receive slots, capacity) is resolved on the
host ONCE per (D, D′) pair; every checkpointed row then goes through the
same gather, exchange and scatter.

The checkpoint's **topology stanza** (written by the solvers into
``ckpt_meta``) carries everything needed to decide and verify a reshard::

    ckpt_version     2
    topology_d       D the snapshot was written at
    topology_m       padded shard size at D
    topology_counts  per-shard real-row counts [D]
    partition_fp     :func:`partition_fingerprint` of the hash partition

A ``partition_fp`` mismatch raises :class:`PartitionMismatch` (through
the solvers' restore, a fresh solve).  The ``ckpt_reshard`` fault site
(``DMT_FAULT=ckpt_reshard``) injects a torn reshard so the degrade path
can be checked: the solve starts fresh, it never resumes from a
half-redistributed basis.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from ..enumeration.host import hash64, shard_index
from ..utils import faults

__all__ = ["PartitionMismatch", "partition_fingerprint", "topology_stanza",
           "hashed_ckpt_engine", "Resharder"]


class PartitionMismatch(ValueError):
    """The checkpoint's shard partition is not the one this build
    computes — resharding would scatter rows to wrong owners, so the
    restore must refuse (the caller degrades to a fresh solve)."""


def partition_fingerprint() -> str:
    """Content fingerprint of the hash partition itself: the splitmix64
    finalizer evaluated on a fixed probe, digested — the JAX package's
    string, so either package's checkpoints pass the other's check."""
    import hashlib

    probe = hash64(np.arange(16, dtype=np.uint64))
    return "splitmix64:" + hashlib.sha256(probe.tobytes()).hexdigest()[:16]


def hashed_ckpt_engine(owner) -> bool:
    """True when ``owner`` is an engine exposing the hashed ``[D, M]``
    shard layout a topology-portable checkpoint needs (counts, shard
    size, the block-order layout)."""
    return (owner is not None
            and hasattr(owner, "counts")
            and hasattr(owner, "shard_size")
            and hasattr(owner, "_require_layout"))


def topology_stanza(owner) -> dict:
    """The checkpoint-metadata topology stanza for an engine-backed save
    (empty for bare callables and ``LocalEngine`` — those checkpoints stay
    fixed-topology by construction)."""
    if not hashed_ckpt_engine(owner):
        return {}
    return {"ckpt_version": 2,
            "topology_d": int(owner.n_devices),
            "topology_m": int(owner.shard_size),
            "topology_counts": np.asarray(owner.counts, np.int64),
            "partition_fp": partition_fingerprint()}


def _global_states(owner) -> np.ndarray:
    """The sorted global state array the routing is computed from: the
    built basis' representatives, else every shard of a shard-native
    engine's source (O(N) host memory, the trade-off of
    ``DistributedEngine._require_layout``)."""
    basis = getattr(getattr(owner, "operator", None), "basis", None)
    if basis is not None and getattr(basis, "is_built", False):
        return np.asarray(basis.representatives, np.uint64)
    if getattr(owner, "_shard_load", None) is not None:
        states = np.concatenate(
            [np.asarray(owner._shard_load(d)[0], np.uint64)
             for d in range(owner.n_devices)])
        states.sort()
        return states
    raise PartitionMismatch(
        "resharded restore needs the global state list (a built basis or "
        "a shard source) to recompute the source partition; none is "
        "available")


class Resharder:
    """Host-resolved D → D′ redistribution plan, reused for every row of a
    checkpoint.

    ``owner`` is the TARGET engine (D′ = ``owner.n_devices``);
    ``src_d``/``src_counts`` come from the checkpoint's topology stanza;
    ``tail`` is the per-row trailing shape beyond ``[D, M]`` (``()`` for a
    vector, ``(cols,)`` for a block).  Raises :class:`PartitionMismatch`
    when the recomputed source partition disagrees with the checkpoint's
    counts.
    """

    def __init__(self, owner, src_d: int, src_counts, tail=()):
        self.owner = owner
        self.src_d = D = int(src_d)
        self.dst_d = Dp = int(owner.n_devices)
        self.tail = tuple(int(t) for t in tail)
        if D < 1:
            raise PartitionMismatch(f"invalid source topology D={D}")
        states = _global_states(owner)
        layout = owner._require_layout()
        if layout.n_shards != Dp or layout.shard_size != owner.shard_size:
            raise PartitionMismatch(
                f"target layout is {layout.n_shards}×{layout.shard_size}, "
                f"engine is {Dp}×{owner.shard_size}")
        owner_src = shard_index(states, D)
        counts_chk = np.bincount(owner_src, minlength=D).astype(np.int64)
        src_counts = np.asarray(src_counts, np.int64)
        if src_counts.size != D or not np.array_equal(counts_chk,
                                                      src_counts):
            raise PartitionMismatch(
                f"checkpoint shard counts {src_counts.tolist()} disagree "
                f"with the partition this build computes "
                f"{counts_chk.tolist()} for D={D} — the checkpoint was "
                "written under a different shard hash (see "
                "partition_fingerprint()); delete the checkpoint or "
                "restore it with the original build")
        # position of each state within its SOURCE shard: states are
        # globally sorted, so the stable rank among equal owners is
        # exactly the per-shard ascending order the save wrote
        n = states.size
        order = np.argsort(owner_src, kind="stable")
        bounds = np.searchsorted(owner_src[order], np.arange(D + 1))
        pos_src = np.empty(n, np.int64)
        pos_src[order] = np.arange(n) - bounds[owner_src[order]]

        # source shard s is hosted on target shard s % D′ at slab row
        # s // D′ (zero-padded to the largest source count)
        self.slab_rows = -(-D // Dp)
        self.slab_cap = Ms = max(int(src_counts.max(initial=0)), 1)
        Mp = layout.shard_size

        # routing table: every real target slot (q, j) holds global
        # index g, produced by hosting shard p at flat slab offset f
        perm = layout.perm
        qq, jj = np.nonzero(perm >= 0)
        g = perm[qq, jj]
        s = owner_src[g].astype(np.int64)
        p = s % Dp
        f = (s // Dp) * Ms + pos_src[g]
        # deterministic bucket order (by destination slot), one bucket
        # per (sender p, receiver q); capacity = the fattest bucket
        o2 = np.lexsort((jj, qq, p))
        p_o, q_o, j_o, f_o = p[o2], qq[o2], jj[o2], f[o2]
        key = p_o * Dp + q_o
        per_bucket = np.bincount(key, minlength=Dp * Dp)
        self.capacity = C = max(int(per_bucket.max(initial=0)), 1)
        starts = np.concatenate(([0], np.cumsum(per_bucket)))
        cpos = np.arange(key.size) - starts[key]
        send_idx = np.full((Dp, Dp, C), -1, np.int64)
        recv_slot = np.full((Dp, Dp, C), -1, np.int64)
        send_idx[p_o, q_o, cpos] = f_o
        recv_slot[q_o, p_o, cpos] = j_o
        self._mp = Mp
        # this process's rows of the tables, on the owner's device (a
        # receive slot of −1 goes to the dump row Mp)
        local = list(owner._shards)
        dev = owner.device
        self._sidx = torch.from_numpy(send_idx[local]).to(dev)
        self._rslot = torch.from_numpy(
            np.where(recv_slot[local] >= 0, recv_slot[local], Mp)).to(dev)

    # -- driving --------------------------------------------------------

    def src_shards_for(self, d: int) -> List[int]:
        """The source shards target shard ``d`` hosts in its slab."""
        return [r * self.dst_d + d for r in range(self.slab_rows)
                if r * self.dst_d + d < self.src_d]

    def stage_rows(self, fetch: Callable[[int, int], np.ndarray],
                   n_rows: int, dtype=None):
        """HOST-side staging of ``n_rows`` checkpointed rows: read every
        source-shard slice this process's target shards host and build the
        per-row zero-padded slab pieces.  ``fetch(i, s)`` returns source
        shard ``s``'s real rows (pad stripped) of row ``i``; ``dtype``
        pins the row dtype (a target shard that hosts no source shard —
        the grow direction — still builds a dtype-consistent zero slab);
        default: the first fetched shard's.  Returns ``(staged, dtype)``
        for :meth:`exchange_rows`.

        Everything that can fail one-sided — file I/O, torn source
        shards, the injected ``ckpt_reshard`` fault (at the top) — fails
        HERE, before any collective, so ranks can agree on the staging's
        success and degrade together."""
        faults.check("ckpt_reshard", exc=OSError,
                     d_from=self.src_d, d_to=self.dst_d, rows=int(n_rows))
        Ms = self.slab_cap
        tail = self.tail
        dtype = np.dtype(dtype) if dtype is not None else None
        staged = []
        for i in range(n_rows):
            pieces = []
            for d in self.owner._shards:
                buf = None
                for r, s in enumerate(self.src_shards_for(d)):
                    vals = np.asarray(fetch(i, s))
                    if buf is None:
                        dtype = dtype or vals.dtype
                        buf = np.zeros((self.slab_rows, Ms) + tail, dtype)
                    if vals.shape[1:] != tail or vals.shape[0] > Ms:
                        raise PartitionMismatch(
                            f"source shard {s} row shape {vals.shape} "
                            f"does not fit slab [{Ms}, {tail}]")
                    buf[r, : vals.shape[0]] = vals
                if buf is None:       # grow: this shard hosts no source
                    buf = np.zeros((self.slab_rows, Ms) + tail,
                                   dtype or np.float64)
                pieces.append(buf)
            staged.append(pieces)
        return staged, np.dtype(dtype or np.float64)

    def exchange_rows(self, staged, dtype) -> List[torch.Tensor]:
        """Gather, exchange and scatter each staged row, one row on the
        device at a time.  Returns target-layout ``[L, M′, *tail]`` rows
        on the owner's device (``L`` the shards held here: D′, or 1 on a
        rank engine).  On a rank engine this is collective: every rank
        calls it with the same row count."""
        from .distributed import all_to_all

        owner = self.owner
        Dp, C, Mp = self.dst_d, self.capacity, self._mp
        tail = self.tail
        flat_n = self.slab_rows * self.slab_cap
        idx = self._sidx.clamp(0, flat_n - 1)
        mask = (self._sidx >= 0).reshape(self._sidx.shape + (1,) * len(tail))
        L = idx.shape[0]
        out = []
        for pieces in staged:
            slab = torch.from_numpy(np.stack(pieces).astype(dtype, copy=False)
                                    ).to(owner.device)
            flat = slab.reshape((L, flat_n) + tail)
            send = torch.stack([flat[l][idx[l]] for l in range(L)])
            send = torch.where(mask, send, torch.zeros_like(send))
            recv = all_to_all(send, owner.group)       # [L, D′_src, C, …]
            y = torch.zeros((L, Mp + 1) + tail, dtype=send.dtype,
                            device=owner.device)
            for l in range(L):
                y[l][self._rslot[l].reshape(-1)] = recv[l].reshape(
                    (Dp * C,) + tail)
            out.append(y[:, :Mp].contiguous())
        return out

    def reshard_rows(self, fetch: Callable[[int, int], np.ndarray],
                     n_rows: int, dtype=None) -> List[torch.Tensor]:
        """:meth:`stage_rows` + :meth:`exchange_rows` in one call."""
        staged, dt = self.stage_rows(fetch, n_rows, dtype)
        return self.exchange_rows(staged, dt)
