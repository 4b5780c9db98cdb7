# Counterpart of distributed_matvec_tpu/parallel/mesh.py (init_distributed; ShardGroup in place of the 1-D Mesh).
"""Process groups for the hash-sharded engine: one shard per rank.

The JAX package puts its shards on the devices of a 1-D
``jax.sharding.Mesh``; here each shard is one process rank of a
``torch.distributed`` group, and the shards meet only in the collectives of
:class:`ShardGroup`.  :func:`init_distributed` starts the group:

* ``nccl`` (the default): one card per rank, the rank's card chosen by its
  local rank (``torch.cuda.set_device(LOCAL_RANK)``);
* ``gloo``, by explicit choice only: ranks on the CPU (the test rig), or
  several ranks sharing one card, which NCCL refuses.

Every collective has a finite timeout (``timeout_s``), so a rank whose
peers stopped meeting it fails instead of hanging.

Wire formats: gloo's ``all_to_all_single`` rejects int16 (``Invalid scalar
type``), so one wire format serves both backends: int16/uint16 travel
widened to int32, bool as uint8 and complex as ``view_as_real``; each
comes back in its own dtype.  With gloo, a CUDA
tensor is staged through pinned host memory before the collective and
copied back after it — an explicit branch on the backend, so the path does
not depend on which collectives a build's gloo takes on the card.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = ["ShardGroup", "init_distributed", "check_nccl_placement",
           "DEFAULT_TIMEOUT_S"]

#: Seconds a collective may wait for its peers before it fails.
DEFAULT_TIMEOUT_S = 300.0

_WIDEN = {torch.int16: torch.int32, torch.uint16: torch.int32,
          torch.bool: torch.uint8}


def check_nccl_placement(local_rank: int, local_world_size: int,
                         n_cards: int) -> None:
    """Raise ``ValueError`` unless every NCCL rank of this host has a card
    of its own: NCCL refuses two ranks on one device.  Called before NCCL
    is touched."""
    if local_world_size > n_cards or not 0 <= local_rank < n_cards:
        raise ValueError(
            f"backend 'nccl' needs one card per rank: {local_world_size} "
            f"ranks on this host (local rank {local_rank}) but {n_cards} "
            "card(s); NCCL refuses two ranks on one device — use "
            "backend='gloo' to share a card")


@dataclass
class ShardGroup:
    """One ``torch.distributed`` group whose rank r holds hash shard r: the
    part JAX's ``Mesh`` plays for the engine.  ``group`` is the process
    group (None: the default group); ``device`` is where this rank's
    tensors live."""

    rank: int
    world_size: int
    backend: str
    device: torch.device
    group: Optional[object] = None

    @property
    def stages_host(self) -> bool:
        """Whether collectives stage CUDA tensors through host memory
        (gloo on the card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    # -- wire format ---------------------------------------------------------

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        if t.is_complex():
            t = torch.view_as_real(t)
        elif t.dtype in _WIDEN:
            t = t.to(_WIDEN[t.dtype])
        t = t.contiguous()
        if self.stages_host:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            return h
        return t

    def _empty_wire(self, shape, like: torch.Tensor) -> torch.Tensor:
        """An uninitialized receive tensor in ``like``'s wire dtype and
        place."""
        dtype = like.dtype
        if like.is_complex():
            dtype = like.real.dtype
            shape = tuple(shape) + (2,)
        elif dtype in _WIDEN:
            dtype = _WIDEN[dtype]
        if self.stages_host:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=like.device)

    @staticmethod
    def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if like.is_complex():
            w = torch.view_as_complex(w)
        return w.to(device=like.device, dtype=like.dtype)

    # -- collectives -----------------------------------------------------------

    def exchange(self, send: torch.Tensor) -> torch.Tensor:
        """All-to-all of equal blocks: ``send`` is ``[W_dst, C, …]``; the
        result is ``[W_src, C, …]``, block s being rank s's send block for
        this rank.  Runs the collective at every W, 1 included."""
        if send.shape[0] != self.world_size:
            raise ValueError(f"exchange takes [{self.world_size}, …] send "
                             f"blocks, got {tuple(send.shape)}")
        w_in = self._to_wire(send)
        w_out = self._empty_wire(send.shape, send)
        dist.all_to_all_single(w_out, w_in, group=self.group)
        return self._from_wire(w_out, send)

    def exchange_lists(self, parts: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Variable-size all-to-all of 1-D tensors of one dtype:
        ``parts[p]`` goes to rank p; returns the W received tensors,
        element s from rank s.  The counts travel first."""
        like = parts[0]
        counts = torch.tensor([int(p.numel()) for p in parts],
                              dtype=torch.int64, device=self.device)
        rcounts = self.exchange(counts[:, None])[:, 0].tolist()
        sizes = [int(p.numel()) for p in parts]
        w_in = self._to_wire(torch.cat([p.reshape(-1) for p in parts]))
        w_out = self._empty_wire((sum(rcounts),), like)
        dist.all_to_all_single(w_out, w_in, output_split_sizes=rcounts,
                               input_split_sizes=sizes, group=self.group)
        flat = self._from_wire(w_out, like)
        return list(torch.split(flat, rcounts))

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (``op="sum"``) or maximized (``"max"``) over the
        ranks, as a new tensor on ``t``'s device; every rank gets the same
        bits."""
        if op not in ("sum", "max"):
            raise ValueError(f"unknown reduction {op!r}")
        w = self._to_wire(t)
        if w is t:
            w = t.clone()
        dist.all_reduce(w, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self.group)
        return self._from_wire(w, t)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[W, *t.shape]``: row s is rank s's ``t`` (equal shapes)."""
        w = self._to_wire(t)
        outs = [self._empty_wire(t.shape, t)
                for _ in range(self.world_size)]
        dist.all_gather(outs, w, group=self.group)
        return self._from_wire(torch.stack(outs), t)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> ShardGroup:
    """Start the default process group and return this rank's
    :class:`ShardGroup`.

    Arguments not given come from torchrun's environment: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, and
    ``init_method`` ``env://`` (``MASTER_ADDR``/``MASTER_PORT``).  A job
    started by hand passes them, e.g. ``init_method="tcp://localhost:29500"``
    or ``"file:///path/rdv"``.

    ``backend`` ``"nccl"`` (the default) puts rank r on card ``LOCAL_RANK``
    (``rank`` when unset) and raises ``ValueError`` before NCCL is touched
    when this host has more ranks than cards.  ``"gloo"`` runs its ranks
    on ``device`` (default ``cuda``, raising without one; pass
    ``device="cpu"`` for the CPU).  ``timeout_s`` bounds every
    collective.
    """
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (use nccl | gloo)")
    rank = rank if rank is not None else _env_int("RANK")
    world_size = world_size if world_size is not None \
        else _env_int("WORLD_SIZE")
    if rank is None or world_size is None:
        raise ValueError("pass rank and world_size, or start the ranks with "
                         "torchrun (RANK, WORLD_SIZE)")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    if init_method is None:
        init_method = "env://"
    if backend == "nccl":
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
        local_ws = _env_int("LOCAL_WORLD_SIZE") or world_size
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        check_nccl_placement(local_rank, local_ws, n_cards)
        dev = torch.device("cuda", local_rank)
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"backend 'nccl' puts local rank {local_rank} "
                             f"on {dev}, not {device}")
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    return ShardGroup(rank=rank, world_size=world_size, backend=backend,
                      device=dev)
