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
not depend on which collectives a build's gloo takes on the card (its
``all_to_all_single`` took CUDA tensors on the H100's torch, while its
``isend``/``irecv`` on CUDA tensors abort the process: gloo writes from the
device address).

Three forms of the equal-block all-to-all (JAX ``all_to_all`` and
``_staged_all_to_all``), element-identical in every wire dtype:

* :meth:`ShardGroup.exchange`: one blocking ``all_to_all_single`` (the
  sequential applies and the builds);
* :meth:`ShardGroup.exchange_async`: the staged exchange — the local
  block copied, then W−1 point-to-point rounds (round r sends this rank's
  block for peer (i+r) % W and receives into slot (i−r) % W) — left in
  flight; ``handle.wait()`` gives the receive block.  On NCCL and on
  gloo over CPU tensors the rounds' own ``Work`` objects carry it.  With
  gloo on the card the send block goes device → pinned host on a copy
  stream after an event of the compute stream; the group's one comm thread (a FIFO, so
  every rank issues its rounds in one order) waits for the copy, runs the
  rounds over gloo and copies the result back on a second copy stream;
  ``wait()`` joins the thread's future and makes the compute stream wait
  for that copy.  While an exchange is in flight the caller issues no
  other collective: the pipelined applies drain before they return;
* :meth:`ShardGroup.exchange_staged`: the same, waited for at once.
"""

from __future__ import annotations

import datetime
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = ["ShardGroup", "PendingExchange", "init_distributed",
           "check_nccl_placement", "DEFAULT_TIMEOUT_S"]

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


class PendingExchange:
    """An exchange in flight: :meth:`wait` gives its receive block.  It
    holds the tensors the exchange still reads or writes until then."""

    __slots__ = ("_wait", "_keep")

    def __init__(self, wait: Callable[[], torch.Tensor], keep: Tuple = ()):
        self._wait = wait
        self._keep = keep

    def wait(self) -> torch.Tensor:
        out = self._wait()
        self._keep = ()
        return out


@dataclass
class ShardGroup:
    """One ``torch.distributed`` group whose rank r holds hash shard r: the
    part JAX's ``Mesh`` plays for the engine.  ``group`` is the process
    group (None: the default group); ``device`` is where this rank's
    tensors live.  ``collectives`` counts the calls of each collective
    this group has made, by method name."""

    rank: int
    world_size: int
    backend: str
    device: torch.device
    group: Optional[object] = None
    collectives: Dict[str, int] = field(default_factory=dict, repr=False,
                                        compare=False)
    #: exchanges started so far (each one's rounds carry it as their tag)
    _started: int = field(default=0, init=False, repr=False, compare=False)
    #: the comm thread and the two copy streams of the gloo-on-card path
    _comm: Optional[ThreadPoolExecutor] = field(default=None, init=False,
                                                repr=False, compare=False)
    _copy: Optional[Tuple] = field(default=None, init=False, repr=False,
                                   compare=False)

    def _count(self, kind: str) -> None:
        self.collectives[kind] = self.collectives.get(kind, 0) + 1

    @property
    def stages_host(self) -> bool:
        """Whether collectives stage CUDA tensors through host memory
        (gloo on the card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    # -- wire format ---------------------------------------------------------

    @staticmethod
    def _wire(t: torch.Tensor) -> torch.Tensor:
        """``t`` in its wire dtype, contiguous, where it lies."""
        if t.is_complex():
            t = torch.view_as_real(t)
        elif t.dtype in _WIDEN:
            t = t.to(_WIDEN[t.dtype])
        return t.contiguous()

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        t = self._wire(t)
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

    def _check_blocks(self, send: torch.Tensor) -> None:
        if send.shape[0] != self.world_size:
            raise ValueError(f"exchange takes [{self.world_size}, …] send "
                             f"blocks, got {tuple(send.shape)}")

    def exchange(self, send: torch.Tensor) -> torch.Tensor:
        """All-to-all of equal blocks: ``send`` is ``[W_dst, C, …]``; the
        result is ``[W_src, C, …]``, block s being rank s's send block for
        this rank.  Runs the collective at every W, 1 included."""
        self._check_blocks(send)
        self._count("exchange")
        w_in = self._to_wire(send)
        w_out = self._empty_wire(send.shape, send)
        dist.all_to_all_single(w_out, w_in, group=self.group)
        return self._from_wire(w_out, send)

    def exchange_staged(self, send: torch.Tensor) -> torch.Tensor:
        """:meth:`exchange` as W−1 point-to-point rounds plus the local
        block's copy (JAX ``_staged_all_to_all``): element-identical to
        it.  At W = 1 the result is the send block's copy."""
        return self.exchange_async(send).wait()

    def exchange_async(self, send: torch.Tensor) -> PendingExchange:
        """Start the staged exchange of ``send`` (``[W_dst, C, …]``) and
        return its handle; ``handle.wait()`` gives the ``[W_src, C, …]``
        receive block, on ``send``'s device in its dtype.  Every rank starts
        its exchanges in one order, and issues no other collective before
        waiting for them."""
        self._check_blocks(send)
        self._count("exchange_async")
        tag = self._started
        self._started += 1
        if self.stages_host:
            return self._async_through_host(send, tag)
        w_in = self._wire(send)
        w_out = self._empty_wire(send.shape, send)
        works = self._rounds(w_in, w_out, tag)

        def wait():
            for w in works:
                w.wait()
            return self._from_wire(w_out, send)

        return PendingExchange(wait, keep=(w_in, send))

    def _peer(self, r: int) -> int:
        """Group rank r as the global rank point-to-point calls take."""
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def _rounds(self, w_in: torch.Tensor, w_out: torch.Tensor,
                tag: int) -> list:
        """The local block's copy and the W−1 rounds of the staged
        exchange, started; returns their ``Work`` objects.  Round k sends
        block (i+k) % W and receives into slot (i−k) % W."""
        W, i = self.world_size, self.rank
        w_out[i].copy_(w_in[i])
        works = []
        for k in range(1, W):
            dst, src = (i + k) % W, (i - k) % W
            works += dist.batch_isend_irecv([
                dist.P2POp(dist.isend, w_in[dst], self._peer(dst),
                           self.group, tag),
                dist.P2POp(dist.irecv, w_out[src], self._peer(src),
                           self.group, tag)])
        return works

    def _async_through_host(self, send: torch.Tensor,
                            tag: int) -> PendingExchange:
        """The staged exchange of a CUDA ``send`` over gloo: device →
        pinned host on one copy stream after the compute stream's event,
        the rounds on the comm thread once that copy is done, and pinned
        host → device on the other copy stream, recorded as an event the
        compute stream waits for in ``wait()``."""
        dev = send.device
        if self._comm is None:
            self._comm = ThreadPoolExecutor(
                1, thread_name_prefix="shard-group-comm")
            self._copy = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
        d2h, h2d = self._copy
        w_dev = self._wire(send)
        h_in = torch.empty(w_dev.shape, dtype=w_dev.dtype, pin_memory=True)
        h_out = torch.empty(w_dev.shape, dtype=w_dev.dtype, pin_memory=True)
        d_out = torch.empty(w_dev.shape, dtype=w_dev.dtype, device=dev)
        produced = torch.cuda.Event()
        produced.record(torch.cuda.current_stream(dev))
        staged = torch.cuda.Event()
        with torch.cuda.stream(d2h):
            d2h.wait_event(produced)
            h_in.copy_(w_dev, non_blocking=True)
            staged.record(d2h)

        def comm() -> torch.cuda.Event:
            staged.synchronize()
            for w in self._rounds(h_in, h_out, tag):
                w.wait()
            landed = torch.cuda.Event()
            with torch.cuda.device(dev), torch.cuda.stream(h2d):
                d_out.copy_(h_out, non_blocking=True)
                landed.record(h2d)
            return landed

        fut = self._comm.submit(comm)

        def wait():
            torch.cuda.current_stream(dev).wait_event(fut.result())
            return self._from_wire(d_out, send)

        return PendingExchange(wait, keep=(send, w_dev, h_in, h_out))

    def exchange_lists(self, parts: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Variable-size all-to-all of 1-D tensors of one dtype:
        ``parts[p]`` goes to rank p; returns the W received tensors,
        element s from rank s.  The counts travel first."""
        self._count("exchange_lists")
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
        self._count("all_reduce")
        w = self._to_wire(t)
        if w is t:
            w = t.clone()
        dist.all_reduce(w, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self.group)
        return self._from_wire(w, t)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[W, *t.shape]``: row s is rank s's ``t`` (equal shapes)."""
        self._count("all_gather")
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
