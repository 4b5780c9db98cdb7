"""The one traffic generator: closed loops of requests, driven by a traffic
file's parameters.

A traffic file (``traffic/<name>.json``) names a ``kind``:

* ``"solve"``: back-to-back calls of the program's solver ``solver`` (a
  name in the program's ``solve`` package) with ``kwargs``, each from one
  of a fixed pool of start vectors (``starts``), in an order drawn from
  the seed.  The solve that is running at the deadline completes and
  counts.
* ``"apply"``: back-to-back ``eng.matvec`` calls on blocks of ``columns``
  columns, each call followed by a synchronize and timed.  The first block
  is drawn from the seed; each later input is the previous output with
  every column normalized (outside the call's time).

Set-up warms up every shape the window uses (one solve cut at
``WARMUP_SOLVE_ITERS``, or ``WARMUP_APPLIES`` applies).  In a ``--trace 1``
run the traced segment is ``profile.requests`` requests from the first that
starts past ``PROFILE_AFTER`` of the window; a segment that has begun runs
its requests to the end, past the deadline if need be.  Each loop keeps,
for the check after the window, the first request's output, the output of
the first request that starts past a point of the window drawn from the
seed, and the last request's.

Under a rank group (``ranks``, a ``ranks.Ranks``) every rank runs the
solve loop SPMD; the apply loop does not run on ranks.  Before each
request rank 0's decisions (whether it starts, whether it is traced,
whether its output is kept) go to every rank, a request that raises ends
the run, and only rank 0 traces.  Starts are drawn in basis
order on every rank and each rank takes its shard through the engine's
layout, so every seed does the same work as on one card.
"""

from __future__ import annotations

import sys
import time
import traceback
from typing import Callable, List, Optional

import numpy as np

from tracing import Segment

#: consecutive failed requests after which a loop stops
MAX_FAILURES_IN_A_ROW = 3
#: the share of the window after which the traced segment begins
PROFILE_AFTER = 0.25
#: set-up's warm-up solve stops here, past its first convergence check at
#: the solver's default ``check_every``
WARMUP_SOLVE_ITERS = 16
#: set-up's warm-up applies
WARMUP_APPLIES = 2
#: what a request's output is kept as, by the code rank 0 sends
KEEPS = (None, "first", "sampled")


def mix(seed: int, *keys: int) -> int:
    """A 63-bit seed for one purpose, drawn from the run's seed."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *keys])
    a, b = ss.generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def uniform(seed: int, *keys: int) -> float:
    return float(np.random.default_rng(mix(seed, *keys)).random())


class VectorSpace:
    """The engine's vector layout: the basis order itself, or, for an
    engine with ``to_hashed``/``from_hashed``, its hashed layout."""

    def __init__(self, eng, n_states: int, device):
        self.eng, self.n, self.device = eng, n_states, device
        self.hashed = hasattr(eng, "to_hashed")

    def random(self, seed: int, columns: Optional[int] = None):
        """A normalized random block in basis order on the device."""
        import torch

        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        shape = (self.n,) if columns is None else (self.n, columns)
        x = torch.randn(shape, generator=g, device=self.device,
                        dtype=torch.float64)
        return x / torch.linalg.vector_norm(x, dim=0, keepdim=True)

    def from_basis(self, x):
        if self.hashed:
            return self.eng.to_hashed(x.cpu().numpy())
        return x

    def to_basis(self, v) -> np.ndarray:
        """A host copy in basis order."""
        if self.hashed:
            return np.asarray(self.eng.from_hashed(v))
        return v.detach().cpu().numpy()


def normalize_columns(y):
    import torch

    dims = tuple(range(y.dim() - 1)) if y.dim() > 1 else (0,)
    return y / torch.linalg.vector_norm(y, dim=dims, keepdim=True)


class Loop:
    """What every loop shares: the seed, the kept outputs and the traced
    segment."""

    def __init__(self, traffic: dict, eng, space: VectorSpace, seed: int,
                 sync: Callable[[], None], trace: bool, port, ranks=None):
        self.traffic, self.eng, self.space = traffic, eng, space
        self.seed, self.sync, self.trace, self.port = seed, sync, trace, port
        self.ranks = ranks
        self.profile_requests = int(traffic["profile"]["requests"]) \
            if trace else 0
        self.segment = Segment(sync) if trace else None
        #: (seconds, columns, traced) of every request of the window
        self.walls: List[tuple] = []
        self.kept: dict = {}
        self.attempted = 0
        self.failed = 0
        self.columns = 0
        self.t_start = self.t_end = 0.0

    def _profiling(self, i: int, t: float, first_profiled: List[int]
                   ) -> bool:
        """Whether request ``i``, starting at ``t``, is in the segment."""
        if self.segment is None:
            return False
        if not first_profiled and t >= self.t_start + PROFILE_AFTER * (
                self.t_end - self.t_start):
            first_profiled.append(i)
        return bool(first_profiled) and \
            i < first_profiled[0] + self.profile_requests

    def _failure(self, what: str) -> bool:
        """Counts a failed request; True once the loop should stop."""
        self.failed += 1
        self._in_a_row += 1
        print(f"request {what} failed:\n{traceback.format_exc()}",
              file=sys.stderr)
        return self._in_a_row >= MAX_FAILURES_IN_A_ROW

    def run(self, seconds: float) -> None:
        self.t_start = time.perf_counter()
        self.t_end = self.t_start + seconds
        sample_at = self.t_start + uniform(self.seed, 1) * seconds
        first_profiled: List[int] = []
        self._in_a_row = 0
        i = 0
        last_done = self.t_start
        while True:
            t = time.perf_counter()
            # a traced segment that has begun runs to its end past the
            # deadline
            go = t < self.t_end or (self.segment is not None and
                                    self.segment.open)
            profiled = go and self._profiling(i, t, first_profiled)
            keep = "first" if i == 0 else (
                "sampled" if t >= sample_at and "sampled" not in self.kept
                else None)
            if self.ranks is not None:
                go, profiled, k = self.ranks.follow(
                    go, profiled, KEEPS.index(keep))
                keep = KEEPS[k]
                profiled = profiled and self.segment is not None
            if not go:
                break
            if profiled and not self.segment.open:
                self.segment.start()
            self.attempted += 1
            c0 = self.columns
            try:
                done = self.request(i, keep, profiled)
            except Exception:
                if self.ranks is not None:
                    raise
                if self._failure(str(i)):
                    break
                done = time.perf_counter()
            else:
                self._in_a_row = 0
            self.walls.append((done - t, self.columns - c0, profiled))
            last_done = done
            i += 1
            if self.segment is not None and self.segment.open and \
                    i >= first_profiled[0] + self.profile_requests:
                self.segment.stop()
        if self.segment is not None and self.segment.open:
            self.segment.stop()
        self.elapsed_s = last_done - self.t_start

    def untraced_s(self) -> Optional[float]:
        """What the traced segment's work takes without the profiler: the
        median seconds per column of the untraced requests, times the
        segment's columns."""
        per = [w / c for w, c, traced in self.walls if c and not traced]
        if self.segment is None or not per:
            return None
        return float(np.median(per)) * self.segment.columns

    def request(self, i: int, keep: Optional[str], profiled: bool) -> float:
        raise NotImplementedError


class SolveLoop(Loop):
    """``kind: "solve"``."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        solve = __import__(self.port + ".solve", fromlist=["solve"])
        self.solver = getattr(solve, self.traffic["solver"])
        self.kwargs = dict(self.traffic.get("kwargs", {}))
        self.solves: List[dict] = []
        self.order = np.random.default_rng(mix(self.seed, 5)).permutation(
            int(self.traffic["starts"]["pool"]))

    def start(self, i: int):
        """Solve ``i``'s start: one of the traffic's fixed pool of starts
        (``starts.pool`` vectors drawn from ``starts.seed``), in an order
        drawn from the run's seed, so that every seed does the same work
        (the start sets the solve's iterations)."""
        j = int(self.order[i % len(self.order)])
        return self.space.from_basis(self.space.random(
            mix(int(self.traffic["starts"]["seed"]), 2, j)))

    def warm_up(self) -> None:
        kw = dict(self.kwargs, max_iters=WARMUP_SOLVE_ITERS)
        v0 = self.space.from_basis(self.space.random(mix(self.seed, 6)))
        self.solver(self.eng.matvec, v0=v0, **kw)
        self.sync()

    def request(self, i, keep, profiled):
        res = self.solver(self.eng.matvec, v0=self.start(i), **self.kwargs)
        self.sync()
        done = time.perf_counter()
        iters = int(res.num_iters)
        theta = float(res.eigenvalues[0])
        self.solves.append({"e0": theta, "iters": iters,
                            "converged": bool(res.converged)})
        self.columns += iters
        if profiled:
            self.segment.columns += iters
        vec = res.eigenvectors[0] if res.eigenvectors else None
        if vec is not None:
            if keep:
                self.kept[keep] = (theta, vec)
            self.kept["last"] = (theta, vec)
        return done

    def host_outputs(self) -> dict:
        """The kept eigenpairs as host copies in basis order."""
        return {k: (theta, self.space.to_basis(v))
                for k, (theta, v) in self.kept.items()}


class ApplyLoop(Loop):
    """``kind: "apply"``."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        if self.ranks is not None:
            # its normalization would take each rank's norm alone
            raise ValueError("apply traffic does not run on ranks")
        self.R = int(self.traffic["columns"])
        self.call_ms: List[float] = []
        self.events: list = []
        self.x0 = self.space.from_basis(
            self.space.random(mix(self.seed, 3), self.R))
        self.x = self.x0

    def warm_up(self) -> None:
        for _ in range(WARMUP_APPLIES):
            self.eng.matvec(self.x0)
        self.sync()

    def request(self, i, keep, profiled):
        import torch

        x = self.x
        ev = None
        if self.trace and not profiled and x.is_cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t = time.perf_counter()
        y = self.eng.matvec(x)
        if ev is not None:
            ev[1].record()
        self.sync()
        done = time.perf_counter()
        self.call_ms.append((done - t) * 1e3)
        if ev is not None:
            self.events.append(ev)
        self.columns += self.R
        if profiled:
            self.segment.columns += self.R
        if keep:
            self.kept[keep] = (x, y)
        self.kept["last"] = (x, y)
        self.x = normalize_columns(y)
        self.sync()
        return done

    def call_device_ms(self) -> List[float]:
        """Device ms of each traced call, from its CUDA events."""
        return [a.elapsed_time(b) for a, b in self.events]

    def host_outputs(self) -> dict:
        return {k: (self.space.to_basis(x), self.space.to_basis(y))
                for k, (x, y) in self.kept.items()}


LOOPS = {"solve": SolveLoop, "apply": ApplyLoop}


def make(traffic: dict, *a, **kw) -> Loop:
    return LOOPS[traffic["kind"]](traffic, *a, **kw)
