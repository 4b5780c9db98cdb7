"""Cells whose configuration declares ``"ranks": true``: one process per
card of the cell's ``chips``, joined in one process group, started by
``torchrun`` as users run the program.

``run.py`` is then the launcher (:func:`launch`): it runs
``python -m torch.distributed.run --standalone`` with one worker per card,
each ``run.py … --worker``, which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and a rendezvous on this host, and
passes ``RANKS_T_START``, the launcher's own start, so that ``setup_s``
counts from the process start the user sees.  ``torchrun`` stops every
rank when one fails.  Only rank 0 prints to standard output; the launcher
prints its result line once ``torchrun`` exits 0, and otherwise exits
non-zero with no result.  A run still going ``limit_s`` after the
launcher's start is stopped.  ``torchrun`` dies with the launcher and
each rank with ``torchrun`` (``PR_SET_PDEATHSIG``), so a launcher that is
killed leaves none behind.

Each rank (:func:`join`) starts the group as the CLIs do,
``init_distributed`` with NCCL on its card (gloo on the CPU in the tests),
with a collective timeout well under the limit.  :class:`Ranks` holds the
harness's own collectives (``torch.distributed`` on the default group):
rank 0's decisions, the end of set-up, the largest peak.
"""

from __future__ import annotations

import ctypes
import json
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

#: seconds from the launcher's start after which every rank is stopped:
#: under the first run's allowance, which includes the build
LIMIT_S = 1140.0
#: seconds a collective waits for its peers before it fails
TIMEOUT_S = 180.0
#: the environment variable that carries the launcher's start
T_START_VAR = "RANKS_T_START"
#: exit code of a run stopped at its limit
EXIT_LIMIT = 5
#: seconds ``torchrun`` gets to stop its ranks before it is killed
STOP_S = 60.0
_PR_SET_PDEATHSIG = 1


def die_with_parent(sig: int = signal.SIGKILL) -> None:
    """``sig`` to this process when its parent dies."""
    ctypes.CDLL(None, use_errno=True).prctl(_PR_SET_PDEATHSIG, sig, 0, 0, 0)


def launch(script: str, argv: List[str], world: int, t_start: float,
           limit_s: float = LIMIT_S) -> int:
    """Runs ``script argv --worker`` on ``world`` ranks under ``torchrun``
    and returns the exit code; prints rank 0's result line where every
    rank exits 0."""
    import importcheck
    from checks import report

    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={world}", script, *argv, "--worker"],
        env=dict(os.environ, **{T_START_VAR: repr(t_start)}),
        stdout=subprocess.PIPE, stdin=subprocess.DEVNULL, text=True,
        preexec_fn=lambda: die_with_parent(signal.SIGTERM))
    try:
        out, _ = p.communicate(
            timeout=max(limit_s - (time.time() - t_start), 1.0))
    except subprocess.TimeoutExpired:
        print(f"the ranks passed the run's limit of {limit_s} s: stopping "
              "every rank", file=sys.stderr)
        p.terminate()
        try:
            p.communicate(timeout=STOP_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
        return EXIT_LIMIT
    if p.returncode != 0:
        print(f"torchrun exited {p.returncode}: no result", file=sys.stderr)
        return p.returncode if p.returncode > 0 else 1
    result = _result(out.splitlines())
    if result is None:
        print("rank 0 printed no result", file=sys.stderr)
        return 1
    loaded = importcheck.loaded_forbidden(sys.modules)
    if loaded:
        print(f"loaded in this process: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    report(result["checks"])
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _result(lines: List[str]) -> Optional[dict]:
    for line in reversed(lines):
        try:
            got = json.loads(line)
        except ValueError:
            continue
        if isinstance(got, dict) and "checks" in got:
            return got
    return None


def join(cpu: bool):
    """This rank's group from ``torchrun``'s environment: NCCL on card
    ``LOCAL_RANK``, or gloo on the CPU."""
    from distributed_matvec_tpu_torch.parallel.mesh import init_distributed

    die_with_parent()
    return init_distributed(backend="gloo" if cpu else "nccl",
                            device="cpu" if cpu else None,
                            timeout_s=TIMEOUT_S)


def t_start() -> float:
    return float(os.environ[T_START_VAR])


class Ranks:
    """The harness's collectives over the default process group, on the
    rank's device."""

    def __init__(self, group):
        self.rank, self.size, self.device = (group.rank, group.world_size,
                                             group.device)

    def _reduce(self, values, op: str) -> list:
        import torch
        import torch.distributed as dist

        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=self.device)
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
        return t.tolist()

    def follow(self, *values: int) -> List[int]:
        """Rank 0's ``values`` (whole numbers ≥ 0) on every rank."""
        got = self._reduce(values if self.rank == 0 else [0] * len(values),
                           "MAX")
        return [int(v) for v in got]

    def max(self, value: float) -> float:
        return self._reduce([value], "MAX")[0]

    def gather(self, value: float) -> List[float]:
        """Every rank's ``value``, in rank order."""
        row = [0.0] * self.size
        row[self.rank] = float(value)
        return self._reduce(row, "SUM")

    def barrier(self) -> None:
        self._reduce([0], "SUM")
