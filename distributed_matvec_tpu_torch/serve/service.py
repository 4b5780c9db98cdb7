# Ported from distributed_matvec_tpu/serve/service.py.
"""SolveService — the long-running loop a spool directory is served by.

Composes the queue/pool/scheduler into the process
``python -m distributed_matvec_tpu_torch.apps.solve_service`` runs: adopt
spool arrivals, run batches, repeat — either until the queue drains
(``drain`` mode, the batch/CI shape) or forever at a poll interval
(``watch`` mode, the service shape).  A latched SIGTERM exits the loop at
the next block boundary with every in-flight job respooled as queued, and
:meth:`run` returns ``EXIT_PREEMPTED`` (75) so a supervisor relaunches and
resumes the undone work.
"""

from __future__ import annotations

import signal
import time
from typing import Optional

from ..obs import emit as obs_emit, flush as obs_flush
from ..obs.slo import check_slos
from ..utils import preempt
from ..utils.preempt import EXIT_PREEMPTED, Preempted
from .queue import JobQueue
from .scheduler import Scheduler

__all__ = ["SolveService"]


class SolveService:
    """One spool-serving process: ``run()`` returns a process exit code
    (0 drained/idle-stopped, 75 preempted).  Without a ``scheduler`` one
    is built over ``JobQueue(serve_dir)`` with ``scheduler_kwargs``
    (``device`` among them: ``cuda`` by default, raising without a card
    unless ``device="cpu"`` is passed)."""

    def __init__(self, serve_dir: str, scheduler: Optional[Scheduler] = None,
                 poll_s: float = 0.5, **scheduler_kwargs):
        self.serve_dir = serve_dir
        self.poll_s = float(poll_s)
        self.scheduler = scheduler if scheduler is not None else Scheduler(
            queue=JobQueue(serve_dir), **scheduler_kwargs)

    def run(self, drain: bool = False,
            max_idle_s: Optional[float] = None) -> int:
        """Serve the spool.  ``drain=True`` exits 0 once the queue is
        empty; otherwise the loop polls until ``max_idle_s`` of
        continuous idleness (None = forever) — and either way a latched
        SIGTERM/SIGINT exits 75 with in-flight jobs requeued."""
        preempt.ensure_installed(signals=(signal.SIGTERM, signal.SIGINT))
        sched = self.scheduler
        obs_emit("serve_start", serve_dir=self.serve_dir,
                 drain=bool(drain),
                 block_width=sched.block_width,
                 pool_max_bytes=int(sched.pool.max_bytes))
        idle_since = None
        finished = 0
        try:
            while True:
                n = sched.drain(scan_spool=True)
                finished += n
                if n:
                    # SLO pass at the batch boundary: evaluates the live
                    # event ring, emits slo_alert ONLY on firing/clear
                    # transitions
                    check_slos()
                if drain and sched.queue.pending() == 0:
                    break
                if n:
                    idle_since = None
                else:
                    now = time.monotonic()
                    idle_since = idle_since if idle_since is not None \
                        else now
                    if max_idle_s is not None \
                            and now - idle_since >= max_idle_s:
                        break
                    if preempt.requested():
                        raise Preempted("serve_loop", finished, None)
                    time.sleep(self.poll_s)
        except Preempted as e:
            # every in-flight job was requeued at the safe point (its
            # spool file never left queue/), so a relaunch resumes the
            # undone work
            obs_emit("serve_preempted", serve_dir=self.serve_dir,
                     jobs_finished=finished,
                     jobs_pending=sched.queue.pending(),
                     solver=e.solver, exit_code=EXIT_PREEMPTED)
            obs_flush()
            return EXIT_PREEMPTED
        obs_emit("serve_end", serve_dir=self.serve_dir,
                 jobs_finished=finished,
                 engine_builds=sched.pool.builds,
                 engine_hits=sched.pool.hits,
                 engine_evictions=sched.pool.evictions)
        obs_flush()
        return 0
