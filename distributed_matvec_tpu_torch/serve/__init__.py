# Ported from distributed_matvec_tpu/serve/__init__.py.
"""serve — the solve service: a job queue + scheduler multiplexing many
concurrent diagonalize requests over warm engines.

The production traffic shape is many small-to-medium solves, not one
giant one.  Specs (:mod:`~.spec`) enter a queue (:mod:`~.queue`),
admission is priced by the capacity model (:mod:`~.capacity`), compatible
jobs are grouped by engine fingerprint and batched through
``lanczos_block``'s multi-RHS path with per-job convergence targets
(:mod:`~.scheduler`), engines stay warm in an LRU byte-budgeted pool
(:mod:`~.pool`), and the whole loop runs as a preemption-safe service
(:mod:`~.service`).  Specs, the spool layout, the ``done/`` records and
the exit codes are the JAX package's.

Quickstart::

    from distributed_matvec_tpu_torch.serve import JobSpec, Scheduler
    sched = Scheduler()                    # engines on the card
    sched.submit(JobSpec(job_id="j0", basis={"number_spins": 12,
                                             "hamming_weight": 6}))
    sched.drain()
    sched.queue.result("j0")["eigenvalues"]

Run a spool-backed service with
``python -m distributed_matvec_tpu_torch.apps.solve_service DIR``.
"""

from .capacity import price_job
from .pool import EnginePool, build_engine, build_operator, engine_bytes
from .queue import (DONE, FAILED, QUEUED, REJECTED, RUNNING, JobQueue,
                    submit_to_spool)
from .scheduler import Scheduler
from .service import SolveService
from .spec import JobSpec, estimate_dimension

__all__ = [
    "JobSpec", "estimate_dimension",
    "JobQueue", "submit_to_spool",
    "QUEUED", "RUNNING", "DONE", "FAILED", "REJECTED",
    "EnginePool", "build_engine", "build_operator", "engine_bytes",
    "Scheduler", "price_job",
    "SolveService",
]
