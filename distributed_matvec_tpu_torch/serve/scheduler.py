# Ported from distributed_matvec_tpu/serve/scheduler.py.
"""Scheduler — admission, fingerprint grouping, batch packing, execution.

The unit of work here is a JOB STREAM, not a single solve:

* **Admission** is priced, not guessed: every submission is run through
  :func:`~.capacity.price_job` and gets a verdict — ``accept`` (fits, runs
  within the accept horizon), ``queue`` (fits, but the priced backlog puts
  its start beyond the horizon — the verdict carries the ETA), or
  ``reject`` (does not fit the device/host budgets at all, or cannot meet
  its deadline).  Without a rates calibration the verdict prices memory
  only and the ETAs stay 0.
* **Grouping**: queued jobs are grouped by :meth:`JobSpec.engine_key`; a
  batch takes up to ``serve_block_width`` jobs of ONE group (FIFO by the
  group's oldest submission, then job_id — deterministic packing), so
  same-basis requests share one warm engine from the
  :class:`~.pool.EnginePool`.
* **Execution**: the batch runs as ONE ``lanczos_block`` call with per-job
  ``column_targets`` — each job contributes a start column seeded by its
  own job_id, converges against its own (k, tol), and its column EXITS the
  batch when done (the block narrows).  Per-job results, latencies, and
  ``job`` spans land under the run's trace tree.  Dynamics jobs (``kpm``,
  ``evolve``) run one per batch on the same warm engines.
* **Preemption**: a latched SIGTERM surfaces as ``Preempted`` at a block
  boundary; the batch's unfinished jobs are requeued (their spool files
  never left ``queue/``) and the exception propagates so the service can
  exit 75.

The scheduler builds its engines on one ``device`` (default ``cuda``,
raising without a card unless the caller passes ``device="cpu"``).  The
pricing is :mod:`.capacity`, a module of the port; the JAX scheduler loads
``tools/capacity.py`` by file path instead.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import obs
from ..utils import preempt
from ..utils.config import get_config
from . import capacity
from .pool import EnginePool
from .queue import DONE, FAILED, REJECTED, JobQueue
from .spec import JobSpec

__all__ = ["Scheduler"]


class Scheduler:
    """Admission + packing + execution over one queue and one pool."""

    def __init__(self, queue: Optional[JobQueue] = None,
                 pool: Optional[EnginePool] = None,
                 rates: Optional[dict] = None,
                 calibration_path: Optional[str] = None,
                 block_width: Optional[int] = None,
                 hbm_gb: float = 16.0, host_ram_gb: float = 64.0,
                 accept_horizon_s: Optional[float] = None,
                 live_devices: Optional[int] = None, device=None):
        cfg = get_config()
        self.queue = queue if queue is not None else JobQueue()
        self.pool = pool if pool is not None else EnginePool(
            live_devices=live_devices, device=device)
        #: override of the live topology admission prices against
        #: (default: the pool's view)
        self.live_devices = live_devices
        self.block_width = int(block_width or cfg.serve_block_width)
        self.hbm_gb = float(hbm_gb)
        self.host_ram_gb = float(host_ram_gb)
        self.accept_horizon_s = float(
            accept_horizon_s if accept_horizon_s is not None
            else cfg.serve_accept_horizon_s)
        if rates is None:
            # an explicit path that does not load raises; without one
            # there is no calibration in the port (memory-only pricing)
            rates = capacity.load_rate_calibration(calibration_path)
        self.rates = rates
        self.tuning = capacity.load_tuning()
        self._backlog_s = 0.0          # priced est_solve_s of queued work
        self._est_s: Dict[str, float] = {}

    @property
    def device(self) -> torch.device:
        """Where the pool builds this scheduler's engines."""
        return self.pool.device

    def live_device_count(self) -> int:
        """The topology admission prices against (see :meth:`admit`)."""
        if self.live_devices is not None:
            return int(self.live_devices)
        return self.pool.live_device_count()

    # -- admission ---------------------------------------------------------

    def admit(self, spec: JobSpec) -> dict:
        """Price one spec and return the admission verdict (also emitted
        as an ``admission`` event).  Does NOT enqueue — :meth:`submit`
        composes the two.

        Pricing runs against the LIVE device count, not the spec's
        original one: a job respooled from a service that ran at D devices
        re-admits after a relaunch at D′ against the capacity that
        actually exists."""
        pricing = spec.pricing()
        live = self.live_device_count()
        asked = max(int(pricing.get("n_devices") or 1), 1)
        pricing["n_devices"] = max(1, min(asked, live))
        price = capacity.price_job(pricing, calibration=self.rates,
                                   hbm_gb=self.hbm_gb,
                                   host_ram_gb=self.host_ram_gb,
                                   tuning=self.tuning)
        eta_s = round(self._backlog_s, 3)
        if not price["fits"]:
            verdict = "reject"
            reason = price.get("reason") or "does not fit the device budget"
        elif (spec.deadline_s is not None
              and price.get("est_solve_s") is not None
              and eta_s + price["est_solve_s"] > float(spec.deadline_s)):
            verdict = "reject"
            reason = (f"priced finish {eta_s + price['est_solve_s']:.1f}s "
                      f"exceeds deadline {spec.deadline_s:.1f}s")
        elif eta_s > self.accept_horizon_s:
            verdict, reason = "queue", f"priced backlog {eta_s:.1f}s"
        else:
            verdict, reason = "accept", ""
        out = {"verdict": verdict, "eta_s": eta_s, "reason": reason,
               "live_devices": int(live),
               "priced_devices": int(pricing["n_devices"]),
               **{k: price.get(k) for k in
                  ("est_apply_ms", "est_solve_s", "fits", "rate_source")}}
        with obs.job_scope(spec.job_id):
            obs.emit("admission", job_id=spec.job_id,
                     engine_key=spec.engine_key(), **{
                         k: v for k, v in out.items() if v is not None})
        return out

    def _admit_and_track(self, spec: JobSpec, enqueue: bool) -> dict:
        """The one admit -> reject-or-track path both submission routes
        share: price the spec, record a rejection terminally, otherwise
        fold its priced solve time into the backlog (and enqueue it when
        it is not already in the queue).  The spec instance is marked
        admitted, so a re-adopted (resubmitted) spec — a FRESH instance
        from the spool — is re-priced while an already-admitted queued
        one is not."""
        verdict = self.admit(spec)
        spec.__dict__["_admitted"] = True
        if verdict["verdict"] == "reject":
            self.queue.finish(spec, REJECTED, reason=verdict["reason"],
                              eta_s=verdict["eta_s"])
            return verdict
        if enqueue:
            self.queue.submit(spec)
        if verdict.get("est_solve_s") is not None:
            self._est_s[spec.job_id] = float(verdict["est_solve_s"])
            self._backlog_s += self._est_s[spec.job_id]
        return verdict

    def submit(self, spec: JobSpec) -> dict:
        """Admit + enqueue (or record the rejection).  Returns the
        verdict dict."""
        return self._admit_and_track(spec, enqueue=True)

    def adopt_spool(self) -> int:
        """Scan the spool for new arrivals and run admission on each (a
        spooled job that does not fit is rejected with a terminal record,
        exactly like an API submission)."""
        adopted = self.queue.scan_spool()
        if adopted:
            for spec in list(self.queue.queued()):
                if not spec.__dict__.get("_admitted"):
                    self._admit_and_track(spec, enqueue=False)
        return adopted

    # -- packing -----------------------------------------------------------

    def next_batch(self) -> List[JobSpec]:
        """Up to ``block_width`` queued jobs of ONE (engine-key, solver)
        group: the group whose head job queued earliest goes first (FIFO
        fairness across groups), members ordered by (submit_ts, job_id) —
        deterministic, so a rerun of the same queue packs the same
        batches.  Dynamics jobs (solver kpm/evolve) group by the same
        engine key, so they still hit the warm engine a same-basis
        eigensolve built, but run ONE per batch: their state is a whole
        moment/trajectory recurrence, not a column of a shared block."""
        groups: Dict[tuple, List[JobSpec]] = {}
        for s in self.queue.queued():
            solver = getattr(s, "solver", "eigs") or "eigs"
            groups.setdefault((s.engine_key(), solver), []).append(s)
        if not groups:
            return []
        (_, solver), head = min(
            groups.items(),
            key=lambda kv: min((s.submit_ts, s.job_id) for s in kv[1]))
        head.sort(key=lambda s: (s.submit_ts, s.job_id))
        return head[: self.block_width if solver == "eigs" else 1]

    # -- execution ---------------------------------------------------------

    def run_batch(self, batch: List[JobSpec]) -> List[dict]:
        """One batched solve: acquire the group's engine, start columns
        seeded per job, per-job convergence targets, results recorded per
        job.  ``Preempted`` requeues the whole batch and propagates."""
        from ..solve import lanczos_block

        key = batch[0].engine_key()
        t_start = time.time()
        # in-flight width as a real gauge (reset on every exit path)
        obs.gauge("serve_batch_width").set(len(batch))
        for spec in batch:
            self.queue.mark_running(spec, batch_width=len(batch))
        try:
            with obs.span("serve_batch", kind="batch",
                          engine_key=key, jobs=len(batch)):
                eng = self.pool.acquire(batch[0])
                solver = getattr(batch[0], "solver", "eigs") or "eigs"
                if solver != "eigs":
                    return [self._run_dynamics(batch[0], eng, solver,
                                               t_start)]
                p = max(len(batch), max(int(s.k) for s in batch), 2)
                V0 = self._start_block(eng, batch, p)
                targets = [{"k": int(s.k), "tol": float(s.tol),
                            "max_iters": int(s.max_iters),
                            "job_id": s.job_id} for s in batch]
                res = lanczos_block(
                    eng.matvec, k=max(int(s.k) for s in batch),
                    block_size=p, V0=V0,
                    max_iters=max(int(s.max_iters) for s in batch),
                    tol=min(float(s.tol) for s in batch),
                    column_targets=targets, device=self._engine_device(eng))
                out = []
                now = time.time()
                for spec, cr in zip(batch, res.column_results or []):
                    rec = self._finish(
                        spec, DONE if cr["converged"] else FAILED,
                        t_start,
                        eigenvalues=[float(w) for w in
                                     np.atleast_1d(cr["eigenvalues"])],
                        residuals=[float(r) for r in
                                   np.atleast_1d(cr["residuals"])],
                        iters=int(cr["iters"]),
                        converged=bool(cr["converged"]),
                        batch_width=len(batch))
                    # per-job span: the job's in-batch execution window, a
                    # CHILD of the still-open serve_batch span, stamped
                    # with the job's own id via job_scope
                    with obs.job_scope(spec.job_id):
                        obs.emit_span(
                            f"job:{spec.job_id}", "job", t0=t_start,
                            dur_ms=(now - t_start) * 1e3,
                            engine_key=key, iters=int(cr["iters"]))
                    out.append(rec)
                return out
        except preempt.Preempted:
            for spec in batch:
                self.queue.requeue(spec, reason="preempted")
            raise
        except Exception as e:              # noqa: BLE001 — one broken
            for spec in batch:              # batch must not kill the service
                self._finish(spec, FAILED, t_start, error=repr(e))
            obs.emit("serve_batch_failed", engine_key=key, error=repr(e))
            return [self.queue.result(s.job_id) for s in batch]
        finally:
            obs.gauge("serve_batch_width").set(0)

    def _run_dynamics(self, spec: JobSpec, eng, solver: str,
                      t_start: float) -> dict:
        """One dynamics job (solver kpm/evolve) on the group's warm engine
        — the engine acquisition, admission pricing and spool lifecycle
        are exactly the eigensolve path's; only the solver call differs.
        ``Preempted`` propagates to the caller (requeue + exit 75; a
        requeued dynamics job restarts from its spool file)."""
        from ..solve import kpm_dos, krylov_evolve

        if solver == "kpm":
            energies, rho, res = kpm_dos(
                eng.matvec, n_moments=int(spec.n_moments),
                n=int(eng.n_states), n_vectors=int(spec.n_vectors),
                seed=spec.column_seed(),
                device=self._engine_device(eng))
            rec = self._finish(
                spec, DONE, t_start, solver="kpm", converged=True,
                bounds=[float(res.bounds[0]), float(res.bounds[1])],
                n_moments=int(spec.n_moments),
                moments_head=[float(m) for m in res.moments[:8]],
                dos_peak=float(np.max(rho)),
                moments_per_s=round(res.steady_moments_per_s, 3),
                iters=int(res.num_applies))
        else:
            res = krylov_evolve(
                eng.matvec, t_final=float(spec.t_final),
                n=int(eng.n_states), krylov_dim=int(spec.krylov_dim),
                tol=float(spec.tol), seed=spec.column_seed(),
                device=self._engine_device(eng))
            rec = self._finish(
                spec, DONE, t_start, solver="evolve",
                converged=bool(res.times[-1]
                               >= float(spec.t_final) * (1 - 1e-12)),
                t=float(res.times[-1]), steps=int(res.num_steps),
                norm_drift=float(res.norm_drift),
                energy_drift=float(res.energy_drift),
                energy_final=float(res.energies[-1]),
                iters=int(res.num_applies))
        now = time.time()
        with obs.job_scope(spec.job_id):
            obs.emit_span(
                f"job:{spec.job_id}", "job", t0=t_start,
                dur_ms=(now - t_start) * 1e3,
                engine_key=spec.engine_key(), solver=solver)
        return rec

    def _engine_device(self, eng) -> torch.device:
        """The device a solve on ``eng`` runs on: the engine's own, else
        (a custom builder's stand-in engine) the pool's."""
        return getattr(eng, "device", None) or self.device

    def _finish(self, spec: JobSpec, status: str, t_start: float,
                **result) -> dict:
        self._backlog_s = max(
            0.0, self._backlog_s - self._est_s.pop(spec.job_id, 0.0))
        latency_ms = (time.time() - float(spec.submit_ts or t_start)) * 1e3
        return self.queue.finish(spec, status,
                                 latency_ms=round(latency_ms, 3), **result)

    def _start_block(self, eng, batch: List[JobSpec], p: int):
        """The batch's start block: column j is seeded by job j's
        :meth:`~.spec.JobSpec.column_seed` (extra columns past the job
        count — a job wanting k > len(batch) eigenpairs — are seeded off
        the first job's seed), so the block depends only on batch
        membership, never on wall-clock or scheduler timing."""
        seeds = [s.column_seed() for s in batch]
        seeds += [seeds[0] + 1 + i for i in range(p - len(seeds))]
        if hasattr(eng, "random_hashed"):       # hashed [D, M, p] layout
            cols = [eng.random_hashed(seed=sd, cols=1) for sd in seeds]
            return torch.cat(cols, dim=-1)
        n = int(eng.n_states)
        cols = [np.random.default_rng(sd).standard_normal(n)
                for sd in seeds]
        V0 = np.stack(cols, axis=1)
        return V0 / np.linalg.norm(V0, axis=0, keepdims=True)

    # -- drain loop --------------------------------------------------------

    def drain(self, scan_spool: bool = True) -> int:
        """Run batches until the queue is empty (adopting spool arrivals
        between batches).  Returns the number of jobs driven to a
        terminal state.  ``Preempted`` propagates after requeueing — the
        caller owns the exit code."""
        finished = 0
        while True:
            if scan_spool:
                self.adopt_spool()
            if preempt.requested():
                raise preempt.Preempted("serve_drain", finished, None)
            batch = self.next_batch()
            if not batch:
                return finished
            self.run_batch(batch)
            finished += len(batch)
