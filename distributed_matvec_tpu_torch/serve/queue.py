# Ported from distributed_matvec_tpu/serve/queue.py.
"""Job queue — lifecycle state + the on-disk spool a service drains.

In-memory view: ordered ``queued`` jobs (FIFO by submission), a
``running`` set, and terminal results (``done`` / ``failed`` /
``rejected``).  Every transition emits ONE ``job_event`` telemetry event
(``{job_id, status, engine_key, ...}``) — the stream a live queue panel
renders.

Optional spool directory (what ``apps/diagonalize.py --submit`` writes
into and ``apps/solve_service.py`` serves from)::

    <serve_dir>/queue/<job_id>.json    the spec, while queued OR running
    <serve_dir>/done/<job_id>.json     spec + result, terminal

A job's spool file stays under ``queue/`` until its TERMINAL transition
— deliberately: a service killed mid-batch (SIGTERM drain, SIGKILL, OOM)
leaves every in-flight job spooled as queued, so a relaunched service
resumes exactly the undone work with no recovery pass (the solver exits
at a safe block boundary; the JOB restarts from its spec).  The layout and
the ``done/`` records are the JAX package's, so a spool is drained alike
by either package's service.
Result writes are atomic (``os.replace``), so readers never see a torn
terminal file.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

from ..obs import emit as obs_emit
from ..obs import gauge as obs_gauge
from ..obs.trace import job_scope
from .spec import JobSpec

__all__ = ["JobQueue", "QUEUED", "RUNNING", "DONE", "FAILED", "REJECTED",
           "submit_to_spool"]

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
REJECTED = "rejected"
_TERMINAL = (DONE, FAILED, REJECTED)


def _spool_paths(serve_dir: str) -> tuple:
    return (os.path.join(serve_dir, "queue"),
            os.path.join(serve_dir, "done"))


def submit_to_spool(serve_dir: str, spec: JobSpec) -> str:
    """Write one spec into a spool directory (creating the layout) —
    the standalone submission path ``--submit`` uses; a running service
    picks the file up on its next scan.  Returns the spool path."""
    qdir, ddir = _spool_paths(serve_dir)
    os.makedirs(qdir, exist_ok=True)
    os.makedirs(ddir, exist_ok=True)
    if spec.submit_ts <= 0:
        spec.submit_ts = time.time()
    path = os.path.join(qdir, f"{spec.job_id}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(spec.to_json())
    os.replace(tmp, path)
    return path


class JobQueue:
    """Lifecycle bookkeeping for the scheduler, optionally mirrored to a
    spool directory."""

    def __init__(self, serve_dir: Optional[str] = None):
        self.serve_dir = serve_dir
        self._queued: List[JobSpec] = []      # FIFO
        self._running: Dict[str, JobSpec] = {}
        self._results: Dict[str, dict] = {}   # job_id -> terminal record
        self._status: Dict[str, str] = {}
        self._unreadable: Dict[str, tuple] = {}   # jid -> (size, mtime)
        self._spool_pending: Dict[str, dict] = {}  # terminal recs whose
        #   done/-write failed (full disk): retried per scan, and their
        #   queue/ files are NOT re-adopted as resubmissions meanwhile
        if serve_dir:
            qdir, ddir = _spool_paths(serve_dir)
            os.makedirs(qdir, exist_ok=True)
            os.makedirs(ddir, exist_ok=True)

    # -- submission / scanning --------------------------------------------

    def submit(self, spec: JobSpec, event: bool = True) -> None:
        if spec.job_id in self._status:
            raise ValueError(f"duplicate job_id {spec.job_id!r}")
        if spec.submit_ts <= 0:
            spec.submit_ts = time.time()
        self._queued.append(spec)
        self._status[spec.job_id] = QUEUED
        if self.serve_dir:
            submit_to_spool(self.serve_dir, spec)
        if event:
            self._event(spec, QUEUED)

    def scan_spool(self) -> int:
        """Pick up spool files this queue does not know yet (new
        ``--submit`` arrivals, or respooled in-flight jobs of a killed
        predecessor).  A queue/ file whose job_id is already TERMINAL is
        a RE-submission (``--submit`` overwrote it after the first run
        finished): the old result is discarded and the job runs again.
        An unreadable file is reported once per (size, mtime) — a
        watch-mode service polling every half-second must not emit an
        ``unreadable`` event per poll forever.  Returns how many specs
        were adopted."""
        if not self.serve_dir:
            return 0
        # retry terminal records whose done/-write failed before looking
        # at queue/ — while one is pending, its queue/ file is this
        # job's crash-safety net, not a resubmission
        for jid, rec in list(self._spool_pending.items()):
            if self._spool_finish(jid, rec):
                del self._spool_pending[jid]
        qdir, _ = _spool_paths(self.serve_dir)
        adopted = 0
        for name in sorted(os.listdir(qdir)):
            if not name.endswith(".json"):
                continue
            jid = name[: -len(".json")]
            if jid in self._spool_pending:
                continue
            status = self._status.get(jid)
            if status in (QUEUED, RUNNING):
                continue
            path = os.path.join(qdir, name)
            try:
                st = os.stat(path)
                stamp = (st.st_size, st.st_mtime_ns)
            except OSError:
                continue                     # raced with a finish()
            if self._unreadable.get(jid) == stamp:
                continue                     # known-bad, unchanged
            try:
                with open(path) as f:
                    spec = JobSpec.from_json(f.read())
            except (OSError, ValueError, TypeError, KeyError) as e:
                self._unreadable[jid] = stamp
                obs_emit("job_event", job_id=jid, status="unreadable",
                         error=repr(e))
                continue
            self._unreadable.pop(jid, None)
            resubmit = status is not None    # terminal -> run again
            if resubmit:
                self._results.pop(jid, None)
            self._queued.append(spec)
            self._status[spec.job_id] = QUEUED
            self._event(spec, QUEUED,
                        **({"resubmitted": True} if resubmit else {}))
            adopted += 1
        return adopted

    # -- views -------------------------------------------------------------

    def queued(self) -> List[JobSpec]:
        return list(self._queued)

    def running(self) -> List[JobSpec]:
        return list(self._running.values())

    def status(self, job_id: str) -> Optional[str]:
        return self._status.get(job_id)

    def result(self, job_id: str) -> Optional[dict]:
        return self._results.get(job_id)

    def pending(self) -> int:
        return len(self._queued) + len(self._running)

    # -- transitions -------------------------------------------------------

    def mark_running(self, spec: JobSpec, **info) -> None:
        self._queued = [s for s in self._queued if s.job_id != spec.job_id]
        self._running[spec.job_id] = spec
        self._status[spec.job_id] = RUNNING
        self._event(spec, RUNNING, **info)

    def requeue(self, spec: JobSpec, **info) -> None:
        """A running job back to the head of the queue (preemption drain:
        its spool file never left ``queue/``, so only the in-memory state
        moves)."""
        self._running.pop(spec.job_id, None)
        if self._status.get(spec.job_id) != QUEUED:
            self._queued.insert(0, spec)
            self._status[spec.job_id] = QUEUED
            self._event(spec, QUEUED, requeued=True, **info)

    def finish(self, spec: JobSpec, status: str, **result) -> dict:
        """Terminal transition: record the result, move the spool file
        from ``queue/`` to ``done/`` atomically."""
        if status not in _TERMINAL:
            raise ValueError(f"not a terminal status: {status!r}")
        self._running.pop(spec.job_id, None)
        self._queued = [s for s in self._queued if s.job_id != spec.job_id]
        rec = {"job_id": spec.job_id, "status": status,
               "spec": json.loads(spec.to_json()),
               "finish_ts": round(time.time(), 6), **result}
        self._results[spec.job_id] = rec
        self._status[spec.job_id] = status
        if self.serve_dir and not self._spool_finish(spec.job_id, rec):
            # an unwritable spool must not lose the run: keep the record
            # pending (retried per scan; its queue/ file is NOT treated
            # as a resubmission while pending)
            self._spool_pending[spec.job_id] = rec
        self._event(spec, status, **{k: v for k, v in result.items()
                                     if isinstance(v, (int, float, str,
                                                       bool))})
        return rec

    def _spool_finish(self, jid: str, rec: dict) -> bool:
        """Move one job's spool state to terminal: write ``done/``
        atomically, then drop the ``queue/`` file.  False on I/O
        failure (a ``spool_write_failed`` event is emitted)."""
        qdir, ddir = _spool_paths(self.serve_dir)
        out = os.path.join(ddir, f"{jid}.json")
        tmp = out + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(rec, f, sort_keys=True)
            os.replace(tmp, out)
            qf = os.path.join(qdir, f"{jid}.json")
            if os.path.exists(qf):
                os.remove(qf)
        except OSError as e:
            obs_emit("job_event", job_id=jid,
                     status="spool_write_failed", error=repr(e))
            return False
        return True

    # -- events ------------------------------------------------------------

    def _event(self, spec: JobSpec, status: str, **extra) -> None:
        # depth gauge rides every transition: the exporter's
        # job_queue_depth and the watch panel's queue line must agree
        obs_gauge("job_queue_depth").set(self.pending())
        # job_scope: the envelope job_id IS the job (payload job_id
        # fields are dropped by the envelope-wins rule) — readers key
        # per-job state on it
        with job_scope(spec.job_id):
            obs_emit("job_event", job_id=spec.job_id, status=status,
                     engine_key=spec.engine_key(), k=int(spec.k),
                     submit_ts=round(float(spec.submit_ts), 6), **extra)
