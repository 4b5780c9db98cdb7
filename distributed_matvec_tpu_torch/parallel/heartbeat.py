# Ported from distributed_matvec_tpu/parallel/heartbeat.py.
"""Cross-rank heartbeat watchdog: turn a hung peer into a diagnosis.

A rank engine's apply is a chain of ``all_to_all``s; when one rank
wedges (OOM-killed, stuck disk read, dead host, a stopped process) every
other rank blocks *inside the collective* — silently, until the process
group's own timeout (or the NCCL watchdog) aborts the job with no
attribution.  Keep ``timeout_s`` well under both, or the group aborts
first and the stall is never attributed.  The watchdog runs
OUTSIDE the collective path: a daemon thread per rank touches
``<dir>/heartbeat/rank_<r>.hb`` every ``interval_s`` and checks the peers'
files; when a peer's beat goes stale past ``timeout_s`` it emits a
``stall_report`` event (per-rank ages — the post-mortem names the hung
rank), records a critical health condition, flushes the obs sinks, and
aborts the process (:data:`EXIT_STALLED`) so the supervisor can relaunch
and resume from the last solver checkpoint instead of holding a slice
hostage on a dead collective.

The shared directory is typically the obs run dir (multi-rank runs
already share one); any rank-visible filesystem works.  The caller
starts it (the JAX package's ``apps/diagonalize.py`` does so for
multi-process runs when ``heartbeat_s`` > 0; that app comes with the CLI
slice); ``heartbeat_s`` (``DMT_HEARTBEAT_S``) and ``heartbeat_timeout_s``
are the defaults of ``interval_s``/``timeout_s``.  The thread never touches torch: pure file mtimes,
so it keeps beating even while the main thread is wedged in a collective
— which is the whole point.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from ..utils.config import get_config
from ..utils.logging import _process_count, _process_index, log_warn

__all__ = ["EXIT_STALLED", "HeartbeatWatchdog"]

#: Exit code for a watchdog-detected peer stall (distinct from
#: EXIT_PREEMPTED: the checkpoint is the *previous* cadence one, not a
#: fresh safe-point write).
EXIT_STALLED = 76


def _default_on_stall(report: dict) -> None:
    doing = ""
    if report.get("span_path"):
        doing = f"; this rank was in [{report['span_path']}]"
        sp = report.get("span") or {}
        if sp.get("kind") == "chunk":
            doing += f" (chunk {sp.get('chunk')})"
    log_warn(f"peer rank(s) stalled: {report['stalled']} "
             f"(ages {report['ages_s']}, timeout {report['timeout_s']} s)"
             f"{doing}; aborting so the supervisor can relaunch and resume")
    # os._exit, not sys.exit: the main thread is (by hypothesis) wedged in
    # a collective and will never unwind a SystemExit raised here
    os._exit(EXIT_STALLED)


class HeartbeatWatchdog:
    """File-based liveness monitor for one rank of a multi-controller job.

    ``start()`` launches the daemon thread; ``stop()`` joins it (also a
    context manager).  ``interval_s``/``timeout_s`` default to the
    config's ``heartbeat_s`` (2 s while it is 0) and
    ``heartbeat_timeout_s``.  ``rank``/``n_ranks`` default to the
    ``torch.distributed`` group's rank and world size but are injectable so a single process can be tested against
    fabricated peers.  ``on_stall`` (default: emit + flush + abort) is
    called at most once with the report dict."""

    def __init__(self, directory: str, interval_s: Optional[float] = None,
                 timeout_s: Optional[float] = None,
                 rank: Optional[int] = None,
                 n_ranks: Optional[int] = None,
                 on_stall: Optional[Callable[[dict], None]] = None):
        cfg = get_config()
        if interval_s is None:
            interval_s = float(cfg.heartbeat_s) or 2.0
        if timeout_s is None:
            timeout_s = float(cfg.heartbeat_timeout_s)
        self.dir = os.path.join(directory, "heartbeat")
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.rank = _process_index() if rank is None else int(rank)
        self.n_ranks = _process_count() if n_ranks is None else int(n_ranks)
        self.on_stall = on_stall or _default_on_stall
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stalled = False
        self._t0 = time.time()

    # -- beat + scan ----------------------------------------------------

    def _path(self, r: int) -> str:
        return os.path.join(self.dir, f"rank_{r}.hb")

    def _age_out_departed(self) -> None:
        """Remove beat files of ranks OUTSIDE this run's rank set whose
        beat is stale past the timeout — leftovers of a LARGER earlier
        topology (an elastic resize 4→2 leaves rank_2/rank_3 files
        behind).  The scan below is scoped to ``range(n_ranks)`` so a
        departed rank can never be reported stalled, but the stale files
        must still be swept: a later GROW back to the old size would
        otherwise see beats older than its own start and burn its whole
        startup grace on ghosts.  Staleness (``now − mtime >
        timeout_s``), NOT age relative to this watchdog, is the test: a
        LIVE concurrent larger run's peers beat every ``interval_s``, so
        their files always look older than a freshly constructed
        watchdog yet must never be deleted — a sweep would open a
        one-beat window in which that run's scan sees the file missing
        and aborts with the very spurious exit-76 this sweep exists to
        prevent.  A not-yet-stale file of a genuinely departed rank is
        simply left for the regrow's startup grace to absorb."""
        import re

        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        now = time.time()
        pat = re.compile(r"^rank_(\d+)\.hb$")
        for name in names:
            m = pat.match(name)
            if m is None or int(m.group(1)) < self.n_ranks:
                continue
            path = os.path.join(self.dir, name)
            try:
                if now - os.path.getmtime(path) > self.timeout_s:
                    os.remove(path)
            except OSError:
                pass        # raced with another sweeper — fine

    def beat(self) -> None:
        """Touch this rank's beat file (atomic replace: a reader never
        sees a half-written beat)."""
        try:
            os.makedirs(self.dir, exist_ok=True)
            tmp = self._path(self.rank) + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{time.time():.3f}\n")
            os.replace(tmp, self._path(self.rank))
        except OSError as e:
            # a full/readonly shared dir must not kill a healthy rank —
            # peers will see THIS rank as stale, which is the honest signal
            log_warn(f"heartbeat write failed: {e!r}")

    def scan(self) -> Optional[dict]:
        """Peer ages; a stall report dict when any peer exceeds the
        timeout, else None.  A peer whose file never appeared — or whose
        beat PREDATES this watchdog (a leftover from a previous run in
        the same dir: a relaunch-after-preemption must not be killed by
        its own dead predecessor's files) — is only counted stale once
        the watchdog itself has been alive past the timeout (startup
        grace: ranks come up at different times).

        The scan is scoped to THIS run's rank set (``range(n_ranks)``):
        after an elastic resize, stale beat files of departed ranks —
        rank_2/rank_3 after a 4→2 shrink — are outside the set by
        construction and can never trigger a spurious ``stall_report`` /
        exit-76; :meth:`start` additionally ages the old files out so a
        later regrow does not meet its predecessors' ghosts."""
        now = time.time()
        ages = {}
        stalled = []
        grace_over = (now - self._t0) > self.timeout_s
        for r in range(self.n_ranks):
            if r == self.rank:
                continue
            try:
                mtime = os.path.getmtime(self._path(r))
            except OSError:
                mtime = None
            if mtime is None or mtime < self._t0:
                if not grace_over:
                    continue
                age = now - self._t0
            else:
                age = now - mtime
            ages[str(r)] = round(age, 1)
            if age > self.timeout_s:
                stalled.append(r)
        if not stalled:
            return None
        return {"rank": self.rank, "stalled": stalled, "ages_s": ages,
                "timeout_s": self.timeout_s}

    # -- lifecycle ------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.beat()
            report = self.scan()
            if report is not None and not self._stalled:
                self._stalled = True
                try:
                    # attach what THIS rank was doing when the peer went
                    # stale: the deepest open span (e.g. apply #12 /
                    # chunk 3) plus the full ancestry — a watchdog exit
                    # names the stuck phase, not just the stuck rank.
                    # (The wedged MAIN thread can't report its own state;
                    # the span stack is process-global precisely so this
                    # daemon thread can read it.)  Bounded lock waits:
                    # the abort below must fire even if the main thread
                    # died HOLDING the trace lock.
                    from ..obs import trace as obs_trace

                    sp = obs_trace.deepest_span(timeout=1.0)
                    if sp is not None:
                        report["span"] = sp
                        report["span_path"] = obs_trace.span_path(
                            timeout=1.0)
                except Exception:
                    pass
                try:
                    from ..obs import health as obs_health
                    from ..obs.events import emit, flush

                    emit("stall_report", **report)
                    if obs_health.probes_enabled():
                        obs_health.record("peer_stall", "critical",
                                          **report)
                    flush()
                except Exception:
                    pass
                try:
                    # post-mortem bundle BEFORE on_stall: the default
                    # handler is os._exit(76), so the bundle (carrying
                    # this rank's span_path) must already be on disk
                    from ..obs.flight import flight_dump

                    flight_dump("stall", exit_code=EXIT_STALLED,
                                report=report)
                except Exception:
                    pass
                self.on_stall(report)
                return
            self._stop.wait(self.interval_s)

    def start(self) -> "HeartbeatWatchdog":
        if self.n_ranks <= 1:
            return self          # nothing to watch — stay inert
        if self._thread is None:
            self._age_out_departed()
            self.beat()          # first beat synchronously: peers see us
            self._thread = threading.Thread(
                target=self._loop, name="dmt-heartbeat", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "HeartbeatWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

