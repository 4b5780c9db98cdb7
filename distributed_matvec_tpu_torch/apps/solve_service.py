# Ported from apps/solve_service.py.
"""Solve service: drain (or keep serving) a spool of diagonalize jobs.

    python -m distributed_matvec_tpu_torch.apps.solve_service DIR --drain
    python -m distributed_matvec_tpu_torch.apps.solve_service DIR \\
        --max-idle-s 300 --obs-dir /path/to/run

The process behind the job-stream layer (``distributed_matvec_tpu_torch/
serve/``): scans ``<serve_dir>/queue/`` for job specs (any JSON writer, or
the JAX package's ``submit_to_spool``), admits them against the capacity
model, groups same-engine jobs, batches each group through
``lanczos_block``'s multi-RHS path over a warm LRU engine pool on the card
(``--device``, default ``cuda``), and writes per-job results into
``<serve_dir>/done/<job_id>.json``.  The spool format and the exit codes
are the JAX service's, so either package's service drains the other's
spool.

Exit codes:

* ``0``   — drained (``--drain``) or stopped after ``--max-idle-s``.
* ``75``  — preempted (SIGTERM/SIGINT latched): the running batch exits
  at its next block boundary, every in-flight job is respooled as
  queued, telemetry is flushed.  Relaunch with the same argv to resume
  the undone work.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m distributed_matvec_tpu_torch.apps.solve_service",
        description=__doc__.split("\n")[0],
        epilog="exit codes: 0 drained/idle-stopped, 75 preempted "
               "(relaunch the same argv to resume)")
    ap.add_argument("serve_dir", help="spool directory (queue/ + done/)")
    ap.add_argument("--drain", action="store_true",
                    help="exit 0 once the queue is empty instead of "
                         "polling for new submissions")
    ap.add_argument("--poll-s", type=float, default=0.5,
                    help="spool scan interval while idle (default 0.5)")
    ap.add_argument("--max-idle-s", type=float, default=None,
                    help="stop after this much continuous idleness "
                         "(default: serve forever)")
    ap.add_argument("--block-width", type=int, default=None,
                    help="max jobs batched into one lanczos_block call "
                         "(default: config serve_block_width)")
    ap.add_argument("--pool-gb", type=float, default=None,
                    help="engine-pool byte budget in GB (default: config "
                         "serve_pool_gb)")
    ap.add_argument("--hbm-gb", type=float, default=16.0,
                    help="device-memory budget admission prices against")
    ap.add_argument("--host-ram-gb", type=float, default=64.0,
                    help="host-RAM budget for streamed-mode plans")
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="rate-calibration JSON (gather_rows_per_s, "
                         "h2d_bytes_per_s, exchange_bytes_per_s, "
                         "flops_per_s); admission ETAs are unpriced "
                         "without one")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="telemetry run directory (job_event/admission/"
                         "engine_pool events under rank_<r>/)")
    ap.add_argument("--port", type=int, default=None, metavar="PORT",
                    help="serve GET /metrics (OpenMetrics) and "
                         "GET /healthz on this port (default: "
                         "DMT_OBS_PORT + rank when set, else no "
                         "endpoint; 0 binds an ephemeral port)")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (default cuda; raises "
                         "without a card — pass cpu to run on the CPU)")
    args = ap.parse_args(argv)

    from distributed_matvec_tpu_torch import obs
    from distributed_matvec_tpu_torch.serve import (EnginePool, JobQueue,
                                                    Scheduler, SolveService)
    from distributed_matvec_tpu_torch.utils.config import update_config

    if args.obs_dir:
        update_config(obs_dir=args.obs_dir)

    # crash observability BEFORE any heavy work: fatal-signal tracebacks
    # land in the postmortem dir, and the scrape endpoint is live while
    # the pool warms
    obs.install_fatal_handlers()
    server = obs.start_exporter(port=args.port)

    with obs.span("solve_service", kind="run"):
        pool = EnginePool(max_bytes=int(args.pool_gb * 1e9)
                          if args.pool_gb is not None else None,
                          device=args.device)
        sched = Scheduler(queue=JobQueue(args.serve_dir), pool=pool,
                          calibration_path=args.calibration,
                          block_width=args.block_width,
                          hbm_gb=args.hbm_gb,
                          host_ram_gb=args.host_ram_gb)
        rc = SolveService(args.serve_dir, scheduler=sched,
                          poll_s=args.poll_s).run(
            drain=args.drain, max_idle_s=args.max_idle_s)
    obs.emit("metrics_snapshot", metrics=obs.snapshot())
    obs.write_textfile()       # the textfile rank 0's /metrics aggregates
    obs.flush()
    if server is not None:
        obs.stop_exporter()
    return rc


if __name__ == "__main__":
    sys.exit(main())
