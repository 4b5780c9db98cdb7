# Ported from apps/diagonalize.py.
"""Diagonalize: YAML model in → lowest-k eigenpairs + residuals out (HDF5).

    python -m distributed_matvec_tpu_torch.apps.diagonalize model.yaml \\
        -o out.h5 -k 2 --tol 1e-10 [--device cpu]

The command-line app of the port (the reference's ``bin/Diagonalize``,
``Diagonalize.chpl:258-332``):

  1. load the YAML config (basis + hamiltonian [+ observables]),
  2. build or *restore* the representative set from the output file
     (checkpoint semantics of ``makeBasisStates``, Diagonalize.chpl:227-246)
     — or, with ``--shards``, build the engine straight from a
     sharded-enumeration file (``DistributedEngine.from_shards``, mode
     ``fused`` by default): the global representative array never exists,
  3. run the eigensolver (:func:`solve`: Lanczos, block Lanczos on a
     streamed or hybrid engine, or LOBPCG with ``--block``) on the card
     (``--device``, default ``cuda``: it raises without one unless
     ``--device cpu`` is given) — one engine, D hash shards on the one
     device (``--devices``), or one shard per process rank
     (``--num-processes``); ``--solver-checkpoint`` checkpoints the
     Lanczos or LOBPCG solve, and a relaunch with the same argv (after a
     preemption, exit 75) resumes it, on the same D or another,
  4. save eigenvalues/eigenvectors/residuals into the output HDF5
     (Diagonalize.chpl:248-256; with ``--shards`` the eigenvectors stay
     hashed and are written per shard under
     ``vector_shards/eigenvector_<i>``) and print a summary (+ observable
     expectation values when requested).

The flags, the file layout, the start vectors (seed 42 on distributed
engines) and the exit codes are the JAX app's, so the two apps' files
compare dataset by dataset.  Reading the YAML needs ``yaml`` and the file
needs ``h5py``; where either is missing the app fails before any
enumeration, naming it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["Diagonalization", "build_parser", "solve", "observable_values",
           "main"]

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_matvec_tpu_torch.apps.diagonalize",
        description=__doc__.split("\n")[0],
        epilog="exit codes: 0 solved, 2 bad config/arguments, "
               "75 preempted (SIGTERM/SIGINT latched; the solve stops at "
               "its next safe point — relaunch the SAME argv; the solve "
               "service uses the same code when draining), 76 stalled "
               "(a wedged peer rank tripped the heartbeat watchdog).  A "
               "supervisor should retry 75/76 and treat other nonzero "
               "codes as permanent.  Solver kinds served over the same "
               "engines: eigs (lowest-k eigenpairs — this app, and the "
               "JobSpec default for --submit), kpm (Chebyshev/KPM "
               "spectral densities) and evolve (Krylov exp(-iHt) time "
               "evolution) — the dynamics kinds run via "
               "distributed_matvec_tpu_torch.apps.dynamics (same 75/76 "
               "contract) or a JobSpec with solver=kpm|evolve through "
               "the solve service.")
    ap.add_argument("input", help="YAML config (data/*.yaml schema)")
    ap.add_argument("-o", "--output", default=None,
                    help="output HDF5 (default: <input>.h5); also the "
                         "representative checkpoint (kOutput)")
    ap.add_argument("-k", "--num-evals", type=int, default=1,
                    help="number of eigenpairs (numEvals)")
    ap.add_argument("--tol", type=float, default=1e-10,
                    help="residual tolerance (kEps)")
    ap.add_argument("--max-iters", type=int, default=1000,
                    help="total Lanczos iteration cap")
    ap.add_argument("--max-basis-size", type=int, default=None,
                    help="Krylov basis bound before a thick restart "
                         "(kMaxBasisSize)")
    ap.add_argument("--min-restart-size", type=int, default=None,
                    help="Ritz vectors kept at a restart (kMinRestartSize)")
    ap.add_argument("--devices", type=int, default=0,
                    help="D hash shards on the one device (0 = a "
                         "single-device engine)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engine runs (default cuda; raises "
                         "without a card — pass cpu to run on the CPU)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="multi-process: the torch.distributed rendezvous "
                         "address (tcp://HOST:PORT; omit under torchrun)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="multi-process: total process count (one hash "
                         "shard per rank; NCCL on cuda, gloo on cpu)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="multi-process: this process's rank")
    ap.add_argument("--shards", default=None, metavar="SHARDS_H5",
                    help="construct the engine from a sharded-enumeration "
                         "file (enumeration.sharded.enumerate_to_shards) "
                         "— the global representative array is never "
                         "built; the solve stays in hashed space and "
                         "eigenvectors are saved per shard "
                         "(vector_shards/eigenvector_<i>)")
    ap.add_argument("--mode", choices=("ell", "compact", "streamed",
                                       "fused", "hybrid"),
                    default=None,
                    help="engine mode: precomputed structure (ell, the "
                         "default), 4 B/entry for isotropic real sectors "
                         "(compact), the structure resolved once into a "
                         "host-RAM plan streamed per apply (streamed; "
                         "solved via the block Lanczos), "
                         "recompute-on-the-fly (fused — the default with "
                         "--shards), or the per-term "
                         "recompute-vs-stream split priced by the "
                         "calibrated cost model (hybrid — the DMT_HYBRID "
                         "knob picks the split policy; solved like "
                         "streamed)")
    ap.add_argument("--block", action="store_true",
                    help="use LOBPCG (blocked) instead of Lanczos")
    ap.add_argument("--solver-checkpoint", default=None, metavar="CKPT_H5",
                    help="mid-solve Lanczos/LOBPCG checkpoint/resume file; "
                         "a rerun with the same config resumes where it "
                         "stopped — including after a preemption exit "
                         "(code 75), on the same --devices or another "
                         "(with --mode streamed/hybrid it is ignored with "
                         "a warning, as in the JAX app)")
    ap.add_argument("--checkpoint-every", type=int, default=4,
                    help="solver-checkpoint cadence in convergence-check "
                         "blocks (each block is check_every=16 "
                         "iterations)")
    ap.add_argument("--no-eigenvectors", action="store_true",
                    help="skip eigenvector computation/saving")
    ap.add_argument("--observables", action="store_true",
                    help="evaluate ⟨ψ|O|ψ⟩ for YAML observables")
    ap.add_argument("--timings", action="store_true",
                    help="print phase timings (kDisplayTimings)")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="telemetry run directory (sets obs_dir / "
                         "DMT_OBS_DIR): engine-init splits, solver "
                         "convergence traces, rank-tagged apply events and "
                         "phase timings stream to "
                         "DIR/rank_<r>/events.jsonl")
    ap.add_argument("--job-id", default=None, metavar="ID",
                    help="job-namespacing id stamped into every telemetry "
                         "event (DMT_JOB_ID; default: the run's trace id)")
    ap.add_argument("--submit", action="store_true",
                    help="do not solve inline: enqueue this run as a job "
                         "spec in --serve-dir's spool for a running solve "
                         "service and exit 0; the result lands in "
                         "<serve-dir>/done/<job_id>.json")
    ap.add_argument("--serve-dir", default=None, metavar="DIR",
                    help="solve-service spool directory for --submit "
                         "(created if missing)")
    ap.add_argument("--health", choices=("on", "strict", "off"),
                    default=None,
                    help="numerical-health watchdog (DMT_HEALTH): on = "
                         "log-and-continue (default), strict = critical "
                         "conditions (NaN/Inf outputs, exchange overflow, "
                         "Lanczos breakdown) raise HealthError, off = no "
                         "probes")
    return ap


@dataclass
class Diagonalization:
    """What :func:`solve` found."""

    eigenvalues: np.ndarray               # [k] ascending
    residuals: np.ndarray                 # [k]
    #: [k, N] block order on the host (None with ``eigenvectors=False``,
    #: and for a shard-native solve)
    eigenvectors: Optional[np.ndarray]
    iterations: int
    converged: bool
    engine_s: float                       # engine construction
    solve_s: float                        # the solver call
    engine: object = field(repr=False)
    #: a shard-native solve's eigenvectors, hashed (``[L, M]`` tensors)
    hashed_eigenvectors: Optional[list] = field(default=None, repr=False)
    #: iterations restored from the solver checkpoint
    resumed_from: int = 0


def _engine(op, mode: str, devices: int, device, group, shards=None):
    """The JAX app's engine choice: an engine from the shard file
    ``shards`` (``from_shards``, D from the file unless ``devices``); a
    rank engine over ``group``; a ``DistributedEngine`` for D > 1 or the
    streamed/hybrid modes (their single-device form at D = 1); else a
    ``LocalEngine``."""
    from ..parallel.distributed import DistributedEngine
    from ..parallel.engine import LocalEngine

    if shards:
        return DistributedEngine.from_shards(
            op, shards, n_devices=None if group is not None
            else devices or None, mode=mode, device=device, group=group)
    if group is not None:
        return DistributedEngine(op, group=group, mode=mode)
    if devices > 1 or mode in ("streamed", "hybrid"):
        return DistributedEngine(op, n_devices=devices or 1, mode=mode,
                                 device=device)
    return LocalEngine(op, mode=mode, device=device)


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") \
        else np.asarray(v)


def solve(cfg, *, k: int = 1, tol: float = 1e-10, max_iters: int = 1000,
          max_basis_size: Optional[int] = None,
          min_restart_size: Optional[int] = None, devices: int = 0,
          mode: str = "ell", block: bool = False, eigenvectors: bool = True,
          device="cuda", group=None, timer=None, shards=None,
          checkpoint_path: Optional[str] = None,
          checkpoint_every: int = 4) -> Diagonalization:
    """The app's solve on a built ``cfg.basis`` (or, with ``shards``, on
    the engine ``DistributedEngine.from_shards`` builds from that file):
    the engine for ``mode`` (``devices`` shards on ``device``, or one
    shard per rank of ``group``), then

    * ``block``: LOBPCG, residuals ``‖Hv − λv‖`` through the block-order
      apply;
    * ``mode`` streamed or hybrid: ``lanczos_block(seed=42)`` from the
      engine's hashed start block;
    * else ``lanczos`` (from ``random_hashed(seed=42)`` on a distributed
      engine).

    ``checkpoint_path`` checkpoints the Lanczos solve every
    ``checkpoint_every`` convergence-check blocks and the LOBPCG solve
    every 16·``checkpoint_every`` iterations (a streamed or hybrid block
    solve is not checkpointed), and resumes from it.  Eigenvectors come
    back in block order on the host — or, for a shard-native solve,
    hashed (``hashed_eigenvectors``).  A latched preemption raises
    ``utils.preempt.Preempted`` (the checkpoint written first)."""
    from contextlib import nullcontext

    from ..solve import lanczos, lanczos_block, lobpcg
    from ..utils.profiling import maybe_profile

    def scope(name):
        return timer.scope(name) if timer is not None else nullcontext()

    t0 = time.perf_counter()
    with scope("engine"):
        eng = _engine(cfg.hamiltonian, mode, devices, device, group, shards)
        v0 = eng.random_hashed(seed=42) if hasattr(eng, "from_hashed") \
            else None
    n = eng.n_states if shards else cfg.basis.number_states
    engine_s = time.perf_counter() - t0
    resumed_from = 0
    with scope("solve"), maybe_profile():
        t0 = time.perf_counter()
        if block:
            from .. import obs

            evals, cols, niter = lobpcg(
                eng.matvec, n, k=k, tol=tol, max_iters=max_iters,
                checkpoint_path=checkpoint_path,
                # the cadence counts Lanczos check blocks of 16
                # iterations; LOBPCG segments count iterations
                checkpoint_every=max(checkpoint_every, 1) * 16,
                device=eng.device)
            # LOBPCG's 3-tuple carries no resume count: its
            # solver_resume event does
            resumed = [e for e in obs.events("solver_resume")
                       if e.get("solver") == "lobpcg"]
            if checkpoint_path and resumed:
                resumed_from = int(resumed[-1]["iters"])
            cols = _host(cols)
            vecs = [cols[:, i] for i in range(cols.shape[1])]
            mv_block = getattr(eng, "matvec_global", None) \
                or (lambda v: _host(eng.matvec(v)))
            residuals = np.array([
                float(np.linalg.norm(mv_block(v) - w * v))
                for w, v in zip(evals, vecs)])
            converged = True
        else:
            if mode in ("streamed", "hybrid"):
                res = lanczos_block(eng.matvec, k=k, tol=tol,
                                    max_iters=max_iters, seed=42,
                                    compute_eigenvectors=eigenvectors)
            else:
                res = lanczos(eng.matvec, n=None if v0 is not None else n,
                              v0=v0, k=k, tol=tol, max_iters=max_iters,
                              max_basis_size=max_basis_size,
                              min_restart_size=min_restart_size,
                              compute_eigenvectors=eigenvectors,
                              checkpoint_path=checkpoint_path,
                              checkpoint_every=checkpoint_every,
                              device=eng.device)
                resumed_from = res.resumed_from
            evals, residuals, niter = (res.eigenvalues, res.residual_norms,
                                       res.num_iters)
            converged = res.converged
            vecs = res.eigenvectors
        solve_s = time.perf_counter() - t0
    rows = hashed = None
    if shards and vecs is not None and eigenvectors \
            and all(v.ndim == 2 for v in vecs[:k]):
        # shard-native: the eigenvectors stay hashed and are written per
        # shard — no global [N] array is ever materialized
        hashed = list(vecs[:k])
    elif vecs is not None and eigenvectors:
        out = []
        for v in vecs[:k]:
            # hashed → block order; on a rank engine from_hashed
            # all-gathers, so every rank makes the call
            if hasattr(eng, "from_hashed") and v.ndim == 2:
                out.append(eng.from_hashed(v))
            else:
                out.append(_host(v))
        rows = np.stack(out)
    return Diagonalization(
        eigenvalues=np.asarray(evals), residuals=np.asarray(residuals),
        eigenvectors=rows, iterations=int(niter), converged=converged,
        engine_s=engine_s, solve_s=solve_s, engine=eng,
        hashed_eigenvectors=hashed, resumed_from=resumed_from)


def observable_values(observables, eng, psi: np.ndarray
                      ) -> List[Tuple[str, float]]:
    """``[(name, ⟨ψ|O|ψ⟩)]`` for the block-order state ``psi``: each
    observable gets its own fused engine over the solve engine's basis,
    device and (distributed) layout (``models/observables.py``), and
    consumes ``psi`` in that layout."""
    import torch

    from ..models.observables import bind_observables

    if hasattr(eng, "from_hashed"):
        x = eng.to_hashed(psi)
    else:
        x = torch.from_numpy(psi).to(eng.device)
    return [(b.name, b.expectation(x))
            for b in bind_observables(observables, eng)]


def main(argv=None) -> int:
    """The command line (see :func:`build_parser`); returns the exit
    code."""
    from ..obs import trace as _trace

    # root run span: every event of the run (engine builds, solver
    # iterations, applies, the save) descends from one `diagonalize` span
    with _trace.span("diagonalize", kind="run"):
        return _main(argv)


def _submit(args) -> int:
    """Enqueue-and-exit: no engine, no solve, no device touch — the job
    spec carries everything the service needs to rebuild the model."""
    if not args.serve_dir:
        print("--submit needs --serve-dir DIR (the service's spool)",
              file=sys.stderr)
        return 2
    if args.block:
        print("--submit covers single-operator Lanczos jobs; --block runs "
              "stay inline", file=sys.stderr)
        return 2
    import uuid

    from ..serve import JobSpec, submit_to_spool

    job_id = args.job_id or f"cli-{uuid.uuid4().hex[:10]}"
    spec = JobSpec(job_id=job_id, yaml=os.path.abspath(args.input),
                   k=args.num_evals, tol=args.tol, max_iters=args.max_iters,
                   mode=args.mode or "ell", n_devices=args.devices)
    path = submit_to_spool(args.serve_dir, spec)
    print(f"submitted job {job_id} -> {path}")
    print(f"result will land at "
          f"{os.path.join(args.serve_dir, 'done', job_id + '.json')}")
    return 0


def _group(args, device):
    """The process group of a multi-process run (None otherwise)."""
    if not (args.coordinator or args.num_processes):
        return None
    from ..parallel.mesh import init_distributed

    return init_distributed(
        backend="nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{args.coordinator}" if args.coordinator
        else None,
        world_size=args.num_processes, rank=args.process_id,
        device=device)


def _restore_basis(cfg, out: str, group) -> bool:
    """Every rank restores from the same checkpoint (agreement even against
    a stale file); only rank 0 writes it, and the other ranks read after
    it has."""
    from ..io import make_or_restore_representatives

    if group is None:
        return make_or_restore_representatives(cfg.basis, out)
    import torch

    restored = False
    if group.rank == 0:
        restored = make_or_restore_representatives(cfg.basis, out)
    group.all_reduce(torch.zeros(1, device=group.device))   # barrier
    if group.rank != 0:
        restored = make_or_restore_representatives(cfg.basis, out,
                                                   save=False)
    return restored


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.submit:
        return _submit(args)

    from .. import obs
    from ..io import save_eigen
    from ..models.yaml_io import load_config_from_yaml
    from ..utils.config import get_config, update_config
    from ..utils.device import resolve_device
    from ..utils.timers import TreeTimer

    device = resolve_device(args.device)      # no card: raises here
    if args.obs_dir:
        update_config(obs_dir=args.obs_dir)
    if args.job_id:
        # env AND config: an inherited DMT_JOB_ID must not outrank the id
        # requested on the command line, and child processes inherit it
        os.environ["DMT_JOB_ID"] = args.job_id
        update_config(job_id=args.job_id)
    if args.health:
        # the env var outranks the config field, so set both
        os.environ["DMT_HEALTH"] = args.health
        update_config(health=args.health)
    group = _group(args, device)
    if args.timings:
        update_config(display_timings=True)
    # preemption latch BEFORE any long-running phase: a SIGTERM during the
    # basis/engine build still latches, and the solve exits at its first
    # safe point with EXIT_PREEMPTED
    import signal as _signal

    from ..utils import preempt as _preempt
    from ..utils.preempt import EXIT_PREEMPTED, Preempted

    _preempt.ensure_installed(signals=(_signal.SIGTERM, _signal.SIGINT))
    # every rank computes, rank 0 owns the output file (the reference's
    # locale-0 I/O role, MyHDF5.chpl:215-252)
    rank0 = group is None or group.rank == 0
    out = args.output or os.path.splitext(args.input)[0] + ".h5"
    # cross-rank heartbeat watchdog (DMT_HEARTBEAT_S > 0): a hung peer
    # becomes a stall_report + exit 76 instead of an endless collective
    watchdog = None
    cfg_rt = get_config()
    if cfg_rt.heartbeat_s > 0 and group is not None \
            and group.world_size > 1:
        from ..parallel.heartbeat import HeartbeatWatchdog

        hb_dir = args.obs_dir or os.path.dirname(os.path.abspath(out))
        watchdog = HeartbeatWatchdog(
            hb_dir, interval_s=cfg_rt.heartbeat_s,
            timeout_s=cfg_rt.heartbeat_timeout_s).start()
    mode = args.mode or ("fused" if args.shards else "ell")
    if args.solver_checkpoint and not args.block \
            and mode in ("streamed", "hybrid"):
        print("warning: --solver-checkpoint applies to the single-vector "
              "Lanczos and LOBPCG; streamed-mode block solves exit cleanly "
              "on preemption but are not checkpointed", file=sys.stderr)
    timer = TreeTimer("diagonalize")
    obs.emit("run_start", app="diagonalize", input=args.input, output=out,
             k=args.num_evals, devices=args.devices, mode=mode,
             block=bool(args.block))

    with timer.scope("load_config"):
        cfg = load_config_from_yaml(args.input, hamiltonian=True,
                                    observables=args.observables)
    if cfg.hamiltonian is None:
        print("config has no hamiltonian section", file=sys.stderr)
        return 2
    if args.shards:
        from ..enumeration.sharded import shard_manifest

        man = shard_manifest(args.shards)     # no h5py: raises here
        if man is None:
            print(f"no shard manifest at {args.shards}", file=sys.stderr)
            return 2
        print(f"basis: N={man['total']} states (shard-native from "
              f"{args.shards})")
    else:
        with timer.scope("basis"):
            restored = _restore_basis(cfg, out, group)
        print(f"basis: N={cfg.basis.number_states} states "
              f"({'restored from' if restored else 'checkpointed to'} "
              f"{out})")

    try:
        res = solve(cfg, k=args.num_evals, tol=args.tol,
                    max_iters=args.max_iters,
                    max_basis_size=args.max_basis_size,
                    min_restart_size=args.min_restart_size,
                    devices=args.devices, mode=mode, block=args.block,
                    eigenvectors=not args.no_eigenvectors, device=device,
                    group=group, timer=timer, shards=args.shards,
                    checkpoint_path=args.solver_checkpoint,
                    checkpoint_every=args.checkpoint_every)
    except Preempted as e:
        # close the run's telemetry and hand the supervisor the distinct
        # exit code — a relaunch with the SAME argv runs again
        print(f"preempted: {e}", file=sys.stderr)
        obs.emit("run_preempted", app="diagonalize", solver=e.solver,
                 iters=int(e.iters), checkpoint=e.checkpoint_path or "",
                 exit_code=EXIT_PREEMPTED)
        timer.emit(app="diagonalize")
        obs.emit("metrics_snapshot", metrics=obs.snapshot())
        obs.flush()
        if watchdog is not None:
            watchdog.stop()
        return EXIT_PREEMPTED
    if not res.converged:
        print("warning: solver did not converge", file=sys.stderr)
    dt, niter = res.solve_s, res.iterations
    if res.resumed_from:
        print(f"solver: resumed from {res.resumed_from} checkpointed "
              "iterations")
    print(f"solver: {niter} iterations in {dt:.2f}s "
          f"({niter / max(dt, 1e-9):.2f} iters/s)")
    obs.emit("diagonalize_result",
             eigenvalues=[float(w) for w in res.eigenvalues],
             residuals=[float(r) for r in res.residuals],
             iters=niter, solve_s=round(dt, 3))

    with timer.scope("save"):
        if rank0:
            save_eigen(out, res.eigenvalues, res.eigenvectors,
                       res.residuals)
        if res.hashed_eigenvectors is not None:
            # every rank writes its shards (out.r<rank> in a multi-process
            # run), one file pass for all k
            from ..io.sharded_io import save_hashed_vectors

            shards = res.engine._shards
            save_hashed_vectors(
                out, {f"eigenvector_{i}": {d: v[l] for l, d
                                           in enumerate(shards)}
                      for i, v in enumerate(res.hashed_eigenvectors)},
                res.engine.counts)
    for i, (w, r) in enumerate(zip(res.eigenvalues, res.residuals)):
        print(f"  E[{i}] = {w:.12f}   residual {r:.2e}")

    if args.observables and cfg.observables \
            and res.hashed_eigenvectors is not None:
        # shard-native observables: psi never leaves the hashed space; each
        # observable engine comes from the same shard file
        from ..io.hdf5 import save_observables
        from ..models.observables import expectations

        with timer.scope("observables"):
            values = expectations(cfg.observables, res.engine,
                                  res.hashed_eigenvectors[0],
                                  shards_path=args.shards)
        if rank0:
            for name, val in save_observables(out, values).items():
                print(f"  <{name}> = {val:.12f}")
    elif args.observables and cfg.observables \
            and res.eigenvectors is not None:
        # ⟨ψ₀|O|ψ₀⟩ per observable, printed and saved under /observables —
        # the output group the reference's Diagonalize creates
        # (Diagonalize.chpl:276-279)
        from ..io.hdf5 import save_observables

        with timer.scope("observables"):
            values = observable_values(cfg.observables, res.engine,
                                       res.eigenvectors[0])
        if rank0:
            for name, val in save_observables(out, values).items():
                print(f"  <{name}> = {val:.12f}")

    # phase timings + registry totals into the same stream the engines and
    # solvers wrote, then flush
    timer.emit(app="diagonalize")
    obs.emit("metrics_snapshot", metrics=obs.snapshot())
    obs.flush()
    timer.report()
    if watchdog is not None:
        watchdog.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
