# Ported from apps/dynamics.py.
"""Dynamics: YAML model in → KPM spectral density or exp(-iHt) trajectory.

    python -m distributed_matvec_tpu_torch.apps.dynamics model.yaml \\
        --solver kpm --moments 256 -o dos.h5 [--device cpu]
    python -m distributed_matvec_tpu_torch.apps.dynamics model.yaml \\
        --solver evolve --t-final 5 --observables

The dynamics-family command line beside ``apps/diagonalize.py``: the
same engine stack (``DistributedEngine`` in any mode, ``--devices``
shards on the one device, ``--device`` default ``cuda``), the same
exit-code contract, but
the solve (:func:`run`) is Chebyshev/KPM moments + a kernel-reconstructed
density of states (``--solver kpm``) or Krylov time evolution with drift
telemetry and optional per-step observable trajectories (``--solver
evolve``).  The output group (``/kpm`` or ``/evolve``) and the seeds are
the JAX app's.  Reading the YAML needs ``yaml`` and the file needs
``h5py``; where either is missing the app fails before the engine is
built, naming it.  ``--checkpoint`` checkpoints the KPM recurrence or the
evolve trajectory every ``--checkpoint-every`` steps and at a preemption
(exit 75); a relaunch with the same argv resumes it (an evolve trajectory
bit for bit).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Tuple

import numpy as np

__all__ = ["build_parser", "run", "main"]

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_matvec_tpu_torch.apps.dynamics",
        description=__doc__.split("\n")[0],
        epilog="exit codes: 0 solved, 2 bad config/arguments, "
               "75 preempted (SIGTERM/SIGINT latched; the solve stops at "
               "its next step boundary — relaunch the SAME argv), 76 "
               "stalled (heartbeat watchdog).  A supervisor should retry "
               "75/76 and treat other nonzero codes as permanent — the "
               "same contract as the diagonalize app.")
    ap.add_argument("input", help="YAML config (data/*.yaml schema)")
    ap.add_argument("--solver", choices=("kpm", "evolve"), default="kpm",
                    help="dynamics solver: Chebyshev/KPM spectral "
                         "density (kpm) or Krylov exp(-iHt) time "
                         "evolution (evolve); eigenpair solves live in "
                         "the diagonalize app")
    ap.add_argument("-o", "--output", default=None,
                    help="output HDF5 (default: <input>.dyn.h5)")
    ap.add_argument("--mode", choices=("ell", "compact", "streamed",
                                       "fused", "hybrid"),
                    default="streamed",
                    help="engine mode (default streamed: the plan is "
                         "resolved once and re-streamed per apply — the "
                         "regime repeated-matvec dynamics amortizes "
                         "best)")
    ap.add_argument("--devices", type=int, default=0,
                    help="D hash shards on the one device (0 = one)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engine runs (default cuda; raises "
                         "without a card — pass cpu to run on the CPU)")
    # -- kpm ---------------------------------------------------------------
    ap.add_argument("--moments", type=int, default=256,
                    help="kpm: Chebyshev moment count (energy "
                         "resolution ~ pi*spectral_halfwidth/moments)")
    ap.add_argument("--vectors", type=int, default=4,
                    help="kpm: stochastic-trace random vectors (error "
                         "~ 1/sqrt(n_states*vectors))")
    ap.add_argument("--kernel", choices=("jackson", "lorentz", "none"),
                    default="jackson", help="kpm: damping kernel")
    ap.add_argument("--points", type=int, default=512,
                    help="kpm: energy-grid points for the DOS")
    ap.add_argument("--bounds-iters", type=int, default=64,
                    help="kpm: Lanczos iterations for the spectral "
                         "bracket")
    # -- evolve ------------------------------------------------------------
    ap.add_argument("--t-final", type=float, default=1.0,
                    help="evolve: trajectory length")
    ap.add_argument("--dt0", type=float, default=None,
                    help="evolve: initial adaptive step (default "
                         "t_final/16)")
    ap.add_argument("--krylov-dim", type=int, default=24,
                    help="evolve: per-step Krylov dimension")
    ap.add_argument("--tol", type=float, default=1e-12,
                    help="evolve: local-error budget per unit time")
    ap.add_argument("--observables", action="store_true",
                    help="evolve: record <psi|O|psi> trajectories for "
                         "the YAML observables (bound fused-mode "
                         "engines sharing the basis)")
    # -- shared ------------------------------------------------------------
    ap.add_argument("--seed", type=int, default=42,
                    help="start-state / random-vector seed")
    ap.add_argument("--checkpoint", default=None, metavar="CKPT_H5",
                    help="mid-run checkpoint/resume file: the solver "
                         "state is written every --checkpoint-every steps "
                         "and at a preemption; a relaunch with the same "
                         "argv resumes")
    ap.add_argument("--checkpoint-every", type=int, default=16,
                    help="checkpoint cadence in solver steps")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="telemetry run directory (DMT_OBS_DIR)")
    ap.add_argument("--job-id", default=None, metavar="ID",
                    help="job-namespacing id (DMT_JOB_ID)")
    return ap


def run(cfg, *, solver: str = "kpm", mode: str = "streamed",
        devices: int = 0, device="cuda", moments: int = 256,
        vectors: int = 4, kernel: str = "jackson", points: int = 512,
        bounds_iters: int = 64, t_final: float = 1.0, dt0=None,
        krylov_dim: int = 24, tol: float = 1e-12, observables: bool = False,
        seed: int = 42, checkpoint_path=None,
        checkpoint_every: int = 16) -> Tuple[dict, object, object, float]:
    """The app's solve: ``DistributedEngine(cfg.hamiltonian, n_devices=
    devices or 1, mode=mode)`` on ``device``, then ``kpm_moments`` +
    ``reconstruct_dos`` or ``krylov_evolve`` (with ``cfg.observables``
    bound when ``observables``), checkpointed to ``checkpoint_path`` every
    ``checkpoint_every`` steps when given.  Returns ``(payload, result, engine,
    seconds)``: ``payload`` the output group's datasets by name, the
    solver's result, the engine and the solve's seconds.  A latched
    preemption raises ``utils.preempt.Preempted``."""
    from ..parallel.distributed import DistributedEngine

    eng = DistributedEngine(cfg.hamiltonian, n_devices=devices or 1,
                            mode=mode, device=device)
    t0 = time.perf_counter()
    if solver == "kpm":
        from ..solve import kpm_moments, reconstruct_dos

        res = kpm_moments(eng.matvec, n_moments=moments, n_vectors=vectors,
                          seed=seed, bounds_iters=bounds_iters,
                          checkpoint_path=checkpoint_path,
                          checkpoint_every=checkpoint_every)
        energies, rho = reconstruct_dos(res.moments, res.scale,
                                        npoints=points, kernel=kernel)
        payload = {"moments": res.moments,
                   "moment_stderr": res.moment_stderr,
                   "energies": energies, "dos": rho,
                   "bounds": np.asarray(res.bounds),
                   "scale": np.asarray(res.scale)}
    else:
        from ..solve import krylov_evolve

        bound = []
        if observables and cfg.observables:
            from ..models.observables import bind_observables
            bound = bind_observables(cfg.observables, eng)
        res = krylov_evolve(eng.matvec, t_final=t_final, dt0=dt0,
                            krylov_dim=krylov_dim, tol=tol, seed=seed,
                            observables=bound,
                            checkpoint_path=checkpoint_path,
                            checkpoint_every=checkpoint_every)
        payload = {"times": res.times, "energies": res.energies,
                   "norm_drift": np.float64(res.norm_drift),
                   "energy_drift": np.float64(res.energy_drift)}
        for name, series in (res.observables or {}).items():
            payload[f"obs_{name}_t"] = np.asarray([t for t, _ in series])
            payload[f"obs_{name}"] = np.asarray([v for _, v in series])
    return payload, res, eng, time.perf_counter() - t0


def main(argv=None) -> int:
    """The command line (see :func:`build_parser`); returns the exit
    code."""
    from ..obs import trace as _trace

    with _trace.span("dynamics", kind="run"):
        return _main(argv)


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .. import obs
    from ..io.hdf5 import _h5py
    from ..models.yaml_io import load_config_from_yaml
    from ..utils.config import update_config
    from ..utils.device import resolve_device

    device = resolve_device(args.device)      # no card: raises here
    if args.obs_dir:
        update_config(obs_dir=args.obs_dir)
    if args.job_id:
        os.environ["DMT_JOB_ID"] = args.job_id
        update_config(job_id=args.job_id)

    import signal as _signal

    from ..utils import preempt as _preempt
    from ..utils.preempt import EXIT_PREEMPTED, Preempted

    _preempt.ensure_installed(signals=(_signal.SIGTERM, _signal.SIGINT))

    out = args.output or os.path.splitext(args.input)[0] + ".dyn.h5"
    obs.emit("run_start", app="dynamics", input=args.input, output=out,
             solver=args.solver, mode=args.mode, devices=args.devices)

    cfg = load_config_from_yaml(args.input, hamiltonian=True,
                                observables=args.observables)
    if cfg.hamiltonian is None:
        print("config has no hamiltonian section", file=sys.stderr)
        return 2
    h5py = _h5py()            # the output file: fail before the build

    try:
        payload, res, eng, dt = run(
            cfg, solver=args.solver, mode=args.mode, devices=args.devices,
            device=device, moments=args.moments, vectors=args.vectors,
            kernel=args.kernel, points=args.points,
            bounds_iters=args.bounds_iters, t_final=args.t_final,
            dt0=args.dt0, krylov_dim=args.krylov_dim, tol=args.tol,
            observables=args.observables, seed=args.seed,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every)
    except Preempted as e:
        print(f"preempted: {e}", file=sys.stderr)
        obs.emit("run_preempted", app="dynamics", solver=e.solver,
                 iters=int(e.iters), checkpoint=e.checkpoint_path or "",
                 exit_code=EXIT_PREEMPTED)
        obs.emit("metrics_snapshot", metrics=obs.snapshot())
        obs.flush()
        return EXIT_PREEMPTED
    print(f"basis: N={eng.n_states} states, engine mode={args.mode}")
    if args.solver == "kpm":
        print(f"kpm: {args.moments} moments ({res.num_applies} applies) in "
              f"{dt:.2f}s ({res.steady_moments_per_s:.1f} moments/s "
              "steady)")
        print(f"  spectral bracket [{res.bounds[0]:.6f}, "
              f"{res.bounds[1]:.6f}]")
    else:
        if res.resumed_from:
            print(f"solver: resumed from {res.resumed_from} checkpointed "
                  "steps")
        print(f"evolve: t={res.times[-1]:.6f} in {res.num_steps} steps / "
              f"{res.num_applies} applies in {dt:.2f}s "
              f"({res.steady_steps_per_s:.2f} steps/s steady)")
        print(f"  norm drift {res.norm_drift:.3e}, energy drift "
              f"{res.energy_drift:.3e}")
        for name, series in (res.observables or {}).items():
            print(f"  <{name}>(t={series[-1][0]:.4f}) = "
                  f"{series[-1][1]:.12f}")

    with h5py.File(out, "a") as f:
        grp = f.require_group(args.solver)
        for key, val in payload.items():
            if key in grp:
                del grp[key]
            grp.create_dataset(key, data=val)
    print(f"wrote /{args.solver} -> {out}")
    obs.emit("dynamics_result", solver=args.solver,
             **{k: (float(v) if np.ndim(v) == 0 else int(np.size(v)))
                for k, v in payload.items()})
    obs.emit("metrics_snapshot", metrics=obs.snapshot())
    obs.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
