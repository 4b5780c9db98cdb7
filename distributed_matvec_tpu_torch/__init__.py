"""distributed_matvec_tpu_torch — the PyTorch/CUDA port of
``distributed_matvec_tpu``.

It keeps the JAX package's module layout and names and imports nothing of
it: the host layer (models, enumeration, the plan codec's encode) is
copied, each file naming its source in its first line.  Layers, bottom to
top:

  utils/        — unsigned 64-bit arithmetic on int64 tensors, the device
                  choice, the native build directory, the runtime config,
                  the artifact cache (basis checkpoints, structure
                  sidecars, calibration and tuning records)
  io/           — HDF5 files: basis checkpoints, eigenpairs, observables,
                  golden matvecs, engine structure sidecars (h5py is
                  imported when a file is read or written)
  models/       — expressions → nonbranching terms, symmetry groups, bases,
                  operators, lattice constructors, the YAML loader
                  (copied); bound observables (expectation values over an
                  engine's basis)
  enumeration/  — representative enumeration, NumPy + C++ (copied)
  ops/          — tensor kernels (diag/off-diag apply, orbit scan, lookup),
                  the plan codec and its CUDA decode kernel (csrc/)
  parallel/     — the single-device engine (ell, compact, fused), the
                  hashed layout, the hash-sharded engine (streamed, ell,
                  compact, fused; single- and multi-column applies) with
                  D shards on one device or one shard per process rank,
                  and the process groups the ranks meet in (mesh.py)
  solve/        — thick-restart Lanczos (selective or full
                  reorthogonalization) and block Lanczos, LOBPCG,
                  KPM spectral densities, Krylov time evolution
  obs/          — telemetry (events, metrics, spans), per-apply phase
                  attribution, the roofline cost model and the card's
                  rate calibration (``python -m
                  distributed_matvec_tpu_torch.obs.calibrate``)
  tune/         — the autotuner: knob search under the calibrated rates,
                  tuned artifacts, the live rate posterior
  serve/        — the solve service (spool, priced admission, warm pool)
  apps/         — the command lines: ``diagonalize``, ``dynamics``,
                  ``solve_service`` (``python -m
                  distributed_matvec_tpu_torch.apps.<name>``)
  entry.py      — one forward step of the flagship model

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no device given and no CUDA device present they
raise.
"""

from . import models, utils  # noqa: F401
from .models.basis import SpinBasis
from .models.operator import Operator
from .models.yaml_io import Config, load_config_from_yaml
from .parallel.distributed import DistributedEngine
from .parallel.engine import LocalEngine
from .solve import (EvolveResult, KPMResult, LanczosResult,
                    exact_moments, jackson_kernel, kpm_dos, kpm_moments,
                    kpm_spectral_function, krylov_evolve, lanczos,
                    lanczos_block, lobpcg, lorentz_kernel, reconstruct_dos,
                    spectral_bounds)

__all__ = ["SpinBasis", "Operator", "Config", "load_config_from_yaml",
           "LocalEngine", "DistributedEngine",
           "LanczosResult", "lanczos", "lanczos_block", "lobpcg",
           "KPMResult", "spectral_bounds", "kpm_moments", "kpm_dos",
           "kpm_spectral_function", "jackson_kernel", "lorentz_kernel",
           "reconstruct_dos", "exact_moments", "EvolveResult",
           "krylov_evolve"]
