"""Solvers: eigenpairs (single-vector and block Lanczos, LOBPCG) and the
dynamics family (Chebyshev/KPM spectral densities, Krylov time evolution),
all driving the engines through the same matvec contract."""

from .evolve import EvolveResult, krylov_evolve  # noqa: F401
from .kpm import (KPMResult, exact_moments, jackson_kernel,  # noqa: F401
                  kpm_dos, kpm_moments, kpm_spectral_function,
                  lorentz_kernel, reconstruct_dos, spectral_bounds)
from .lanczos import LanczosResult, lanczos, lanczos_block  # noqa: F401
from .lobpcg import lobpcg  # noqa: F401
