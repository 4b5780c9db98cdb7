# Copied from distributed_matvec_tpu/enumeration/__init__.py
"""Basis-state enumeration: portable NumPy path + native C++ kernel.

Dispatch (the ``_enumerateStates`` analog, StatesEnumeration.chpl:257-265):
the streaming C++ kernel handles projected sectors (compiled on first use,
``native.py``); the NumPy path covers trivial/spin-inversion-only sectors and
acts as the portable fallback.  ``enumeration_backend`` config: ``auto`` |
``native`` | ``numpy``, read from ``DMT_ENUMERATION_BACKEND`` (as the JAX
package's config reads it); ``native`` raises when the C++ kernel cannot be
built instead of falling back.
"""

import os
from typing import Optional, Tuple

import numpy as np

from . import host  # noqa: F401

__all__ = ["host", "enumerate_representatives"]


def enumerate_representatives(
    n_sites: int, hamming_weight: Optional[int], group
) -> Tuple[np.ndarray, np.ndarray]:
    backend = os.environ.get("DMT_ENUMERATION_BACKEND", "auto")
    projected = group is not None and not group.is_trivial
    spin_inv_only = (
        projected and len(group.perms) == 2 and group.flip[1]
        and group.networks[1].shifts == (0,)
    )
    if backend != "numpy" and projected and not spin_inv_only:
        from . import native

        out = native.enumerate_representatives_native(
            n_sites, hamming_weight, group)
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError("native enumeration requested but unavailable")
    return host.enumerate_representatives(n_sites, hamming_weight, group)
