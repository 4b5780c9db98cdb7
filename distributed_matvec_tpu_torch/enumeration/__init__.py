# Copied from distributed_matvec_tpu/enumeration/__init__.py
"""Basis-state enumeration: portable NumPy path + native C++ kernel.

Dispatch (the ``_enumerateStates`` analog, StatesEnumeration.chpl:257-265):
the streaming C++ kernel handles projected sectors (compiled on first use,
``native.py``); the NumPy path covers trivial/spin-inversion-only sectors and
acts as the portable fallback.  ``enumeration_backend`` config: ``auto`` |
``native`` | ``numpy`` (``DMT_ENUMERATION_BACKEND``); ``native`` raises when
the C++ kernel cannot be built instead of falling back.
"""

import os
from typing import Optional, Tuple

import numpy as np

from ..utils.config import get_config
from ..utils.timers import timed
from . import host  # noqa: F401

__all__ = ["host", "enumerate_representatives"]


def enumerate_representatives(
    n_sites: int, hamming_weight: Optional[int], group
) -> Tuple[np.ndarray, np.ndarray]:
    # the env var first, as the obs switches read theirs, so a harness can
    # flip it after the config was read
    backend = os.environ.get("DMT_ENUMERATION_BACKEND") \
        or get_config().enumeration_backend
    projected = group is not None and not group.is_trivial
    spin_inv_only = (
        projected and len(group.perms) == 2 and group.flip[1]
        and group.networks[1].shifts == (0,)
    )
    if backend != "numpy" and projected and not spin_inv_only:
        from . import native

        with timed(f"enumerate[native] n={n_sites} hw={hamming_weight} "
                   f"G={len(group)}"):
            out = native.enumerate_representatives_native(
                n_sites, hamming_weight, group)
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError("native enumeration requested but unavailable")
    with timed(f"enumerate[numpy] n={n_sites} hw={hamming_weight}"):
        return host.enumerate_representatives(n_sites, hamming_weight, group)
