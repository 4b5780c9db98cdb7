"""One forward step of the flagship model, the port's counterpart of
``__graft_entry__.entry()``.

    step, (x,) = entry()
    y = step(x)

The flagship model is the 16-site Heisenberg ring in its symmetric sector
(translations, reflection, spin inversion); the step is one ``LocalEngine``
matvec in ``ell`` mode.  It runs on the card unless ``device`` names
another device.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.lattices import heisenberg_chain
from .parallel.engine import LocalEngine

__all__ = ["entry"]


def entry(device=None):
    """``(step, (x,))``: the ell matvec of chain_16_symm and its input, a
    standard normal vector from ``default_rng(42)``."""
    op = heisenberg_chain(16, symmetric=True)
    eng = LocalEngine(op, mode="ell", device=device)
    x = torch.from_numpy(np.random.default_rng(42).standard_normal(
        op.basis.number_states)).to(eng.device)
    return eng.matvec, (x,)
