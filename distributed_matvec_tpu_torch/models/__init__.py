"""Models layer, copied from ``distributed_matvec_tpu/models`` (without the
YAML loader), and the bound observables (``observables.py``)."""

from . import (basis, expression, lattices, observables,  # noqa: F401
               operator, symmetry)
