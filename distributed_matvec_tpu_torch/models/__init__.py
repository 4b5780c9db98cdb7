"""Models layer, copied from ``distributed_matvec_tpu/models`` (without the
YAML loader)."""

from . import basis, expression, lattices, operator, symmetry  # noqa: F401
