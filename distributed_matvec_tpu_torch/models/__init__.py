"""Models layer, copied from ``distributed_matvec_tpu/models`` (the YAML
loader imports ``yaml`` only when it loads a file), and the bound
observables (``observables.py``)."""

from . import (basis, expression, lattices, observables,  # noqa: F401
               operator, symmetry, yaml_io)
