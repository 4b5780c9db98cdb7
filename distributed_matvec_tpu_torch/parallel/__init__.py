"""Hashed layout, the matvec engines and the rank groups."""

from . import distributed, mesh, shuffle  # noqa: F401
