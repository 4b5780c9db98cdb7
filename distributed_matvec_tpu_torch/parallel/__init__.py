"""Hashed layout and the streamed matvec engine."""

from . import distributed, shuffle  # noqa: F401
