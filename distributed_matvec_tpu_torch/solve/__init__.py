"""Eigensolvers."""

from .lanczos import LanczosResult, lanczos  # noqa: F401
