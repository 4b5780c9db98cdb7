"""Helpers of the PyTorch port: unsigned 64-bit arithmetic on int64 tensors,
the device choice, and the build directory for native code."""

from . import build, device, u64  # noqa: F401
