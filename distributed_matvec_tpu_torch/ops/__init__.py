"""Tensor kernels, the plan codec, and the CUDA kernel loader."""

from . import bits, kernels, plan_codec  # noqa: F401
