"""The device an entry point runs on.

Entry points run on the card unless the caller names another device: with
no device given and no CUDA device present they raise, so a run never drops
to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "start_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``.  A
    CUDA device raises when none is present.  A CUDA device gets its index
    (the current device when none is given), so it compares equal to the
    device of the tensors made on it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def start_device(start=None, device: Optional[Union[str, torch.device]] = None
                 ) -> torch.device:
    """The device a solver runs on: ``device`` when given, else the device
    of its start vector or block ``start`` when that is already a tensor,
    else :func:`resolve_device`'s default (``cuda``, raising without
    one)."""
    if device is None and isinstance(start, torch.Tensor):
        return start.device
    return resolve_device(device)
