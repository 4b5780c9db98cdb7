"""Unsigned 64-bit arithmetic on ``int64`` tensors.

Basis states are u64 bit patterns.  PyTorch's ``uint64`` tensors refuse
``>>``, ``<`` and ``%``, so the port keeps every state in an ``int64`` tensor
holding the same 64 bits and does the unsigned operations here:

* ``>>`` on int64 is arithmetic (it copies bit 63 down), so a logical shift
  is the arithmetic one plus a mask;
* unsigned order is signed order after flipping bit 63 (``x ^ INT64_MIN``);
* ``%`` needs the high bit split off;
* torch has no popcount, so it is the SWAR reduction.

Multiplication and ``<<`` wrap modulo 2⁶⁴ on int64 as on u64, and ``&``,
``|``, ``^`` and ``==`` act on the bits, so they need no helper.  Shift
amounts are Python ints in [0, 63].
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["INT64_MIN", "as_signed", "from_numpy", "to_numpy", "srl",
           "ult", "umin", "umod", "popcount"]

INT64_MIN = -(1 << 63)

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_H01 = 0x0101010101010101


def as_signed(v: int) -> int:
    """A u64 value (Python int) as the int64 with the same bits."""
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >> 63 else v


def from_numpy(a, device=None) -> torch.Tensor:
    """u64 NumPy array → int64 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor → u64 NumPy array with the same bits."""
    return t.detach().cpu().numpy().view(np.uint64)


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift by ``s`` bits."""
    s = int(s)
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned ``a < b``; ``b`` is a tensor or a u64 Python int."""
    if not isinstance(b, torch.Tensor):
        b = as_signed(b)
    return (a ^ INT64_MIN) < (b ^ INT64_MIN)


def umin(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned elementwise minimum; ``b`` is a tensor or a u64 Python int."""
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, as_signed(b))
    return torch.where(ult(b, a), b, a)


def umod(x: torch.Tensor, d: int) -> torch.Tensor:
    """Unsigned ``x % d`` for a Python int ``0 < d < 2⁶³``: the low 63 bits
    and bit 63 (worth 2⁶³) are reduced apart and summed."""
    d = int(d)
    lo = (x & 0x7FFFFFFFFFFFFFFF) % d
    hi = torch.where(x < 0, (1 << 63) % d, 0)
    return (lo + hi) % d


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each element (SWAR), as int64."""
    x = x - (srl(x, 1) & _M1)
    x = (x & _M2) + (srl(x, 2) & _M2)
    x = (x + srl(x, 4)) & _M4
    return srl(x * _H01, 56)
