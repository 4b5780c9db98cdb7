"""The ELL apply of the engines' ``ell`` mode, over the transposed tables.

For every row ``i < n`` of a state-major block ``x`` (``[rows]`` or
``[rows, R]``, ``rows ≥ n``):

    y[i] = diag[i]·x[i] + Σ_{t<T0} coeff[t, i]·x[idx[t, i]]

then, over the tail's S unique rows, ``y[rows[s]] += Σ_t tail_coeff[t, s]·
x[tail_idx[t, s]]``.  :func:`ell_apply` launches the hand-written kernel of
``csrc/ell_apply.cu`` for CUDA tensors (one launch, and one more for a
tail; ``ell_apply.launches`` counts them) and runs :func:`ell_apply_plain`,
term by term in PyTorch, for CPU tensors.  Both sum in the same order with
the same roundings, so a real sector's ``y`` is the same to the bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..obs import trace as obs_trace

__all__ = ["ell_apply", "ell_apply_plain"]

Tail = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_DTYPES = (torch.float64, torch.complex128)


def _col(x: torch.Tensor):
    """Index that broadcasts a per-row ``[n]`` tensor over ``x``'s
    columns."""
    return (slice(None),) + (None,) * (x.ndim - 1)


def _terms_plain(x, diag, idx, coeff) -> torch.Tensor:
    n, col = idx.shape[1], _col(x)
    y = diag.to(x.dtype)[col] * x[:n]
    for t in range(idx.shape[0]):
        y += coeff[t][col] * torch.index_select(x, 0, idx[t])
    return y


def _tail_plain(y, x, rows, idx, coeff) -> None:
    col = _col(x)
    acc = torch.zeros((rows.shape[0],) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    for t in range(idx.shape[0]):
        acc += coeff[t][col] * torch.index_select(x, 0, idx[t])
    y[rows.long()] += acc


def ell_apply_plain(x: torch.Tensor, diag: torch.Tensor, idx: torch.Tensor,
                    coeff: torch.Tensor, tail: Optional[Tail] = None
                    ) -> torch.Tensor:
    """:func:`ell_apply` term by term in PyTorch, on any device: per term
    a gather, a multiply and an add over the state axis."""
    y = _terms_plain(x, diag, idx, coeff)
    if tail is not None:
        _tail_plain(y, x, *tail)
    return y


def _ld(table: torch.Tensor) -> int:
    """Row stride of a ``[T, k]`` table in elements (``k`` for one row)."""
    return table.stride(0) if table.shape[0] > 1 else table.shape[1]


def _launch(lib, fn: str, *args) -> None:
    from . import cuda_kernels

    rc = getattr(lib, fn)(*args)
    if rc:
        raise RuntimeError(f"ell_apply launch failed: "
                           f"{cuda_kernels.error_string(lib, rc)}")


def _terms_kernel(x, diag, idx, coeff) -> torch.Tensor:
    from . import cuda_kernels

    lib = cuda_kernels.library("ell_apply")
    n = idx.shape[1]
    y = torch.empty((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    if not y.numel():
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _launch(lib, "dmt_ell_apply", int(x.is_complex()), n, _columns(x),
            idx.shape[0], idx.data_ptr(), _ld(idx), coeff.data_ptr(),
            _ld(coeff), diag.data_ptr(), x.data_ptr(), y.data_ptr(), stream)
    ell_apply.launches += 1
    return y


def _tail_kernel(y, x, rows, idx, coeff) -> None:
    from . import cuda_kernels

    lib = cuda_kernels.library("ell_apply")
    S = rows.shape[0]
    if not (S and y.numel()):
        return
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _launch(lib, "dmt_ell_tail", int(x.is_complex()), S, _columns(x),
            idx.shape[0], rows.data_ptr(), idx.data_ptr(), _ld(idx),
            coeff.data_ptr(), _ld(coeff), x.data_ptr(), y.data_ptr(), stream)
    ell_apply.launches += 1


def _columns(x: torch.Tensor) -> int:
    return x.shape[1] if x.ndim == 2 else 1


def _check(x, diag, idx, coeff, tail) -> None:
    """Raise ``ValueError`` on an operand the kernel does not take."""
    def table(name, a, dtype, k):
        return (a.dtype == dtype and a.ndim == 2 and a.shape[1] == k
                and (a.shape[1] <= 1 or a.stride(1) == 1)
                and (a.shape[0] <= 1 or a.stride(0) >= k),
                f"{name}: {dtype} [T, {k}] with unit stride along its "
                f"last axis")

    if not (x.ndim in (1, 2) and x.is_contiguous()):
        raise ValueError("ell_apply operand x: contiguous state-major "
                         "[rows] or [rows, R]")
    n = idx.shape[1] if idx.ndim == 2 else -1
    checks = [
        (x.dtype in _DTYPES, "x: float64 or complex128"),
        table("idx", idx, torch.int32, n),
        table("coeff", coeff, x.dtype, n),
        (coeff.shape[0] == idx.shape[0], "coeff: as many terms as idx"),
        (diag.dtype == torch.float64 and diag.ndim == 1
         and diag.shape[0] == n and diag.is_contiguous(),
         f"diag: contiguous float64 [{n}]"),
        (x.shape[0] >= n and x.shape[0] < 1 << 31,
         f"x: at least {n} and below 2^31 rows"),
    ]
    operands = [x, diag, idx, coeff]
    if tail is not None:
        rows, t_idx, t_cf = tail
        S = rows.shape[0] if rows.ndim == 1 else -1
        checks += [
            (rows.dtype == torch.int32 and rows.ndim == 1
             and rows.is_contiguous(), "tail rows: contiguous int32 [S]"),
            table("tail idx", t_idx, torch.int32, S),
            table("tail coeff", t_cf, x.dtype, S),
            (t_cf.shape[0] == t_idx.shape[0],
             "tail coeff: as many terms as tail idx"),
        ]
        operands += [rows, t_idx, t_cf]
    for ok, want in checks:
        if not ok:
            raise ValueError(f"ell_apply operand {want}")
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"ell_apply operands on several devices: "
                         f"{sorted(map(str, devices))}")


def ell_apply(x: torch.Tensor, diag: torch.Tensor, idx: torch.Tensor,
              coeff: torch.Tensor, tail: Optional[Tail] = None
              ) -> torch.Tensor:
    """``y = diag·x[:n] + Σ_t coeff[t]·x[idx[t]]``, then the tail's rows;
    returns ``y``, ``[n]`` or ``[n, R]`` like ``x``.

    ``x`` is state-major and contiguous, float64 or complex128, with at
    least ``n`` rows (a shard's ``[x; received]`` has more); ``diag`` is
    float64 ``[n]``; ``idx`` (int32) and ``coeff`` (``x``'s dtype) are
    ``[T0, n]`` with unit stride along the state axis, so a slice of wider
    tables is read in place.  ``tail`` is ``(rows, tail_idx, tail_coeff)``:
    int32 ``[S]`` unique rows and ``[Tw, S]`` tables alike.  Every index is
    below ``x``'s row count.

    CPU tensors take :func:`ell_apply_plain`; CUDA tensors launch the
    kernel of ``csrc/ell_apply.cu`` on the current stream or raise.  The
    ``terms`` and ``tail`` detail spans time the two steps."""
    _check(x, diag, idx, coeff, tail)
    if x.device.type == "cpu":
        terms, tail_add = _terms_plain, _tail_plain
    elif x.device.type == "cuda":
        terms, tail_add = _terms_kernel, _tail_kernel
    else:
        raise ValueError(f"no ELL apply kernel for device {x.device}")
    t = obs_trace.detail_start()
    y = terms(x, diag, idx, coeff)
    t = obs_trace.detail_end("terms", t, idx.shape[0])
    if tail is not None:
        tail_add(y, x, *tail)
        obs_trace.detail_end("tail", t)
    return y


ell_apply.launches = 0
