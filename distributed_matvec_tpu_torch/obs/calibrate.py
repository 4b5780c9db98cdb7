# Counterpart of tools/gather_bound.py (the rate microbenchmark that writes the calibration sidecar).
"""Measure the four rates of the roofline model on the device.

    python -m distributed_matvec_tpu_torch.obs.calibrate [--quick]
        [--calibration-out PATH] [--no-save] [--device cuda|cpu]

Each rate is what one phase of ``obs/phases.py`` is priced at
(``obs/roofline.py::phase_bounds_ms``), measured on the work that phase
does:

* ``gather_rows_per_s`` — random f64 row gathers (``index_select``, the
  access pattern of the ELL terms and the streamed receive side) from a
  table of 4 718 592 rows, chain_32_symm's size, one gather per row;
* ``h2d_bytes_per_s`` — a 64 MiB copy from pinned host memory to the
  device, as the streamed plan travels;
* ``flops_per_s`` — the int64 elementwise operations of one orbit-scan
  step (shift, mask, or, xor, compare, select over a chunk's ``[B·T]``
  states), which is what ``ORBIT_OPS`` charges per group element;
* ``exchange_bytes_per_s`` — the exchange of the one-process engine: the
  ``all_to_all`` of four shards' send buffers, a device-to-device
  transpose copy; on a rank group (``group=``) what
  ``ShardGroup.exchange`` costs.

Times come from CUDA events on the card (the median of several repeats
after a warm-up) and from ``perf_counter`` on the CPU.  The result is
tagged ``source="measured"``, ``backend`` and ``device_kind``, and saved
as the content-addressed sidecar the engines, the tuner and serve
admission read (``obs/roofline.py::resolve_calibration``).  It runs on
``cuda`` unless ``--device cpu`` is given, and raises with no card.
``--quick`` shrinks every buffer 16× (a smoke check, not a calibration).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Callable, Optional

import torch

from ..utils.device import resolve_device
from . import roofline as _roofline

__all__ = ["calibrate", "measure_gather", "measure_h2d", "measure_flops",
           "measure_exchange", "power_limit", "main"]

#: chain_32_symm's table size: 4 707 969 representatives, padded.
GATHER_ROWS = 4_718_592
H2D_BYTES = 64 << 20
#: one chunk's states at B = 65 536 rows × 32 terms
SCAN_ELEMS = 1 << 21
#: int64 elementwise operations per element in :func:`_scan_step`
SCAN_STEP_OPS = 8
EXCHANGE_BYTES = 64 << 20
REPS = 7


def _median_ms(device: torch.device, fn: Callable[[], object],
               reps: int = REPS) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after a warm-up
    run: CUDA events on the card, ``perf_counter`` on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def measure_gather(device: torch.device, rows: int = GATHER_ROWS) -> float:
    """Random f64 row gathers per second from a ``[rows]`` table."""
    g = torch.Generator(device="cpu").manual_seed(0)
    table = torch.rand(rows, generator=g, dtype=torch.float64).to(device)
    idx = torch.randint(0, rows, (rows,), generator=g).to(device)
    out = torch.empty(rows, dtype=torch.float64, device=device)
    ms = _median_ms(device, lambda: torch.index_select(table, 0, idx,
                                                       out=out))
    return rows / (ms * 1e-3)


def measure_h2d(device: torch.device, nbytes: int = H2D_BYTES) -> float:
    """Host → device bytes per second from pinned memory (a host copy on
    the CPU, where the plan never leaves host memory)."""
    src = torch.empty(nbytes, dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    src.fill_(1)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=device)
    ms = _median_ms(device, lambda: dst.copy_(src, non_blocking=True))
    return nbytes / (ms * 1e-3)


def _scan_step(x: torch.Tensor, m: int) -> torch.Tensor:
    """One orbit-scan-like step: a masked bit permutation, its xor with
    the state, and the keep-the-smaller select (8 int64 elementwise
    operations per element)."""
    y = ((x >> 1) & m) | ((x & m) << 1)        # 5 ops
    y = y ^ x                                   # 1
    return torch.where(y < x, y, x)             # 2


def measure_flops(device: torch.device, elems: int = SCAN_ELEMS,
                  steps: int = 16) -> float:
    """int64 elementwise operations per second of the orbit-scan step."""
    g = torch.Generator(device="cpu").manual_seed(2)
    x0 = torch.randint(0, 1 << 62, (elems,), generator=g).to(device)
    m = 0x5555555555555555 & ((1 << 62) - 1)

    def run():
        x = x0
        for _ in range(steps):
            x = _scan_step(x, m)
        return x

    ms = _median_ms(device, run)
    return elems * steps * SCAN_STEP_OPS / (ms * 1e-3)


def measure_exchange(device: torch.device, nbytes: int = EXCHANGE_BYTES,
                     group=None, shards: int = 4) -> float:
    """Exchange bytes per second (send bytes over time): the one-process
    engine's ``all_to_all`` of ``shards`` shards' ``[D, D, C]`` f64 send
    buffers (a transpose copy), or one ``ShardGroup.exchange`` of this
    rank's ``[W, C]`` block on a rank group."""
    from ..parallel.distributed import all_to_all

    if group is not None:
        W = group.world_size
        cap = max(nbytes // (8 * W), 1)
        send = torch.ones((1, W, cap), dtype=torch.float64, device=device)
        ms = _median_ms(device, lambda: all_to_all(send, group))
        return send.numel() * 8 / (ms * 1e-3)
    D = shards
    cap = max(nbytes // (8 * D * D), 1)
    send = torch.ones((D, D, cap), dtype=torch.float64, device=device)
    ms = _median_ms(device, lambda: all_to_all(send))
    return send.numel() * 8 / (ms * 1e-3)


def power_limit() -> Optional[str]:
    """``name, power.limit`` as ``nvidia-smi`` prints them (None when it
    is absent)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    line = out.stdout.strip().splitlines()
    return line[0].strip() if out.returncode == 0 and line else None


def calibrate(device=None, quick: bool = False, group=None) -> dict:
    """Measure the four rates on ``device`` (default ``cuda``, raising
    without a card) and return them as a calibration dict."""
    device = resolve_device(device)
    div = 16 if quick else 1
    backend, kind = _roofline.device_identity(device)
    cal = {"gather_rows_per_s": measure_gather(device, GATHER_ROWS // div),
           "h2d_bytes_per_s": measure_h2d(device, H2D_BYTES // div),
           "flops_per_s": measure_flops(device, SCAN_ELEMS // div),
           "exchange_bytes_per_s": measure_exchange(
               device, EXCHANGE_BYTES // div, group=group),
           "backend": backend, "device_kind": kind, "source": "measured",
           "gather_table_rows": GATHER_ROWS // div,
           "quick": bool(quick)}
    if device.type == "cuda":
        cal["card"] = power_limit()
    return cal


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_matvec_tpu_torch.obs.calibrate",
        description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="buffers 16x smaller (a smoke check)")
    ap.add_argument("--calibration-out", default=None, metavar="PATH",
                    help="also write the calibration JSON here")
    ap.add_argument("--no-save", action="store_true",
                    help="do not write the content-addressed sidecar")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cal = calibrate(args.device, quick=args.quick)
    if args.calibration_out:
        _roofline.save_calibration(cal, args.calibration_out)
    if not args.no_save:
        cal["sidecar"] = _roofline.save_calibration(cal)
    print(json.dumps(cal, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
