# Ported from distributed_matvec_tpu/utils/logging.py.
"""Debug logging — ``logDebug`` parity (``FFI.chpl:78-80``: stderr lines
prefixed ``[Debug] [<locale>]``; here the "locale" is the process rank of
the initialized ``torch.distributed`` group, 0 without one)."""

from __future__ import annotations

import sys
import time

from .config import get_config

__all__ = ["log_debug", "log_info", "log_warn"]

_START = time.time()


def _dist():
    """``torch.distributed`` when a process group is initialized, else
    None.  Not cached: a group may be initialized (or destroyed) after the
    first log line, and the query is two attribute reads."""
    try:
        import torch.distributed as dist
    except ImportError:                  # pragma: no cover - torch is a dep
        return None
    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def _process_index() -> int:
    d = _dist()
    return int(d.get_rank()) if d is not None else 0


def _process_count() -> int:
    """Total process (rank) count of the initialized group, else 1."""
    d = _dist()
    return int(d.get_world_size()) if d is not None else 1


def log_debug(*parts) -> None:
    if not get_config().log_debug:
        return
    msg = "".join(str(p) for p in parts)
    print(
        f"[Debug] [{_process_index()}] [{time.time() - _START:9.3f}] {msg}",
        file=sys.stderr,
        flush=True,
    )


def log_info(*parts) -> None:
    msg = "".join(str(p) for p in parts)
    print(f"[Info] [{_process_index()}] {msg}", file=sys.stderr, flush=True)


def log_warn(*parts) -> None:
    """Always-on warning level for soft-fail paths (event-sink writes):
    degraded-but-continuing conditions the user should see once without
    turning on debug logging."""
    msg = "".join(str(p) for p in parts)
    print(f"[Warn] [{_process_index()}] {msg}", file=sys.stderr, flush=True)
