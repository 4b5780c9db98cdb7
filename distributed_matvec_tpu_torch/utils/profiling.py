# Ported from distributed_matvec_tpu/utils/profiling.py (maybe_profile).
"""Device-level profiling hooks.

The reference carries Chapel ``CommDiagnostics``/``VisualDebug`` hooks behind
``kVerboseComm`` (``DistributedMatrixVector.chpl:19``, ``v1/basis.chpl:7``);
here the counterpart is a ``torch.profiler`` window (CPU activity, plus CUDA
activity when a card is present) whose Chrome trace lands under the
``profile_dir`` config field (``DMT_PROFILE_DIR=…``) — viewable in Perfetto
or ``chrome://tracing``.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Optional

from .config import get_config

__all__ = ["maybe_profile", "profiler_activities"]


def profiler_activities():
    """The ``torch.profiler`` activities to record: CPU always, CUDA when
    a card is present."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextmanager
def maybe_profile(profile_dir: Optional[str] = None):
    """Trace the enclosed block when a profile directory is set; otherwise
    a no-op.  Usage::

        with maybe_profile():
            y = eng.matvec(x)

    ``profile_dir`` overrides the global ``config.profile_dir`` field for
    this one block; an explicit empty string forces the no-op regardless
    of the config field; ``None`` (default) defers to the config.  The
    trace is written as ``trace-<pid>-<ns>.json`` (Chrome trace format)
    into the directory, which is stamped with ``PROFILE_META.json``
    (trace_id/job_id) and announced by a ``profile_captured`` event.
    """
    d = profile_dir if profile_dir is not None else get_config().profile_dir
    if not d:
        yield
        return
    import torch.profiler

    os.makedirs(d, exist_ok=True)
    with torch.profiler.profile(activities=profiler_activities()) as prof:
        yield
    path = os.path.join(d, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    # stamp + announce AFTER the trace closes (its file exists now);
    # soft-fail — a broken obs layer must not break the profiled block
    try:
        from ..obs.events import emit, obs_enabled
        from ..obs.profile import stamp_profile_dir

        if obs_enabled():
            stamp_profile_dir(d, capture="manual")
            emit("profile_captured", capture="manual", dir=d, trace=path)
    except Exception:
        pass
