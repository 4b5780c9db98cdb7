#!/usr/bin/env python3
"""The telemetry layer's host cost per apply of the port's ``LocalEngine``.

    python3 tools/torch_obs_cost.py [--n 32] [--device cuda] [--applies 101]

Builds ``heisenberg_chain(n, symmetric=True)`` (native enumeration) and an
ell ``LocalEngine`` with ``DMT_PHASES=off``, then prints one JSON line:

* ``wall_ms`` / ``dispatch_ms``: medians of synchronized apply walls and of
  the host time to return from ``matvec`` (no synchronization inside),
  with the layer on (the default) and with ``DMT_OBS=off``, in two
  alternating blocks each;
* ``pieces_us``: the mean host µs of one call of each piece the observed
  apply runs (the ``apply`` span, the profile window, the health drain
  and cadence, one health probe, the watermark cadence and one watermark —
  on the card also its ``torch.cuda.memory_stats`` and ``mem_get_info``
  apart —, the ``matvec_apply`` event, the histogram), and of one detail
  span site (``obs/trace.py``) with no profiler window open and inside
  one (``detail_span_off``, ``detail_span_on``);
* ``profile``: the 15 functions with the most own time over
  ``--applies`` observed applies under ``cProfile``, as
  ``[function, calls, ms]``.

Runs on the CPU with ``--device cpu`` (small ``--n``); a device number is
only one taken on the card.
"""

import argparse
import cProfile
import json
import os
import pstats
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--applies", type=int, default=101)
    args = ap.parse_args(argv)
    os.environ["DMT_PHASES"] = "off"
    os.environ.setdefault("DMT_ENUMERATION_BACKEND", "native")
    os.environ.pop("DMT_OBS", None)
    import torch

    from distributed_matvec_tpu_torch import LocalEngine
    from distributed_matvec_tpu_torch.models.lattices import heisenberg_chain
    from distributed_matvec_tpu_torch.obs import health, memory, profile
    from distributed_matvec_tpu_torch.obs import trace
    from distributed_matvec_tpu_torch.obs.events import emit
    from distributed_matvec_tpu_torch.obs.metrics import histogram

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu)")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    op = heisenberg_chain(args.n, symmetric=True)
    op.basis.build()
    eng = LocalEngine(op, device=dev)
    x = torch.randn(op.basis.number_states, dtype=torch.float64,
                    device=dev)
    eng.matvec(x)
    sync()

    def series(n):
        wall, disp = [], []
        for _ in range(n):
            sync()
            t0 = time.perf_counter()
            eng.matvec(x)
            t1 = time.perf_counter()
            sync()
            t2 = time.perf_counter()
            disp.append((t1 - t0) * 1e3)
            wall.append((t2 - t0) * 1e3)
        return wall, disp

    runs = {"on": ([], []), "off": ([], [])}
    for _ in range(2):
        for key in ("on", "off"):
            if key == "off":
                os.environ["DMT_OBS"] = "off"
            w, d = series(args.applies)
            os.environ.pop("DMT_OBS", None)
            runs[key][0].extend(w)
            runs[key][1].extend(d)

    y = eng.matvec(x)
    sync()

    def per_call(fn, n=2000):
        for _ in range(20):
            fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        sync()
        return us

    def span():
        with trace.span("apply", kind="apply", engine="local", mode="ell",
                        apply=7):
            pass

    def window():
        with profile.sample_window("local", 7, mode="ell"):
            pass

    def detail():
        t = trace.detail_start()
        trace.detail_end("fetch", t, 7)

    def probe():
        health.probe_apply("local", y, 7)
        sync()
        health.drain()

    pieces = {
        "apply_span": per_call(span),
        "profile_window": per_call(window),
        "detail_span_off": per_call(detail),
        "health_drain": per_call(health.drain),
        "health_probe_due": per_call(lambda: health.probe_due(7)),
        "health_probe_and_drain": per_call(probe, 200),
        "watermark_due": per_call(lambda: memory.watermark_due(7)),
        "watermark_sample": per_call(
            lambda: memory.sample_watermark("apply/local", apply=7), 200),
        "matvec_apply_event": per_call(lambda: emit(
            "matvec_apply", engine="local", apply=7, wall_ms=1.0,
            bytes=0)),
        "histogram": per_call(lambda: histogram(
            "matvec_apply_ms", engine="local").observe(1.0)),
    }
    # a site records under an open span while a window records
    with trace.span("apply", kind="apply"), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA if cuda
                        else torch.profiler.ProfilerActivity.CPU]):
        pieces["detail_span_on"] = per_call(detail)
    if cuda:
        # the watermark's two device reads, apart
        pieces["cuda_memory_stats"] = per_call(
            lambda: torch.cuda.memory_stats(dev), 200)
        pieces["cuda_mem_get_info"] = per_call(
            lambda: torch.cuda.mem_get_info(dev), 200)

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(args.applies):
        eng.matvec(x)
        sync()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(((f"{os.path.basename(k[0])}:{k[1]}({k[2]})", v[1],
                    v[2] * 1e3) for k, v in st.stats.items()),
                  key=lambda r: -r[2])[:15]

    med = statistics.median
    print(json.dumps({
        "n": args.n, "n_states": int(op.basis.number_states),
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "applies": args.applies,
        "wall_ms": {k: med(v[0]) for k, v in runs.items()},
        "dispatch_ms": {k: med(v[1]) for k, v in runs.items()},
        "pieces_us": pieces,
        "profile": [[f, c, ms] for f, c, ms in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
