"""One run of one cell: set-up, the measured window, the metrics, the check.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` lands here.  The cell's entry in ``BENCHMARK.json`` names
its configuration and its traffic; both are found by name, as
``configs/<config>.json`` and ``traffic/<traffic>.json`` beside this file,
and each per-layer metric as ``metrics/<name>.py`` (the name up to its
first dot).

A configuration file holds:

* ``env``: variables set before the program is imported;
* ``program``: the operator (``module``, ``call``, ``kwargs``) and the
  engine (the same, called with the operator and ``device``);
* ``model``: the same operator as plain data, for the reference;
* ``facts``: the sector's size and stored off-diagonal elements;
* ``limits``: the limit of each number the check compares.

The run prints its result as the last line of standard output, and each
number compared beside its limit as the last lines of standard error.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Callable, Optional

import checks
import loops
import tracing

HERE = os.path.dirname(os.path.abspath(__file__))
#: the package under test
PORT = "distributed_matvec_tpu_torch"
#: where the benchmark's and the program's caches live: fixed, inside the
#: checkout, and listed in the repository's ``.gitignore``
CACHE_VARS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda"}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a ``"ranks"`` cell, as the launcher starts it
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    # ``cpu``: the CPU tests' gloo ranks, never a measurement
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(workload: str, bench_dir: str = HERE,
              bench_json: Optional[str] = None) -> SimpleNamespace:
    """The cell named ``workload``: its entry, configuration and traffic,
    and the metrics of ``BENCHMARK.json`` that it reports."""
    bench_json = bench_json or os.path.join(os.path.dirname(bench_dir),
                                            "BENCHMARK.json")
    bench = load_json(bench_json)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_json}")
    w = cells[workload]

    def mine(metrics):
        return [m for m in metrics
                if "workloads" not in m or workload in m["workloads"]]

    end_to_end = mine(bench["end_to_end"])
    reported = {m["name"] for m in end_to_end}
    # a per-layer metric without ``workloads`` is reported in every cell
    # that reports the end-to-end metric it moves
    per_layer = [m for m in mine(bench["per_layer"])
                 if "workloads" in m or m["moves"] in reported]
    return SimpleNamespace(
        name=workload, entry=w, chips=int(w["chips"]), bench_dir=bench_dir,
        config=load_json(os.path.join(bench_dir, "configs",
                                      w["config"] + ".json")),
        traffic=load_json(os.path.join(bench_dir, "traffic",
                                       w["traffic"] + ".json")),
        end_to_end=end_to_end, per_layer=per_layer)


def prepare_env(cell, root: str) -> None:
    """The configuration's variables and the fixed cache directories, set
    before torch or the program is imported."""
    for k, v in cell.config.get("env", {}).items():
        os.environ[k] = str(v)
    for var, sub in CACHE_VARS.items():
        path = os.path.join(root, "build", "bench_cache", sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def base(name: str) -> str:
    """A metric's quantity: its name up to the first dot.  ``col_ms`` and
    ``col_ms.streamed`` are one quantity held to two bounds, each over the
    cells its ``workloads`` lists."""
    return name.split(".", 1)[0]


def call(spec: dict, *args, **kwargs):
    mod = importlib.import_module(spec["module"])
    return getattr(mod, spec["call"])(*args, **{**spec.get("kwargs", {}),
                                                **kwargs})


def load_reader(bench_dir: str, name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_sync(device) -> Callable[[], None]:
    import torch

    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def program_events(kind=None) -> list:
    """The program's in-memory telemetry events (none where its obs layer
    is off or gone)."""
    try:
        return importlib.import_module(PORT + ".obs.events").events(kind)
    except (ImportError, AttributeError):
        return []


def apply_spans(seq0: int, skip=None) -> list:
    """``dur_ms`` of the program's ``apply`` spans emitted after event
    ``seq0``, leaving out those that start inside ``skip`` (a pair of
    wall-clock times: the profiled segment)."""
    return [e["dur_ms"] for e in program_events("span")
            if e.get("name") == "apply" and e["seq"] > seq0
            and not (skip and skip[0] <= e["t0"] <= skip[1])]


class MetricMissing(RuntimeError):
    """A per-layer metric that the cell lists found nothing to read in a
    run on the card: its reader no longer finds what it reads."""


def read_per_layer(cell, ctx, strict: bool) -> dict:
    """The cell's per-layer metrics.  A reader that finds nothing leaves
    its metric out; with ``strict`` (a run on the card) that is an error
    instead, so that a renamed kernel, span or attribute cannot silence a
    metric while the code it measures still runs."""
    metrics, missing = {}, []
    for m in cell.per_layer:
        v = load_reader(cell.bench_dir, base(m["name"]))(ctx)
        if v is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if strict and missing:
        raise MetricMissing(
            f"{cell.name}: found nothing to read for {', '.join(missing)}")
    return metrics


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, engine_hook=None, control: bool = False,
             group=None) -> Optional[dict]:
    """One run of ``cell``.  ``engine_hook(eng)`` runs on the built engine
    (the tests break it there); ``control`` puts the reference, in the
    precision below the configuration's, in the program's place.

    With ``group`` (this rank's ``ShardGroup``) every rank runs this SPMD
    and the engine is the group's: rank 0 decides each request and traces,
    the peak is the largest over the ranks, the kept outputs are gathered
    in basis order, and rank 0 alone judges them and returns the result
    (the other ranks return None)."""
    import numpy as np
    import torch

    rk = None
    if group is not None:
        from ranks import Ranks

        rk = Ranks(group)
        trace = trace and rk.rank == 0
    sync = make_sync(device)
    cfg = cell.config
    timings = {"start_s": time.time() - t_start}
    t = time.perf_counter()
    op = call(cfg["program"]["operator"])
    timings["operator_s"] = time.perf_counter() - t
    t = time.perf_counter()
    op.basis.build()
    timings["enumerate_s"] = time.perf_counter() - t
    reps = np.asarray(op.basis.representatives)
    norms = np.asarray(op.basis.norms)
    t = time.perf_counter()
    if control:
        eng = checks.ControlEngine(cfg, reps, norms, device)
    elif rk is not None:
        eng = call(cfg["program"]["engine"], op, device=device, group=group)
    else:
        eng = call(cfg["program"]["engine"], op, device=device)
    sync()
    timings["build_s"] = time.perf_counter() - t
    if engine_hook is not None:
        engine_hook(eng)
    space = loops.VectorSpace(eng, len(reps), device)
    loop = loops.make(cell.traffic, eng, space, seed, sync, trace, PORT,
                      ranks=rk)
    t = time.perf_counter()
    loop.warm_up()
    if trace:
        tracing.warm_up(sync)
    sync()
    if rk is not None:
        rk.barrier()
    timings["warmup_s"] = time.perf_counter() - t
    setup_s = time.time() - t_start
    rank = {} if rk is None else {"rank": rk.rank}
    # one write, so that the ranks' lines do not interleave
    sys.stderr.write("setup " + json.dumps({"setup_s": setup_s, **timings,
                                            **rank}) + "\n")
    evs = program_events()
    seq0 = evs[-1]["seq"] if evs else -1
    del evs
    loop.run(seconds)
    peak = int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0
    outputs = loop.host_outputs()
    if rk is not None:
        peak = int(rk.max(peak))
        straggler = rk.gather(_median(apply_spans(seq0)))
        if rk.rank != 0:
            return None
        print("straggler " + json.dumps({"apply_ms_median": straggler}),
              file=sys.stderr)

    metrics, ctx = {}, None
    if trace:
        t = time.perf_counter()
        prof = loop.segment.summary() if loop.segment else None
        print("trace " + json.dumps({
            "stop_s": getattr(loop.segment, "stop_s", None),
            "reduce_s": time.perf_counter() - t,
            "segment_s": getattr(loop.segment, "wall_s", None),
            "untraced_s": loop.untraced_s(),
            "busy_s": prof["busy_s"] if prof else None}), file=sys.stderr)
        ctx = SimpleNamespace(
            timings=timings, loop=loop, engine=eng, profile=prof,
            facts=cfg["facts"], apply_ms=apply_spans(
                seq0, loop.segment.wall if loop.segment else None),
            columns=getattr(loop, "R", 1))
        metrics = read_per_layer(cell, ctx, strict=device.type == "cuda")
    else:
        e2e = end_to_end(loop, setup_s, peak)
        for m in cell.end_to_end:
            if base(m["name"]) in e2e:
                metrics[m["name"]] = {"value": float(e2e[base(m["name"])]),
                                      "unit": m["unit"]}
    solves = getattr(loop, "solves", None)
    attempted, failed = loop.attempted, loop.failed
    breakdown = None
    if ctx is not None and ctx.profile is not None:
        breakdown = {"device_ops": ctx.profile["device_ops"],
                     "idle_gaps": ctx.profile["idle_gaps"]}
        busy = (ctx.profile["busy_s"], ctx.profile["window_s"])
    del eng, space, loop, op, ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers, wrong = checks.judge(cfg, cell.traffic["kind"], reps, norms,
                                  outputs, solves, seed, device)
    result = {"correct": failed == 0 and wrong == 0 and all(
                  v["value"] <= v["limit"] for v in numbers.values()),
              "attempted": attempted, "failed": failed + wrong,
              "metrics": metrics,
              "device": device_info(device, cell.chips, peak)}
    if breakdown is not None:
        result["device"]["busy_s"], result["device"]["window_s"] = busy
        result["breakdown"] = breakdown
    result["checks"] = numbers
    return result


def _median(values) -> float:
    import numpy as np

    return float(np.median(values)) if values else 0.0


def end_to_end(loop, setup_s: float, peak: int) -> dict:
    import numpy as np

    out = {"setup_s": setup_s, "peak_mem_gb": peak / 1e9}
    if loop.columns:
        out["col_ms"] = loop.elapsed_s * 1e3 / loop.columns
    if getattr(loop, "solves", None):
        out["solve_s"] = loop.elapsed_s / len(loop.solves)
    if getattr(loop, "call_ms", None):
        out["call_p95_ms"] = float(np.percentile(loop.call_ms, 95))
    return out


def device_info(device, chips: int, peak: int) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": peak}
