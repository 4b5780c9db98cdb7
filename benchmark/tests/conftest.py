"""Small cells for the CPU tests: chain_16_symm beside the real cells, in a
copy of the benchmark, added as new files only."""

import json
import os
import shutil
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

#: chain_16_symm: the sector's size and distinct off-diagonal elements
N16 = {"n_states": 257, "nnz_offdiag": 1774}
ENGINES = {
    "ell": {"module": "distributed_matvec_tpu_torch", "call": "LocalEngine",
            "kwargs": {"mode": "ell"}},
    "streamed": {"module": "distributed_matvec_tpu_torch",
                 "call": "DistributedEngine",
                 "kwargs": {"n_devices": 1, "mode": "streamed",
                            "stream_compress": "lossless"}},
}


def small_config(engine: str, n: int = 16) -> dict:
    """chain32_ell.json's content at ``n`` sites on ``engine``."""
    with open(os.path.join(BENCH, "configs", "chain32_ell.json")) as fh:
        cfg = json.load(fh)
    cfg["program"]["operator"]["kwargs"]["n"] = n
    cfg["program"]["engine"] = ENGINES[engine]
    m = cfg["model"]
    m["n_sites"], m["hamming_weight"] = n, n // 2
    m["generators"] = [
        {"perm": [(i + 1) % n for i in range(n)], "sector": 0},
        {"perm": [n - 1 - i for i in range(n)], "sector": 0}]
    m["terms"][0]["edges"] = [[i, (i + 1) % n] for i in range(n)]
    cfg["facts"].update(N16, e0=-4 * 7.1422963606)
    return cfg


def copy_bench(dst) -> str:
    """A copy of the benchmark (its folder and ``BENCHMARK.json``)."""
    bench = os.path.join(str(dst), "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), str(dst))
    return bench


def add_cell(bench: str, config: str, cfg: dict, traffic: str,
             like: str = "") -> str:
    """Adds configuration ``config`` (a new file) and its cell with
    ``traffic`` (an entry in the copy's ``BENCHMARK.json``), reporting the
    metrics that cell ``like`` reports."""
    with open(os.path.join(bench, "configs", config + ".json"), "w") as fh:
        json.dump(cfg, fh)
    path = os.path.join(os.path.dirname(bench), "BENCHMARK.json")
    with open(path) as fh:
        b = json.load(fh)
    name = f"{config}.{traffic}"
    b["configs"].append({"name": config, "source": "test",
                         "file": f"benchmark/configs/{config}.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": name, "config": config,
                           "traffic": traffic, "chips": 1, "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    with open(path, "w") as fh:
        json.dump(b, fh)
    return name


@pytest.fixture
def small_bench(tmp_path):
    """``run(engine, traffic, **kw)`` runs the chain_16_symm cell of that
    engine and traffic on the CPU and returns the result."""
    import torch

    import harness

    bench = copy_bench(tmp_path)

    def run(engine="ell", traffic="e0", seconds=0.3, trace=False, seed=7,
            cfg=None, like=None, **kw):
        config = f"chain16_{engine}"
        name = add_cell(bench, config, cfg or small_config(engine), traffic,
                        like=like or f"chain32_{engine}.{traffic}")
        cell = harness.load_cell(name, bench_dir=bench)
        return harness.run_cell(cell, seed, seconds, trace,
                                torch.device("cpu"), time.time(), **kw)

    run.bench = bench
    return run
