"""The harness on the CPU at chain_16_symm: cells, traffic and metrics are
found by name as new files; the result line's keys; a run without a card."""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, copy_bench, small_config

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


def digest(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(dirpath, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_new_config_traffic_and_metric_are_found_by_name(small_bench):
    bench = small_bench.bench
    before = digest(bench)
    # a traffic mix and a per-layer metric, each a new file
    with open(os.path.join(bench, "traffic", "e0_loose.json"), "w") as fh:
        json.dump({"kind": "solve", "solver": "lanczos",
                   "kwargs": {"k": 1, "tol": 1e-8, "check_every": 8,
                              "compute_eigenvectors": True},
                   "starts": {"pool": 3, "seed": 5},
                   "profile": {"requests": 1}}, fh)
    with open(os.path.join(bench, "metrics", "solves_done.py"), "w") as fh:
        fh.write("def read(ctx):\n    return len(ctx.loop.solves)\n")
    path = os.path.join(os.path.dirname(bench), "BENCHMARK.json")
    with open(path) as fh:
        b = json.load(fh)
    b["per_layer"].append({"name": "solves_done", "unit": "solves",
                           "better": "higher", "source": "host_clock",
                           "layer": "solver", "moves": "solve_s"})
    with open(path, "w") as fh:
        json.dump(b, fh)
    # the new cell reports what chain32_ell.e0 reports, solve_s with it
    r = small_bench("ell", "e0_loose", trace=True, like="chain32_ell.e0")
    assert r["correct"], r["checks"]
    assert r["metrics"]["solves_done"]["value"] == r["attempted"] >= 1
    new = digest(bench)
    assert {k: v for k, v in new.items() if k in before} == before
    assert set(new) - set(before) == {os.path.join("metrics",
                                                   "solves_done.py")}


@pytest.mark.parametrize("engine", ["ell", "streamed"])
@pytest.mark.parametrize("traffic", ["e0", "matvec4"])
def test_result_keys_and_metrics(small_bench, engine, traffic):
    r = small_bench(engine, traffic)
    assert list(r)[:5] == REQUIRED and list(r)[-1] == "checks"
    assert set(r) <= set(REQUIRED) | {"breakdown", "checks"}
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    tail = "" if engine == "ell" else ".streamed"
    want = {"setup_s", "peak_mem_gb", "col_ms" + tail,
            ("solve_s" if traffic == "e0" else "call_p95_ms") + tail}
    assert set(r["metrics"]) == want
    for v in r["checks"].values():
        assert v["value"] <= v["limit"]
    assert json.loads(json.dumps(r)) == r


@pytest.mark.parametrize("traffic", ["e0", "matvec4"])
def test_traced_run_reports_per_layer_metrics(small_bench, traffic):
    r = small_bench("streamed", traffic, trace=True)
    assert r["correct"]
    m = r["metrics"]
    assert {"enumerate_s", "build_s", "apply_host_ms.streamed"} <= set(m)
    assert ("lanczos_iters.streamed" in m) == (traffic == "e0")
    # no device trace on the CPU: the device metrics stay out
    assert not {"k8_roofline", "apply_roofline", "idle_share"} & set(m)


def test_a_metric_that_reads_nothing_fails_a_run_on_the_card(tmp_path):
    """On the card a listed per-layer metric that reads nothing ends the
    run; elsewhere it is left out of the line."""
    from types import SimpleNamespace

    import harness

    bench = copy_bench(tmp_path)
    with open(os.path.join(bench, "metrics", "nothing.py"), "w") as fh:
        fh.write("def read(ctx):\n    return None\n")
    with open(os.path.join(bench, "metrics", "one.py"), "w") as fh:
        fh.write("def read(ctx):\n    return 1\n")
    cell = SimpleNamespace(name="c", bench_dir=bench, per_layer=[
        {"name": "one.x", "unit": "s"}, {"name": "nothing", "unit": "s"}])
    assert harness.read_per_layer(cell, None, strict=False) == {
        "one.x": {"value": 1.0, "unit": "s"}}
    with pytest.raises(harness.MetricMissing, match="nothing"):
        harness.read_per_layer(cell, None, strict=True)


def test_a_metric_without_workloads_follows_the_metric_it_moves(tmp_path):
    import harness

    bench = copy_bench(tmp_path)
    path = os.path.join(tmp_path, "BENCHMARK.json")
    with open(path) as fh:
        b = json.load(fh)
    for moves in ("solve_s", "call_p95_ms"):
        b["per_layer"].append({"name": "free_" + moves, "unit": "s",
                               "better": "lower", "source": "host_clock",
                               "layer": "solver", "moves": moves})
    with open(path, "w") as fh:
        json.dump(b, fh)
    for cell, want in (("chain32_ell.e0", "free_solve_s"),
                       ("chain32_ell.matvec4", "free_call_p95_ms")):
        names = {m["name"] for m in harness.load_cell(
            cell, bench_dir=bench).per_layer}
        assert want in names and len(names & {"free_solve_s",
                                              "free_call_p95_ms"}) == 1


@pytest.mark.parametrize("kind", ["apply", "solve"])
def test_traced_segment_and_its_untraced_twin(kind):
    """The segment holds ``profile.requests`` requests from a quarter into
    the window; the untraced requests time the same work beside it."""
    import torch

    import loops

    n = 300
    diag = torch.linspace(-1.0, 1.0, n, dtype=torch.float64)

    class Engine:
        def matvec(self, x):
            return diag[:, None] * x if x.dim() == 2 else diag * x

    traffic = {"kind": kind, "columns": 3, "profile": {"requests": 2},
               "solver": "lanczos", "starts": {"pool": 2, "seed": 1},
               "kwargs": {"k": 1, "tol": 1e-6, "max_iters": 40}}
    space = loops.VectorSpace(Engine(), n, torch.device("cpu"))
    loop = loops.make(traffic, Engine(), space, 2 ** 31 + 3, lambda: None,
                      True, "distributed_matvec_tpu_torch")
    loop.warm_up()
    loop.run(0.4)
    traced = [i for i, (_, _, t) in enumerate(loop.walls) if t]
    assert len(traced) == 2 and traced[1] == traced[0] + 1
    assert loop.walls[traced[0]][0] >= 0 and traced[0] >= 1
    seg = loop.segment
    assert not seg.open and seg.wall_s > 0
    assert seg.columns == sum(loop.walls[i][1] for i in traced)
    assert loop.untraced_s() > 0


def test_idle_share_is_taken_against_the_untraced_work():
    """The device's busy seconds in the segment over what the same work
    takes without the profiler, not over the traced segment's length."""
    from types import SimpleNamespace

    import harness

    read = harness.load_reader(BENCH, "idle_share")
    loop = SimpleNamespace(untraced_s=lambda: 1.25)
    ctx = SimpleNamespace(loop=loop, profile={"busy_s": 1.0,
                                              "window_s": 1.4})
    assert read(ctx) == pytest.approx(20.0)
    assert read(SimpleNamespace(loop=loop, profile=None)) is None
    loop.untraced_s = lambda: None
    assert read(ctx) is None


def test_run_without_a_card_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "chain32_ell.e0", "--seed",
                        str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
                       cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 2
    assert p.stdout == ""
    assert "CUDA device" in p.stderr


def test_run_without_the_program_fails(tmp_path):
    """In a directory that holds only the benchmark, no result."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "chain32_ell.e0", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0
    assert p.stdout == ""


@pytest.mark.parametrize("engine", ["ell", "streamed"])
def test_reference_agrees_with_the_program(engine):
    """The plain reference and the program's engines and ``lanczos`` on
    chain_16_symm: the same basis, apply and ground-state energy."""
    import numpy as np
    import torch

    import harness
    from distributed_matvec_tpu_torch import lanczos
    from reference.spin_hamiltonian import SpinModel

    cfg = small_config(engine)
    op = harness.call(cfg["program"]["operator"])
    op.basis.build()
    model = SpinModel(cfg["model"])
    H = model.build(op.basis.representatives, op.basis.norms)
    assert model.census() == op.basis.number_states == 257
    assert (H.bad, H.missing, H.nnz) == (0, 0, N16_NNZ)
    eng = harness.call(cfg["program"]["engine"], op, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((257, 4)))
    if engine == "streamed":
        y = torch.from_numpy(eng.from_hashed(eng.matvec(eng.to_hashed(
            x.numpy()))))
        v0 = eng.random_hashed(5)
    else:
        y = eng.matvec(x)
        v0 = torch.from_numpy(np.random.default_rng(5).standard_normal(257))
    ref = H.apply(x)
    assert float((y - ref).abs().max()) <= 1e-13 * float(ref.abs().max())
    res = lanczos(eng.matvec, v0=v0, k=1, tol=1e-10, device="cpu")
    e0, _ = H.lowest_eigenvalue(11)
    assert abs(e0 - res.eigenvalues[0]) <= 1e-12 * abs(e0)
    assert abs(e0 / 4 - (-7.1422963606)) < 1e-9


N16_NNZ = 1774


def test_every_seed_solves_the_same_starts_in_another_order():
    import torch

    import loops

    with open(os.path.join(BENCH, "traffic", "e0.json")) as fh:
        traffic = json.load(fh)

    class Engine:
        pass

    space = loops.VectorSpace(Engine(), 50, torch.device("cpu"))

    def starts(seed):
        loop = loops.SolveLoop(traffic, Engine(), space, seed, lambda: None,
                               False, "distributed_matvec_tpu_torch")
        n = traffic["starts"]["pool"]
        return [tuple(loop.start(i)[:3].tolist()) for i in range(2 * n)]

    a, b = starts(2 ** 31 + 1), starts(2 ** 31 + 2)
    assert a == starts(2 ** 31 + 1)
    assert sorted(a) == sorted(b) and a != b
    assert len(set(a)) == traffic["starts"]["pool"]
