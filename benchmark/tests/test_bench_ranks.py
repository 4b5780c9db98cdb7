"""Cells of one process per card (``"ranks": true``) on the CPU: the
launcher runs two gloo ranks of a chain_16_symm cell through ``run.py``
under ``torchrun``, ends every rank when one fails, and exits 2 without
the cards."""

import json
import os
import subprocess
import sys
import time

import pytest

from conftest import add_cell, copy_bench, small_config

#: seconds a launcher run may take here before the test gives up on it
WAIT_S = 240
RANK_ENGINE = {"module": "distributed_matvec_tpu_torch",
               "call": "DistributedEngine",
               "kwargs": {"mode": "streamed", "stream_compress": "lossless"}}
#: an engine whose rank 1 fails in set-up, as ``how`` says
FAULTY = '''import os, signal, time
from distributed_matvec_tpu_torch import DistributedEngine


def engine(op, how="", **kw):
    if os.environ.get("RANK") == "1":
        if how == "raise":
            raise RuntimeError("planted in set-up")
        if how == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(3600)
    return DistributedEngine(op, **kw)
'''
#: an engine broken underneath the timed path on every rank
BROKEN = '''import types
from distributed_matvec_tpu_torch import DistributedEngine
import test_bench_control as faults


def engine(op, fault="", **kw):
    eng = DistributedEngine(op, **kw)
    if fault == "exchange":
        # each rank receives its own send block: the exchange left out
        eng._exchange = lambda send: send
        eng._exchange_start = lambda send: (lambda: send)
    else:
        getattr(faults, fault)(eng)
    return eng
'''


def rank_cell(tmp_path, traffic="e0", engine=None, chips=2):
    """A copy of the benchmark with a ``"ranks"`` chain_16_symm cell of
    ``chips`` ranks; returns (checkout, cell name)."""
    bench = copy_bench(tmp_path)
    cfg = small_config("streamed")
    cfg["ranks"] = True
    cfg["program"]["engine"] = engine or RANK_ENGINE
    name = add_cell(bench, "chain16_ranks", cfg, traffic,
                    like=f"chain32_streamed.{traffic}")
    path = os.path.join(str(tmp_path), "BENCHMARK.json")
    with open(path) as fh:
        b = json.load(fh)
    for w in b["workloads"]:
        if w["name"] == name:
            w["chips"] = chips
    with open(path, "w") as fh:
        json.dump(b, fh)
    for module, text in (("faulty_engine", FAULTY),
                         ("broken_engine", BROKEN)):
        with open(os.path.join(bench, module + ".py"), "w") as fh:
            fh.write(text)
    return str(tmp_path), name


def launch(root, name, *extra, seconds=0.5, trace=0,
           command=("benchmark/run.py",), **env_extra):
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1", **env_extra,
               PYTHONPATH=os.pathsep.join([os.path.dirname(os.path.dirname(
                   tests)), tests]))
    t = time.time()
    p = subprocess.run(
        [sys.executable, *command, "--workload", name, "--seed",
         str(2 ** 31 + 17), "--seconds", str(seconds), "--trace", str(trace),
         *extra], cwd=root, env=env, capture_output=True, text=True,
        timeout=WAIT_S)
    return p, time.time() - t


def left_behind(root):
    """Processes that run ``run.py`` in the checkout ``root``."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmd = fh.read().decode(errors="replace")
            if "run.py" in cmd and os.readlink(f"/proc/{pid}/cwd") == root:
                out.append(pid)
        except OSError:
            pass
    return out


def test_two_gloo_ranks_agree_with_one_process(small_bench, tmp_path):
    root, name = rank_cell(tmp_path / "ranks", "e0")
    p, _ = launch(root, name, "--device", "cpu")
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(r)[-1] == "checks" and r["correct"], r["checks"]
    assert r["device"]["count"] == 2 and r["failed"] == 0
    for k in ("basis_count", "basis_bad", "nnz"):
        assert r["checks"][k]["value"] == 0
    assert {"setup_s", "peak_mem_gb", "col_ms.streamed"} <= set(r["metrics"])
    # rank 0's report is the last lines of standard error
    tail = p.stderr.strip().splitlines()[-len(r["checks"]):]
    assert [ln.split()[1] for ln in tail] == list(r["checks"])
    assert "straggler" in p.stderr
    one = small_bench("streamed", "e0")
    assert one["correct"]
    # both solves' E0 lie within e0_gap of one reference E0
    e0 = 4 * 7.1422963606
    gap = r["checks"]["e0_gap"]["value"] + one["checks"]["e0_gap"]["value"]
    assert e0 * gap <= 1e-10
    assert r["metrics"]["solve_s.streamed"]["value"] > 0


def test_apply_traffic_is_refused_on_ranks():
    import loops

    with pytest.raises(ValueError, match="ranks"):
        loops.make({"kind": "apply", "columns": 4, "profile": {"requests": 1}},
                   None, None, 1, lambda: None, False, "", ranks=object())


def test_traced_rank_run_reads_rank_zero(tmp_path):
    root, name = rank_cell(tmp_path, "e0")
    p, _ = launch(root, name, "--device", "cpu", trace=1)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert {"enumerate_s", "build_s", "encode_s", "lanczos_iters.streamed",
            "apply_host_ms.streamed"} <= set(m)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "exchange"])
def test_a_broken_rank_path_is_not_correct(tmp_path, fault):
    """The run of a rank cell, with the timed path broken underneath on
    every rank, comes out not correct."""
    engine = {"module": "broken_engine", "call": "engine",
              "kwargs": dict(RANK_ENGINE["kwargs"], fault=fault)}
    root, name = rank_cell(tmp_path, "e0", engine=engine)
    p, _ = launch(root, name, "--device", "cpu")
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert not r["correct"], r["checks"]
    assert any(v["value"] > v["limit"] for v in r["checks"].values())


#: the launcher with a short limit, as ``run.py`` calls it
LAUNCH = """import sys, time
sys.path.insert(0, "benchmark")
import ranks
sys.exit(ranks.launch("benchmark/run.py", sys.argv[1:], 2, time.time(),
                      limit_s=%d))
"""


@pytest.mark.parametrize("how", ["raise", "kill", "hang"])
def test_a_failed_rank_ends_every_rank(tmp_path, how):
    engine = {"module": "faulty_engine", "call": "engine",
              "kwargs": dict(RANK_ENGINE["kwargs"], how=how)}
    root, name = rank_cell(tmp_path, "e0", engine=engine)
    limit = 30
    p, took = launch(root, name, "--device", "cpu",
                     command=["-c", LAUNCH % limit])
    assert p.returncode != 0
    assert p.stdout == ""
    assert took < limit + 30
    assert ("the run's limit" in p.stderr) == (how == "hang")
    time.sleep(0.5)
    assert left_behind(root) == []


def test_fewer_cards_than_ranks_exits_2(tmp_path):
    root, name = rank_cell(tmp_path, "e0", chips=4)
    p, _ = launch(root, name, CUDA_VISIBLE_DEVICES="")
    assert p.returncode == 2
    assert p.stdout == ""
    assert "CUDA device" in p.stderr


def test_single_process_cells_take_no_rank_path():
    from conftest import BENCH

    import harness

    for w in ("chain32_ell.e0", "chain32_streamed.e0",
              "chain32_ell.matvec4", "chain32_streamed.matvec4"):
        assert not harness.load_cell(w, bench_dir=BENCH).config.get("ranks")
