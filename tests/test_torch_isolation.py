"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never run on the CPU unless asked to."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import distributed_matvec_tpu_torch as port
from distributed_matvec_tpu_torch.models.lattices import (
    chain_edges, heisenberg_chain, heisenberg_from_edges)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "distributed_matvec_tpu_torch")


def _modules():
    return [m.name for m in pkgutil.walk_packages(
        port.__path__, "distributed_matvec_tpu_torch.")]


#: the fault-tolerance and obs modules (their JAX source by module)
SLICE_11 = {"utils.timers": "utils/timers.py",
            "utils.profiling": "utils/profiling.py",
            "utils.faults": "utils/faults.py",
            "parallel.heartbeat": "parallel/heartbeat.py",
            "parallel.engine_obs": "parallel/engine.py",
            "obs.health": "obs/health.py",
            "obs.memory": "obs/memory.py",
            "obs.profile": "obs/profile.py",
            "obs.kernel_costs": "obs/hlo.py"}


@pytest.mark.parametrize("sub", sorted(SLICE_11))
def test_copied_module_names_its_source(sub):
    """Each module copied from the JAX package names its source on its
    first line."""
    path = os.path.join(PKG, *sub.split(".")) + ".py"
    with open(path, encoding="utf-8") as f:
        first = f.readline()
    assert first.startswith("# Ported from distributed_matvec_tpu/"
                            + SLICE_11[sub]), first


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ml_dtypes", "distributed_matvec_tpu")


def test_import_pulls_in_no_jax():
    mods = _modules()
    assert "distributed_matvec_tpu_torch.parallel.distributed" in mods
    assert "distributed_matvec_tpu_torch.parallel.mesh" in mods
    for sub in ("serve.capacity", "serve.scheduler", "serve.service",
                "obs.export", "obs.flight", "utils.config",
                "utils.preempt", "utils.logging", "apps.solve_service",
                *SLICE_11):
        assert f"distributed_matvec_tpu_torch.{sub}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'distributed_matvec_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


#: calls that load a module from a file path
_PATH_LOADERS = ("spec_from_file_location", "SourceFileLoader", "run_path",
                 "load_source", "exec_module")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_loads_nothing_by_path(path):
    """The port loads no module from a file path (the JAX scheduler loads
    ``tools/capacity.py`` so), and no path of the port names ``tools/``
    as a place to import from."""
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            getattr(f, "id", "")
        assert name not in _PATH_LOADERS, \
            f"{path}:{node.lineno} loads a module by path ({name})"
        if name in ("join", "insert", "append"):
            consts = [a.value for a in node.args
                      if isinstance(a, ast.Constant)
                      and isinstance(a.value, str)]
            assert not any(c.strip("/").split("/")[0] == "tools"
                           for c in consts), \
                f"{path}:{node.lineno} reaches into tools/"


def test_entry_points_refuse_cpu_without_request(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    op = heisenberg_chain(8, symmetric=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.DistributedEngine(op, batch_size=64,
                               mode="streamed", stream_compress="lossless")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.lanczos(lambda v: v, n=4)
    from distributed_matvec_tpu_torch.obs import calibrate
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate.calibrate()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate.main(["--no-save"])
    assert calibrate.calibrate("cpu", quick=True)["backend"] == "cpu"
    # asked for explicitly, the CPU runs
    eng = port.DistributedEngine(op, batch_size=64, device="cpu",
                                 mode="streamed", stream_compress="lossless")
    assert eng.device.type == "cpu"


def test_service_refuses_cpu_without_request(monkeypatch, tmp_path):
    """The solve service's classes run on the card: without one they raise
    unless the caller passes ``device="cpu"``; nothing falls back."""
    from distributed_matvec_tpu_torch.apps import solve_service as app
    from distributed_matvec_tpu_torch.serve import (EnginePool, JobSpec,
                                                    Scheduler, SolveService,
                                                    build_engine)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spool = str(tmp_path / "spool")
    for make in (lambda: EnginePool(), lambda: Scheduler(),
                 lambda: SolveService(spool),
                 lambda: EnginePool(device="cuda"),
                 lambda: build_engine(JobSpec(
                     job_id="x", basis={"number_spins": 8}))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main([spool, "--drain"])
    assert EnginePool(device="cpu").device.type == "cpu"
    assert Scheduler(device="cpu").device.type == "cpu"
    svc = SolveService(spool, device="cpu")
    assert svc.scheduler.device.type == "cpu"
    assert app.main([spool, "--drain", "--device", "cpu"]) == 0


def test_out_of_scope_raises_not_implemented(monkeypatch):
    """What the port does not have raises NotImplementedError: a solver
    checkpoint (the HDF5 slice) and a tuned config that asks for the disk
    plan tier (the persistence slice) — never a quiet build of something
    else.  What earlier slices refused builds now: the two "auto" policies
    (the hybrid split, also the JAX default, and the pipeline depth),
    resolved by the cost model as ``obs/roofline.py`` prices them under the
    CPU calibration; every codec tier, complex sectors in the streamed
    engine, and hybrid mode with a static split."""
    from distributed_matvec_tpu_torch import tune
    from distributed_matvec_tpu_torch.obs import roofline
    from distributed_matvec_tpu_torch.utils.config import update_config

    op = heisenberg_chain(8, symmetric=True)
    cal = roofline.resolve_calibration(device="cpu")
    for kw in ({"mode": "hybrid"}, {"mode": "hybrid", "hybrid_split": "auto"},
               {"mode": "streamed", "pipeline_depth": "auto"}):
        eng = port.DistributedEngine(op, batch_size=8, device="cpu", **kw)
        assert eng.pipeline_depth == 0 or eng.pipeline_depth == min(
            roofline.choose_pipeline_depth(eng._phase_counts(1), cal,
                                           eng.nchunks, 1), eng.nchunks)
        if kw["mode"] == "hybrid":
            assert eng._hybrid_mask is not None
            assert eng.hybrid_split.startswith("stream:")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        port.lanczos(lambda v: v, n=4, device="cpu", checkpoint_path="x")
    disk = tune.TunedConfig(batch_size=64, plan_tier="disk")
    monkeypatch.setattr(tune, "load_tuned", lambda fp: disk)
    update_config(tune="static")
    try:
        with pytest.raises(NotImplementedError, match="disk"):
            port.DistributedEngine(op, mode="streamed", device="cpu")
    finally:
        update_config(tune="off")
    for kw in ({"mode": "streamed", "stream_compress": "off"},
               {"mode": "streamed", "n_devices": 2, "stream_compress": "bf16"},
               {"mode": "hybrid", "hybrid_split": "all-recompute"}):
        port.DistributedEngine(op, batch_size=64, device="cpu", **kw)
    # a k = 1 momentum sector has complex characters
    basis = port.SpinBasis(8, 4, None, [([*range(1, 8), 0], 1)])
    complex_op = heisenberg_from_edges(basis, chain_edges(8))
    for D in (1, 2):
        eng = port.DistributedEngine(complex_op, n_devices=D, batch_size=64,
                                     device="cpu", mode="streamed",
                                     stream_compress="lossless")
        assert not eng.real and eng.stream_kernel == "torch"
