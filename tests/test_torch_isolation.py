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


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ml_dtypes", "distributed_matvec_tpu")


def test_import_pulls_in_no_jax():
    mods = _modules()
    assert "distributed_matvec_tpu_torch.parallel.distributed" in mods
    assert "distributed_matvec_tpu_torch.parallel.mesh" in mods
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


def test_entry_points_refuse_cpu_without_request(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    op = heisenberg_chain(8, symmetric=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.DistributedEngine(op, batch_size=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.lanczos(lambda v: v, n=4)
    # asked for explicitly, the CPU runs
    eng = port.DistributedEngine(op, batch_size=64, device="cpu")
    assert eng.device.type == "cpu"


def test_out_of_scope_raises_not_implemented():
    """What the port does not have raises NotImplementedError: the two
    "auto" policies (the hybrid split, also the JAX default, and the
    pipeline depth), priced by the JAX package's obs/.  What earlier slices
    refused builds now: every codec tier, complex sectors in the streamed
    engine, and hybrid mode with a static split."""
    op = heisenberg_chain(8, symmetric=True)
    for kw in ({"mode": "hybrid"}, {"mode": "hybrid", "hybrid_split": "auto"},
               {"pipeline_depth": "auto"}):
        with pytest.raises(NotImplementedError, match="auto"):
            port.DistributedEngine(op, batch_size=64, device="cpu", **kw)
    for kw in ({"stream_compress": "off"},
               {"n_devices": 2, "stream_compress": "bf16"},
               {"mode": "hybrid", "hybrid_split": "all-recompute"}):
        port.DistributedEngine(op, batch_size=64, device="cpu", **kw)
    # a k = 1 momentum sector has complex characters
    basis = port.SpinBasis(8, 4, None, [([*range(1, 8), 0], 1)])
    complex_op = heisenberg_from_edges(basis, chain_edges(8))
    for D in (1, 2):
        eng = port.DistributedEngine(complex_op, n_devices=D, batch_size=64,
                                     device="cpu")
        assert not eng.real and eng.stream_kernel == "torch"
