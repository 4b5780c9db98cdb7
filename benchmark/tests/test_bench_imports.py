"""No file the benchmark runs imports JAX or the JAX package; the reference
imports nothing of the program.  Top-level names are compared whole."""

import os
import shutil

import importcheck
from conftest import BENCH


def test_benchmark_imports_no_jax():
    assert importcheck.violations(BENCH) == {}


def test_whole_top_level_names():
    assert importcheck.loaded_forbidden(
        ["distributed_matvec_tpu_torch", "distributed_matvec_tpu_torch.ops",
         "jaxtyping", "numpy"]) == []
    assert importcheck.loaded_forbidden(
        ["jax.numpy", "distributed_matvec_tpu.ops", "flax"]) == [
        "distributed_matvec_tpu", "flax", "jax"]


def test_planted_imports_are_found(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__"))
    (bench / "metrics" / "bad.py").write_text(
        "import jax.numpy as jnp\n\ndef read(ctx):\n    return 1\n")
    (bench / "reference" / "bad.py").write_text(
        "from distributed_matvec_tpu_torch.ops import kernels\n")
    (bench / "loops_extra.py").write_text(
        "import importlib\nm = importlib.import_module('jaxlib')\n"
        "import distributed_matvec_tpu_torch\n")
    bad = importcheck.violations(str(bench))
    assert bad == {
        os.path.join("metrics", "bad.py"): ["jax.numpy"],
        os.path.join("reference", "bad.py"): [
            "distributed_matvec_tpu_torch.ops"],
        "loops_extra.py": ["jaxlib"],
    }
