"""No file the benchmark runs may import JAX or the JAX package, and the
reference may import nothing of the program either.  Modules are compared
by their whole top-level name (the part before the first dot): the
program's name begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import os
from typing import Dict, Iterable, List

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "distributed_matvec_tpu"})
#: what ``reference/`` may not import besides
PROGRAM = "distributed_matvec_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def imported(path: str) -> List[str]:
    """Every module a Python file imports, statically."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.append(str(node.args[0].value))
    return out


def configured(path: str) -> List[str]:
    """The modules a configuration file names (``program.*.module``)."""
    with open(path) as fh:
        cfg = json.load(fh)
    return [spec["module"] for spec in cfg.get("program", {}).values()
            if isinstance(spec, dict) and "module" in spec]


def violations(bench_dir: str = HERE) -> Dict[str, List[str]]:
    """``{file: [forbidden modules]}`` over every file the benchmark runs."""
    bad: Dict[str, List[str]] = {}
    for dirpath, _, files in os.walk(bench_dir):
        for f in sorted(files):
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, bench_dir)
            if f.endswith(".py"):
                mods = imported(path)
            elif f.endswith(".json") and rel.startswith("configs"):
                mods = configured(path)
            else:
                continue
            deny = set(FORBIDDEN)
            if rel.startswith("reference" + os.sep):
                deny.add(PROGRAM)
            hits = sorted({m for m in mods if top(m) in deny})
            if hits:
                bad[rel] = hits
    return bad


def loaded_forbidden(modules: Iterable[str]) -> List[str]:
    """The forbidden top-level modules among ``modules`` (``sys.modules``)."""
    return sorted({top(m) for m in modules if top(m) in FORBIDDEN})
