#!/usr/bin/env python3
"""Hold the port's chain_32_symm ground-state energy against the JAX
package's, in one process on the CPU, and both against the recorded one.

    JAX_PLATFORMS=cpu python3 tools/torch_e0_parity.py [--n 32] [--tol 1e-10]

A parity check like the ``tests/test_torch_*.py`` files, at the headline
size the tests cannot reach: it imports both packages.  The JAX package
enumerates ``heisenberg_chain(n, symmetric=True)`` once; the port takes the
same representatives and term tables (``convert.operator_from_reference``).
Then, on the CPU:

1. one apply of a seeded random vector through the JAX ``LocalEngine``
   (ell) and the port's ``LocalEngine`` (ell), and their largest
   difference;
2. ``lanczos`` at ``--tol`` from the same start vector (``n`` + seed 0) in
   both packages, and again at ``--tight-tol`` to see whether either
   stopped short;
3. each E0 against ``BENCH_RECORDED_r02.json``'s ``lanczos_e0``.

One JSON line per step, then a summary line.  Lanczos Ritz values are
upper bounds on the lowest eigenvalue: a recorded E0 below a converged
one means the recorded run was not of the same operator and arithmetic.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "true"
# nothing written outside the checkout: no artifact cache, no telemetry sink
os.environ["DMT_ARTIFACT_CACHE"] = "off"
os.environ.pop("DMT_OBS_DIR", None)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def recorded_e0() -> float:
    with open(os.path.join(ROOT, "BENCH_RECORDED_r02.json")) as fh:
        return float(json.load(fh)["detail"]["main"]["lanczos_e0"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--tol", type=float, default=1e-10)
    ap.add_argument("--tight-tol", type=float, default=1e-13)
    ap.add_argument("--max-iters", type=int, default=600)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import torch

    from distributed_matvec_tpu.models.lattices import heisenberg_chain
    from distributed_matvec_tpu.parallel.engine import LocalEngine as JLocal
    from distributed_matvec_tpu.solve import lanczos as j_lanczos
    from distributed_matvec_tpu_torch import LocalEngine as TLocal
    from distributed_matvec_tpu_torch import lanczos as t_lanczos
    from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                      operator_from_reference)

    t0 = time.perf_counter()
    op_j = heisenberg_chain(args.n, symmetric=True)
    op_j.basis.build()
    N = int(op_j.basis.number_states)
    emit({"step": "enumerate", "n_states": N,
          "seconds": time.perf_counter() - t0})
    op_t = operator_from_reference(operator_arrays(op_j), device="cpu")

    t0 = time.perf_counter()
    je = JLocal(op_j, mode="ell")
    emit({"step": "jax_build", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    te = TLocal(op_t, device="cpu")
    emit({"step": "port_build", "seconds": time.perf_counter() - t0})

    x = np.random.default_rng(13).standard_normal(N)
    yj = np.asarray(je.matvec(x))
    yt = te.matvec(torch.from_numpy(x)).numpy()
    emit({"step": "apply", "max_abs_diff": float(np.abs(yj - yt).max()),
          "max_abs_y": float(np.abs(yj).max()),
          "bit_equal": bool(np.array_equal(yj, yt))})
    del x, yj, yt

    rec = recorded_e0()
    out = {"n_states": N, "recorded_e0": rec}
    for tag, tol in (("tol", args.tol), ("tight", args.tight_tol)):
        for side, solve, mv in (("jax", j_lanczos, je.matvec),
                                ("port", t_lanczos, te.matvec)):
            kw = {"device": "cpu"} if side == "port" else {}
            t0 = time.perf_counter()
            res = solve(mv, N, k=1, tol=tol, max_iters=args.max_iters, **kw)
            e0 = float(np.asarray(res.eigenvalues)[0])
            row = {"step": f"lanczos_{side}_{tag}", "tol": tol, "e0": e0,
                   "iters": int(res.num_iters),
                   "converged": bool(res.converged),
                   "residual": float(np.asarray(res.residual_norms)[0]),
                   "e0_minus_recorded": e0 - rec,
                   "seconds": time.perf_counter() - t0}
            emit(row)
            out[f"{side}_{tag}"] = row
    out["port_minus_jax"] = out["port_tol"]["e0"] - out["jax_tol"]["e0"]
    out["port_minus_jax_tight"] = (out["port_tight"]["e0"]
                                   - out["jax_tight"]["e0"])
    emit({"summary": out})
    return 0


if __name__ == "__main__":
    sys.exit(main())
