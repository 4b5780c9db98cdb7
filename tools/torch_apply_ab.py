#!/usr/bin/env python3
"""Time the port's chain_32_symm applies in two checkouts on one card, in
turns: A, B, B, A.

    python3 tools/torch_apply_ab.py DIR_A DIR_B

Each turn is a fresh process started in that checkout (its own build of
the kernels and the enumerator): ``heisenberg_chain(32, symmetric=True)``
enumerated natively, a lossless streamed ``DistributedEngine`` at the
default row chunk (15 synchronized applies after one untimed) and then a
``LocalEngine`` in ell mode (101 applies after one), with ``DMT_PHASES=off``;
each engine is timed with the telemetry layer on (the default) and then
with ``DMT_OBS=off`` (the series ``*_obs_off``), so the layer's per-apply
host cost is told apart from the difference between the checkouts.
Prints each turn's medians in ms and, last, the per-apply walls of every
turn as one JSON list.  Needs a CUDA device; compare two commits only
within one call, since cards and hosts differ between calls.
"""

import json
import statistics
import subprocess
import sys

CHILD = r'''
import os, sys, time, json
sys.path.insert(0, os.getcwd())
os.environ["DMT_PHASES"] = "off"
os.environ["DMT_ENUMERATION_BACKEND"] = "native"
import torch
from distributed_matvec_tpu_torch import DistributedEngine, LocalEngine
from distributed_matvec_tpu_torch.models.lattices import heisenberg_chain
dev = torch.device("cuda", 0)
op = heisenberg_chain(32, symmetric=True); op.basis.build()
def walls(e, x, n):
    w = []
    for _ in range(n):
        torch.cuda.synchronize(); t0 = time.perf_counter(); e.matvec(x)
        torch.cuda.synchronize(); w.append((time.perf_counter() - t0) * 1e3)
    return w
out = {}
eng = DistributedEngine(op, mode="streamed", stream_compress="lossless",
                        device=dev)
def both(key, e, x, n):
    os.environ.pop("DMT_OBS", None)
    out[key] = walls(e, x, n)
    os.environ["DMT_OBS"] = "off"
    out[key + "_obs_off"] = walls(e, x, n)
    os.environ.pop("DMT_OBS", None)
x = eng.random_hashed(3); eng.matvec(x)
both("streamed", eng, x, 15)
del eng; torch.cuda.empty_cache()
le = LocalEngine(op, device=dev)
xl = torch.randn(op.basis.number_states, dtype=torch.float64, device=dev)
le.matvec(xl)
both("ell", le, xl, 101)
print("AB " + json.dumps(out), flush=True)
'''


def main(argv) -> int:
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = argv[1], argv[2]
    res = []
    for name, tree in (("A", a), ("B", b), ("B", b), ("A", a)):
        p = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                           capture_output=True, text=True, timeout=600)
        line = [ln for ln in p.stdout.splitlines() if ln.startswith("AB ")]
        if not line:
            print(name, tree, "FAILED", p.stdout[-2000:], p.stderr[-3000:])
            return 1
        d = json.loads(line[0][3:])
        res.append((name, tree, d))
        print(name, tree, {k: round(statistics.median(v), 3)
                           for k, v in d.items()}, flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
