#!/usr/bin/env python3
"""Time the port's decode kernel against an earlier version of its source,
in one process on one card, at one shard.

    python3 tools/torch_decode_bench.py --earlier path/to/fused_decode.cu

Builds chain_32_symm's streamed plan at one shard (the ``full`` leg of
``chip_smoke.py``: 4 707 969 states, 72 chunks of 65 536 rows), builds the
earlier source with the same ``nvcc`` flags beside the current kernel, and
checks both against the plain version on every chunk (``torch.equal``).
The earlier source is the decode kernel that takes the chunk's ``rok``
words (the entry point of ``fused_decode.cu`` before the fill counts):
at one shard they mark the same slots.  Then it times the two in turns
(current, earlier, earlier, current), each turn the median of 5 device
timings of all 72 launches, and prints one JSON line: µs per launch per
turn and their medians, with the card's name and power limit.  It needs a
CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _earlier_library(source: str):
    """Build ``source`` as chip_smoke builds the current kernel and bind
    its rok-taking entry point."""
    from distributed_matvec_tpu_torch.ops import cuda_kernels
    from distributed_matvec_tpu_torch.utils.build import build_dir

    out = os.path.join(build_dir("dmt_torch_kernels"), "libearlier.so")
    subprocess.run([cuda_kernels._nvcc(), *cuda_kernels.NVCC_FLAGS, "-o",
                    out, source], check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = lib.dmt_fused_decode_gather_scatter
    fn.restype = i32
    fn.argtypes = [vp, i64, i64, vp, i32, vp, vp, vp, vp, i64, i32, i32, i64,
                   vp]
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", required=True,
                    help="an earlier fused_decode.cu (takes rok words)")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from distributed_matvec_tpu_torch import DistributedEngine
    from distributed_matvec_tpu_torch.models.lattices import heisenberg_chain
    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    os.environ["DMT_ENUMERATION_BACKEND"] = "native"
    op = heisenberg_chain(32, symmetric=True)
    eng = DistributedEngine(op, device=device)
    spec, B, n = eng._codec.spec, eng.batch_size, eng.nchunks
    earlier = _earlier_library(args.earlier)
    plan = eng._plan_host.to(device)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        n * B)).to(device)
    views = [eng._chunk_views(plan[ci, 0]) for ci in range(n)]
    cur = [(spec, v[0], v[1], v[4], eng._cdict[0], x[ci * B:(ci + 1) * B])
           for ci, v in enumerate(views)]
    outs = [torch.empty(spec["n_recv"] + 1, dtype=torch.float64,
                        device=device) for _ in range(n)]
    nl = spec["n_live"]
    nwd = PC.packed_words(nl, spec["w_dest"])
    nwr = PC.packed_words(nl, spec["w_row"])

    def run_earlier():
        stream = torch.cuda.current_stream(device).cuda_stream
        for (sp, edest, codes, _, cdict, x_c), v, out in zip(cur, views,
                                                             outs):
            rc = earlier(edest.data_ptr(), nwd, nwr, codes.data_ptr(),
                         sp["code_bits"], v[3].data_ptr(), cdict.data_ptr(),
                         x_c.data_ptr(), out.data_ptr(), nl, sp["w_dest"],
                         sp["w_row"], sp["n_recv"], stream)
            if rc:
                raise RuntimeError(f"earlier kernel launch failed ({rc})")

    def run_current():
        for a, out in zip(cur, outs):
            PC._launch_fused_decode(*a, out)

    for run in (run_current, run_earlier):
        for out in outs:
            out.fill_(float("nan"))
        run()
        torch.cuda.synchronize()
        for a, out in zip(cur, outs):
            if not torch.equal(out, PC._fused_decode_gather_scatter_plain(
                    *a)):
                raise AssertionError(f"{run.__name__} differs from the "
                                     "plain version")
    turns = {"current": [], "earlier": []}
    for name in ("current", "earlier", "earlier", "current"):
        fn = run_current if name == "current" else run_earlier
        turns[name].append(chip_smoke.device_ms(device, fn, reps=5) / n
                           * 1e3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "launches_per_turn": n,
                      "us_per_launch": turns,
                      "median_us": {k: statistics.median(v)
                                    for k, v in turns.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
