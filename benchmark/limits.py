#!/usr/bin/env python3
"""Readings for the check's limits, on the card at a cell's own size.

    python3 benchmark/limits.py --workload <cell> --seeds 12 \\
        --control-seeds 3 --seconds <s> --first-seed <n>

In one process (set-up once): the program's engine runs the cell's traffic
for ``--seconds`` on each of ``--seeds`` seeds and the check reads its
numbers; then the control, the reference in float32 in the program's place,
does the same on ``--control-seeds`` seeds.  Prints one JSON line per seed
and, last, the largest reading of each number over the program's seeds and
the smallest over the control's: a limit goes between the two.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import checks
    import harness
    import loops

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.prepare_env(cell, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    sync = harness.make_sync(device)
    cfg, kind = cell.config, cell.traffic["kind"]
    op = harness.call(cfg["program"]["operator"])
    op.basis.build()
    reps = np.asarray(op.basis.representatives)
    norms = np.asarray(op.basis.norms)
    ref = checks.build_reference(cfg, reps, norms, device)
    sides = [("program", harness.call(cfg["program"]["engine"], op,
                                      device=device), args.seeds),
             ("control", checks.ControlEngine(cfg, reps, norms, device,
                                              H=ref[1]),
              args.control_seeds)]
    worst = {"program": {}, "control": {}}
    seed = args.first_seed
    for side, eng, n in sides:
        space = loops.VectorSpace(eng, len(reps), device)
        for _ in range(n):
            loop = loops.make(cell.traffic, eng, space, seed, sync, False,
                              harness.PORT)
            if not worst[side]:
                loop.warm_up()
            loop.run(args.seconds)
            numbers, wrong = checks.judge(
                cfg, kind, reps, norms, loop.host_outputs(),
                getattr(loop, "solves", None), seed, device, reference=ref)
            vals = {k: v["value"] for k, v in numbers.items()}
            print(json.dumps({"side": side, "seed": seed,
                              "requests": loop.attempted,
                              "failed": loop.failed, "wrong": wrong,
                              **vals}), flush=True)
            pick = max if side == "program" else min
            for k, v in vals.items():
                worst[side][k] = pick(worst[side].get(k, v), v)
            seed += 1
            del loop
        del eng, space
        torch.cuda.empty_cache()
    print(json.dumps({"program_max": worst["program"],
                      "control_min": worst["control"],
                      "seconds": time.time() - T_START}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
