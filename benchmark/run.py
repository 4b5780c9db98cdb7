#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of the checkout.  ``BENCHMARK.json`` names the cells.  The
last line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared beside its limit); the last lines of
standard error repeat the checks.  Exits 2 without a result where the card
is missing or there are fewer cards than the cell asks for, 3 where JAX
or the JAX package was loaded, and 4 where a per-layer metric that the
cell lists found nothing to read on the card.

A cell whose configuration declares ``"ranks": true`` runs one process per
card (``ranks.py``): this process launches them under ``torchrun``, each
as ``run.py … --worker``, and prints rank 0's result.
"""

import time

#: the set-up's clock starts here, before any other import
T_START = time.time()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import harness
    import importcheck
    from checks import report

    args = harness.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.prepare_env(cell, ROOT)
    import torch

    cpu = args.device == "cpu"
    if not cpu and (not torch.cuda.is_available() or
                    torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    group, t_start = None, T_START
    device = torch.device("cpu") if cpu else torch.device("cuda", 0)
    if cell.config.get("ranks"):
        import ranks

        if not args.worker:
            return ranks.launch(os.path.abspath(__file__),
                                sys.argv[1:] if argv is None else list(argv),
                                cell.chips, T_START)
        group, t_start = ranks.join(cpu), ranks.t_start()
        device = group.device
    try:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), device, t_start,
                                  group=group)
    except harness.MetricMissing as e:
        print(e, file=sys.stderr)
        return 4
    finally:
        # after run_cell has let go of the engine built on the group
        if group is not None:
            torch.distributed.destroy_process_group()
    loaded = importcheck.loaded_forbidden(sys.modules)
    if loaded:
        print(f"loaded in this process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    if result is None:          # a rank other than 0: rank 0 reports
        return 0
    if group is None:           # the launcher repeats rank 0's checks last
        report(result["checks"])
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
