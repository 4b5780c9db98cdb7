#!/usr/bin/env python3
"""Solve chain_n_symm on streamed engines of each coefficient tier with
each Lanczos form, on the CPU, to see which forms a quantized operator
misleads.

    JAX_PLATFORMS=cpu python3 tools/torch_quantized_lanczos.py [--n 24]

For each tier (``off``, then ``--tiers``): the port's streamed engine
(D = 1) and how far it is from Hermitian, ``|⟨y, Ax⟩ − ⟨Ay, x⟩| /
|⟨y, Ax⟩|`` for two seeded vectors; then the lowest eigenvalue from the
port's ``lanczos`` with ``reorth="selective"`` and ``"full"`` and from
its ``lanczos_block(k=1, block_size=2)``, and from the JAX package's
``lanczos_block`` on its own streamed engine of the same tier (the JAX
``lanczos`` refuses streamed engines).  One JSON line per tier.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "true"
# nothing written outside the checkout: no artifact cache, no telemetry sink
os.environ["DMT_ARTIFACT_CACHE"] = "off"
os.environ.pop("DMT_OBS_DIR", None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--tiers", default="lossless,f32,bf16")
    ap.add_argument("--batch-size", type=int, default=4096)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from distributed_matvec_tpu.models.lattices import heisenberg_chain
    from distributed_matvec_tpu.parallel.distributed import \
        DistributedEngine as JaxEngine
    from distributed_matvec_tpu.solve import lanczos_block as jax_block
    from distributed_matvec_tpu.utils.config import \
        update_config as jax_update_config
    from distributed_matvec_tpu_torch import (DistributedEngine, lanczos,
                                              lanczos_block)
    from distributed_matvec_tpu_torch.models.lattices import \
        heisenberg_chain as torch_chain

    op_j = heisenberg_chain(args.n, symmetric=True)
    op_j.basis.build()
    op_t = torch_chain(args.n, symmetric=True)
    op_t.basis.unchecked_set_representatives(op_j.basis.representatives,
                                             op_j.basis.norms)
    N = op_t.basis.number_states
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(N), rng.standard_normal(N)
    for tier in ["off"] + args.tiers.split(","):
        eng = DistributedEngine(op_t, mode="streamed", stream_compress=tier,
                                batch_size=args.batch_size, device="cpu")
        ax, ay = eng.matvec_global(x), eng.matvec_global(y)
        out = {"n": args.n, "n_states": N, "tier": tier,
               "asymmetry": float(abs(y @ ax - ay @ x) / abs(y @ ax))}
        for reorth in ("selective", "full"):
            r = lanczos(eng.matvec, v0=eng.random_hashed(0), k=1,
                        tol=1e-10, reorth=reorth, device="cpu")
            out[f"lanczos_{reorth}"] = float(r.eigenvalues[0])
        r = lanczos_block(eng.matvec, k=1, block_size=2, tol=1e-10, seed=0,
                          device="cpu")
        out["lanczos_block"] = float(r.eigenvalues[0])
        jax_update_config(stream_compress=tier)
        ej = JaxEngine(op_j, n_devices=1, mode="streamed",
                       batch_size=args.batch_size)
        rj = jax_block(ej.matvec, k=1, block_size=2, tol=1e-10, seed=0)
        out["jax_lanczos_block"] = float(np.asarray(rj.eigenvalues)[0])
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
