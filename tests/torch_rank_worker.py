"""One rank of a CPU ``DistributedEngine`` rank group, for
``test_torch_ranks.py``.

    python tests/torch_rank_worker.py RANK WORLD INIT_METHOD OUT_DIR

Starts a gloo group on the CPU, builds every case of ``CASES[WORLD]`` as a
rank engine (one shard per process), runs the checks' inputs through it —
plan and tables, matvec (sequential and pipelined), Lanczos, the block
solvers, KPM, Krylov evolution, bound observables and the fused-capacity
overflow — then, at W = 2, the streamed engine's other forms (``FORMS``)
and a codec mismatch — and saves what it saw to ``OUT_DIR/rank{RANK}.pt``.
It imports the port only, never JAX; the parent test compares against both
packages.
"""

import os
import sys
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: seconds any collective of the group may wait for its peers
TIMEOUT_S = 60.0

SYMS_12_K0 = [([*range(1, 12), 0], 0)]
RING_8_K1 = [([*range(1, 8), 0], 1)]
REAL_MODES = ("streamed", "ell", "compact", "fused")
COMPLEX_MODES = ("streamed", "ell", "fused")

#: per world size W: name → (n, hw, inv, syms, batch_size, modes) — the
#: shapes of test_torch_sharded_streamed.STREAMED_CONFIGS, plus the
#: 8-ring's complex k = 1 sector at W = 2; a shard holds M = 128 slots, so
#: B = 32 makes four row chunks
CASES = {
    2: {"chain_8": (8, 4, None, (), 32, REAL_MODES),
        "chain_12_symm": (12, 6, 1, SYMS_12_K0, 32, REAL_MODES),
        "ring_8_k1": (8, 4, None, RING_8_K1, 32, COMPLEX_MODES)},
    4: {"chain_10": (10, 5, None, (), 32, REAL_MODES),
        "chain_12_symm": (12, 6, 1, SYMS_12_K0, 32, REAL_MODES)},
}

#: the cases that also run KPM, Krylov evolution and bound observables:
#: case name → modes
DYNAMICS = {"chain_12_symm": ("streamed", "ell"),
            "ring_8_k1": ("ell", "fused")}

#: the fixed inputs, block order, made from seeds
KPM_BOUNDS = (-24.0, 14.0)

#: the chunked modes' pipelined applies: depths beside 0 (the last, past
#: the chunk count, clamps to it)
PIPE_MODES = ("streamed", "fused")


def pipe_depths(nchunks):
    return (2, 3, nchunks + 7)


#: W = 2 only: the streamed engine's other forms, each rank's plan and the
#: gathered apply (depth 0 and 2) held to the one-process engine: name →
#: (n, hw, inv, syms, batch_size, engine keywords, DICT_MAX for the build
#: or None)
FORMS = {
    "hybrid_mixed": (12, 6, 1, SYMS_12_K0, 32,
                     {"mode": "hybrid", "hybrid_split": "stream:0,2,5"},
                     None),
    "f32_raw": (12, 6, 1, SYMS_12_K0, 32, {"stream_compress": "f32"}, 2),
}


def build_form(op, spec, **kw):
    """The engine of a FORMS entry (``kw``: ``group``/``n_devices``),
    with the dictionary ceiling lowered around the build where it asks."""
    from distributed_matvec_tpu_torch import DistributedEngine
    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    _, _, _, _, B, ekw, dict_max = spec
    saved = PC.DICT_MAX
    PC.DICT_MAX = dict_max or saved
    try:
        return DistributedEngine(op, batch_size=B, device="cpu", **ekw, **kw)
    finally:
        PC.DICT_MAX = saved


#: the block solvers' arguments (the parent runs the same on one process
#: and in JAX)
BLOCK_KW = {"k": 2, "tol": 1e-11}
LOBPCG_KW = {"k": 2, "tol": 1e-12}


def build_op(n, hw, inv, syms):
    from distributed_matvec_tpu_torch.models.basis import SpinBasis
    from distributed_matvec_tpu_torch.models.lattices import (
        chain_edges, heisenberg_from_edges)

    basis = SpinBasis(n, hw, inv, list(syms))
    op = heisenberg_from_edges(basis, chain_edges(n))
    basis.build()
    return op


def inputs(n_states, real, seed=3, cols=None):
    """The test vector (block order) for a case."""
    rng = np.random.default_rng(seed)
    shape = (n_states,) + ((cols,) if cols else ())
    x = rng.random(shape) - 0.5
    if not real:
        x = x + 1j * (rng.random(shape) - 0.5)
    return x


def unit_block(n_states, cols, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n_states, cols))
    return v / np.linalg.norm(v, axis=0, keepdims=True)


def plan_of(eng):
    """This rank's plan and tables as NumPy arrays."""
    if eng.mode == "streamed":
        d = eng.group.rank
        return {"spec": dict(eng._codec.spec), "capacity": eng._capacity,
                "dict": eng._codec.dicts[d].copy(),
                "cdict": eng._cdict[0].numpy().copy(),
                "chunks": [eng.plan_chunk(ci) for ci in range(eng.nchunks)],
                "plan_bytes": int(eng.plan_bytes)}
    out = {k: v[0].numpy().copy()
           for k, v in eng.structure_arrays().items()}
    if eng.mode in ("ell", "compact"):
        out.update(T0=eng._ell_T0, C=eng.query_capacity,
                   split=tuple(eng.ell_split))
    else:
        out.update(capacity=eng._capacity)
    return out


def run_case(g, name, spec):
    from distributed_matvec_tpu_torch import (DistributedEngine,
                                              krylov_evolve, kpm_moments,
                                              lanczos, lanczos_block, lobpcg)
    from distributed_matvec_tpu_torch.models.observables import \
        bind_observables

    n, hw, inv, syms, B, modes = spec
    op = build_op(n, hw, inv, syms)
    N = op.basis.number_states
    res = {}
    for mode in modes:
        eng = DistributedEngine(op, mode=mode, batch_size=B, group=g,
                                device="cpu")
        r = {"plan": plan_of(eng), "shard_size": eng.shard_size}
        x = inputs(N, eng.real)
        r["y"] = eng.matvec(eng.to_hashed(x))[0].numpy().copy()
        r["y_global"] = eng.from_hashed(eng.matvec(eng.to_hashed(x)))
        X = eng.to_hashed(inputs(N, eng.real, seed=5, cols=3))
        r["Y"] = eng.matvec(X)[0].numpy().copy()
        r["rh"] = eng.random_hashed(4)[0].numpy().copy()
        r["rh_cols"] = eng.random_hashed(4, cols=3)[0].numpy().copy()
        r["dot"] = complex(eng.dot(eng.to_hashed(x), eng.to_hashed(x)))
        lz = lanczos(eng.matvec, v0=eng.random_hashed(0), k=1, tol=1e-11)
        r["e0"], r["e0_converged"] = float(lz.eigenvalues[0]), lz.converged
        if mode in DYNAMICS.get(name, ()):
            V0 = eng.to_hashed(unit_block(N, 3, 2))
            r["kpm"] = kpm_moments(eng.matvec, 32, V0=V0,
                                   bounds=KPM_BOUNDS).moments
            kp = kpm_moments(eng.matvec, 24, n_vectors=3, seed=6,
                             bounds_iters=16)
            r["kpm_seeded"], r["kpm_bounds"] = kp.moments, kp.bounds
            psi0 = eng.to_hashed(unit_block(N, 1, 7)[:, 0])
            ev = krylov_evolve(eng.matvec, psi0=psi0, t_final=1.0,
                               tol=1e-12, krylov_dim=16)
            r["evolve_times"] = ev.times
            r["evolve_psi"] = (eng.from_hashed(ev.psi.real)
                               + 1j * eng.from_hashed(ev.psi.imag))
            bo = bind_observables([op], eng)[0]
            psi = unit_block(N, 1, 9)[:, 0]
            r["obs_mode"] = bo.engine.mode
            r["expectation"] = bo.expectation(eng.to_hashed(psi))
            r["expectation_c"] = bo.expectation(
                eng.to_hashed(psi * np.exp(0.3j)))
        if mode in PIPE_MODES:
            xh = eng.to_hashed(x)
            r["y_pipe"], r["pipe_reported"], r["pipe_record"] = {}, {}, {}
            for depth in pipe_depths(eng.nchunks):
                eng.pipeline_depth = depth
                r["y_pipe"][depth] = eng.matvec(xh)[0].numpy().copy()
                r["pipe_reported"][depth] = eng.pipeline_depth
                r["pipe_record"][depth] = dict(eng.last_pipeline)
            eng.pipeline_depth = 2
            r["Y_pipe"] = eng.matvec(X)[0].numpy().copy()
            eng.pipeline_depth = 0
        lb = lanczos_block(eng.matvec, **BLOCK_KW)
        r["block"] = {"eigenvalues": lb.eigenvalues, "iters": lb.num_iters,
                      "converged": lb.converged}
        try:
            ev, vecs, it = lobpcg(eng.matvec, N, **LOBPCG_KW)
            r["lobpcg"] = {"eigenvalues": ev, "iters": it,
                           "vectors": vecs.numpy()}
        except ValueError as e:
            r["lobpcg"] = {"refused": str(e)}
        res[mode] = r
        del eng
    return res


#: the dtypes the exchange carries, some on a wider wire
WIRE_DTYPES = ("int16", "uint16", "bool", "int32", "int64", "float64",
               "complex128")


def wire_block(src, dst, dtype_name):
    """What rank ``src`` sends rank ``dst`` in the wire check: 3 values."""
    v = torch.arange(3, dtype=torch.int64) + 100 * src + 10 * dst
    if dtype_name == "bool":
        return v % 3 == 0
    if dtype_name == "complex128":
        return v.to(torch.complex128) * (1 - 2j)
    return v.to(getattr(torch, dtype_name))


def run_wire(g):
    """Every wire dtype through ``exchange`` and the staged exchange, a
    variable-size exchange, an all-gather and both reductions, as received
    here."""
    W, r = g.world_size, g.rank
    out = {}
    out["staged"] = {}
    for name in WIRE_DTYPES:
        send = torch.stack([wire_block(r, p, name) for p in range(W)])
        out[name] = g.exchange(send)
        out["staged"][name] = g.exchange_staged(send)
    out["lists"] = g.exchange_lists(
        [torch.arange(r + p + 1, dtype=torch.int64) + 1000 * r
         for p in range(W)])
    out["gather"] = g.all_gather(torch.tensor([r, -r],
                                              dtype=torch.complex128))
    out["sum"] = g.all_reduce(torch.tensor(r + 0.25, dtype=torch.float64))
    out["max"] = g.all_reduce(torch.tensor(r, dtype=torch.int64), "max")
    return out


def run_forms(g):
    """Every FORMS entry on this rank, and a codec mismatch — rank 0 asks
    for the lossless tier, the others for f32 — which must raise on every
    rank."""
    from distributed_matvec_tpu_torch import DistributedEngine

    out = {}
    for name, spec in FORMS.items():
        op = build_op(*spec[:4])
        eng = build_form(op, spec, group=g)
        x = inputs(op.basis.number_states, eng.real)
        xh = eng.to_hashed(x)
        r = {"spec": dict(eng._codec.spec), "kernel": eng.stream_kernel,
             "chunks": [eng.plan_chunk(ci) for ci in range(eng.nchunks)],
             "y_global": eng.from_hashed(eng.matvec(xh))}
        eng.pipeline_depth = 2
        r["y_global_depth2"] = eng.from_hashed(eng.matvec(xh))
        out[name] = r
    op = build_op(12, 6, 1, SYMS_12_K0)
    try:
        DistributedEngine(op, batch_size=32, group=g, device="cpu",
                          stream_compress="lossless" if g.rank == 0
                          else "f32")
        out["mismatch"] = None
    except RuntimeError as e:
        out["mismatch"] = str(e)
    return out


def run_overflow(g):
    """A capacity too small for the exchange: the streamed build and the
    first fused apply must raise on every rank."""
    from distributed_matvec_tpu_torch import DistributedEngine

    op = build_op(12, 6, None, ())
    x = inputs(op.basis.number_states, True, seed=1)
    out = {}
    for mode in ("streamed", "fused"):
        try:
            eng = DistributedEngine(op, mode=mode, batch_size=128, group=g,
                                    device="cpu",
                                    all_to_all_capacity_factor=1.0,
                                    remote_buffer_size=8)
            eng.matvec(eng.to_hashed(x))
            out[mode] = None
        except RuntimeError as e:
            out[mode] = str(e)
    return out


def main(argv):
    rank, world, init_method, out_dir = (int(argv[1]), int(argv[2]),
                                         argv[3], argv[4])
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import warnings

    from distributed_matvec_tpu_torch.parallel.mesh import init_distributed

    g = init_distributed(backend="gloo", init_method=init_method,
                         world_size=world, rank=rank, device="cpu",
                         timeout_s=TIMEOUT_S)
    out = {"rank": rank, "world": world, "seconds": {}}
    try:
        out["wire"] = run_wire(g)
        for name, spec in CASES[world].items():
            t0 = time.perf_counter()
            out[name] = run_case(g, name, spec)
            out["seconds"][name] = time.perf_counter() - t0
        if world == 2:
            out["forms"] = run_forms(g)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            out["overflow"] = run_overflow(g)
        out["jax_imported"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "distributed_matvec_tpu"))
    except Exception:
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()
    return 1 if "error" in out else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
