"""One rank of a CPU ``DistributedEngine`` rank group, for
``test_torch_ranks.py``.

    python tests/torch_rank_worker.py RANK WORLD INIT_METHOD OUT_DIR [serve]

Starts a gloo group on the CPU, builds every case of ``CASES[WORLD]`` as a
rank engine (one shard per process), runs the checks' inputs through it —
plan and tables, matvec (sequential and pipelined), Lanczos, the block
solvers, KPM, Krylov evolution, bound observables and the fused-capacity
overflow — then, at W = 2, the streamed engine's other forms (``FORMS``)
a codec mismatch, the self-tuning runtime (``run_tune``) and a wrapped
matvec (``run_wrapped``) — and saves what it saw to
``OUT_DIR/rank{RANK}.pt``.  With ``serve`` it runs only the solve service
over the group (``run_serve``, the JAX ``tests/multihost_worker.py``
serve leg).
It imports the port only, never JAX; the parent test compares against both
packages.
"""

import os
import sys
import time
import traceback
import types

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
                     {"mode": "hybrid", "hybrid_split": "stream:0,2,5",
                      "stream_compress": "lossless"},
                     None),
    "f32_raw": (12, 6, 1, SYMS_12_K0, 32,
                {"mode": "streamed", "stream_compress": "f32"}, 2),
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
                                device="cpu", stream_compress="lossless")
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
                          else "f32", mode="streamed")
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
                                    remote_buffer_size=8,
                                    stream_compress="lossless")
            eng.matvec(eng.to_hashed(x))
            out[mode] = None
        except RuntimeError as e:
            out[mode] = str(e)
    return out


def run_preempt(g):
    """The preemption latch across ranks: ``agreed`` max-reduces it, so
    when only the last rank latches every rank sees it set; then each
    solver's safe point on a rank engine raises ``Preempted`` on every
    rank alike; a one-shot ``lobpcg`` has none and runs through (record:
    solver → (name, iterations) or None)."""
    from distributed_matvec_tpu_torch import (DistributedEngine,
                                              kpm_moments, krylov_evolve,
                                              lanczos, lanczos_block,
                                              lobpcg)
    from distributed_matvec_tpu_torch.utils import preempt

    out = {"agreed_before": preempt.agreed(g)}
    if g.rank == g.world_size - 1:
        preempt.trigger()
    out["local"] = preempt.requested()
    out["agreed"] = preempt.agreed(g)
    preempt.reset()
    op = build_op(12, 6, 1, SYMS_12_K0)
    eng = DistributedEngine(op, mode="ell", batch_size=32, group=g,
                            device="cpu")
    solves = {
        "lanczos": lambda: lanczos(eng.matvec, v0=eng.random_hashed(1),
                                   tol=1e-14, max_iters=200),
        "lanczos_block": lambda: lanczos_block(eng.matvec, k=2,
                                               block_size=2, seed=1),
        "lobpcg": lambda: lobpcg(eng.matvec, eng.n_states, k=2,
                                 max_iters=60, tol=1e-14, seed=1),
        "kpm": lambda: kpm_moments(eng.matvec, n_moments=16, n_vectors=2,
                                   bounds=KPM_BOUNDS, seed=1),
        "evolve": lambda: krylov_evolve(eng.matvec, t_final=0.5, seed=1,
                                        krylov_dim=8),
    }
    inner = eng.matvec
    for name, solve in solves.items():
        # only rank 0 latches, after its third apply: the others learn it
        # at the next agreed safe point.  The wrapper stays a method of
        # the engine, so the solvers still find the rank engine behind it
        calls = {"n": 0}

        def counting(self, x, calls=calls):
            calls["n"] += 1
            if g.rank == 0 and calls["n"] == 3:
                preempt.trigger()
            return inner(x)

        eng.matvec = types.MethodType(counting, eng)
        try:
            solve()
            out[name] = None
        except preempt.Preempted as e:
            out[name] = (e.solver, e.iters, e.checkpoint_path)
        finally:
            del eng.matvec
            preempt.reset()
    out["agreed_after"] = preempt.agreed(g)
    return out


def run_tune(g, out_dir):
    """The self-tuning runtime on ranks (W = 2): each rank keeps its own
    artifact cache and only rank 0 saves to its own, so at a second build
    rank 0 restores and rank 1 searches — and they must still agree on one
    config (``agree_config``); a static engine's apply; then
    ``tune="live"``
    with a two-apply window, where rank 1 alone proposes a re-key at the
    first window boundary: the ranks agree on it and both rebuild at the
    next apply, which must equal a hand-set engine at the new knobs.
    Records tokens, stats, the applies and the retune events."""
    from distributed_matvec_tpu_torch import DistributedEngine, obs, tune
    from distributed_matvec_tpu_torch.utils.config import update_config

    os.environ["DMT_ARTIFACT_CACHE"] = "on"
    os.environ["DMT_ARTIFACT_DIR"] = os.path.join(out_dir,
                                                  f"artifacts{g.rank}")
    os.environ["DMT_TUNE_WINDOW"] = "2"
    op = build_op(12, 6, 1, SYMS_12_K0)
    x = inputs(op.basis.number_states, True, seed=5)
    out = {}
    try:
        update_config(tune="static")
        # only rank 0 saves a tuned artifact: at the second build it
        # restores while rank 1 searches
        DistributedEngine(op, mode="streamed", group=g, device="cpu")
        eng = DistributedEngine(op, mode="streamed", group=g, device="cpu")
        out["static"] = {"token": eng._tuned.token(),
                         "source": eng._tuned.source,
                         "stats": eng._tune_stats(),
                         "cal": dict(eng._tune_cal),
                         "y": eng.from_hashed(eng.matvec(eng.to_hashed(x)))}
        update_config(tune="live")
        eng = DistributedEngine(op, mode="streamed", group=g, device="cpu")
        first = eng._tuned
        cand = [c for c in tune.knob_grid(eng._tune_stats(), "streamed")
                if not c.same_knobs(first)][0]
        observe = eng._tuner.observe
        state = {"done": False}

        def proposing(*a, **k):
            observe(*a, **k)
            if eng._tuner.window_closed and not state["done"]:
                state["done"] = True
                return cand if g.rank == 1 else None
            return None

        eng._tuner.observe = proposing
        xh = eng.to_hashed(x)
        for _ in range(3):
            eng.matvec(xh)
        out["pending"] = (eng._retune_pending.token()
                          if eng._retune_pending is not None else None)
        y = eng.matvec(xh)                        # the re-key lands here
        out["live"] = {"first": first.token(), "token": eng._tuned.token(),
                       "y": eng.from_hashed(y),
                       "retunes": [e["new_token"]
                                   for e in obs.events("retune")]}
        update_config(tune="off")
        twin = DistributedEngine(op, mode="streamed", group=g, device="cpu",
                                 batch_size=eng.batch_size,
                                 stream_compress=cand.stream_compress,
                                 pipeline_depth=cand.pipeline_depth)
        out["twin_y"] = twin.from_hashed(twin.matvec(twin.to_hashed(x)))
    finally:
        update_config(tune="off")
        for k in ("DMT_ARTIFACT_CACHE", "DMT_ARTIFACT_DIR",
                  "DMT_TUNE_WINDOW"):
            os.environ.pop(k, None)
    return out


def run_wrapped(g):
    """ROADMAP Queue 3 item 1, the rank probe: ``lanczos`` on a wrapped
    rank engine's matvec summed its dots over this rank's shard only
    (−20.498 on rank 0 at chain_12_symm, −21.550 with the bound method)
    and left rank 1 in a collective.  Now every rank raises at the first
    apply; a collective right after shows no rank was left behind.
    Records (bound E0, the error message, the check sum)."""
    from distributed_matvec_tpu_torch import (DistributedEngine, lanczos,
                                              lanczos_block)

    op = build_op(12, 6, 1, SYMS_12_K0)
    eng = DistributedEngine(op, mode="ell", batch_size=32, group=g,
                            device="cpu")
    M = eng.shard_size
    out = {"bound": float(lanczos(eng.matvec, v0=eng.random_hashed(1),
                                  tol=1e-12).eigenvalues[0])}
    errors = []
    for solve in (lambda: lanczos(lambda v: eng.matvec(v),
                                  v0=eng.random_hashed(1), tol=1e-12),
                  # flat [M, p] blocks through a reshaping wrapper
                  lambda: lanczos_block(
                      lambda X: eng.matvec(X.reshape(1, M, -1)).reshape(
                          M, -1), k=1, block_size=2,
                      V0=eng.random_hashed(1, cols=2).reshape(M, 2))):
        try:
            solve()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    out["after"] = float(g.all_reduce(torch.ones((), dtype=torch.float64)))
    return out


def run_serve(g):
    """The solve service over the group (JAX ``EnginePool(mesh=)``): two
    same-basis ell ``eigs`` jobs drained one per batch
    (``block_width=1``), so the second comes from the pool — builds 1,
    hits 1, one ``engine_init`` — and both E0s recorded."""
    from distributed_matvec_tpu_torch import obs
    from distributed_matvec_tpu_torch.serve import (EnginePool, JobQueue,
                                                    JobSpec, Scheduler)

    inits = len(obs.events("engine_init"))
    pool = EnginePool(group=g)
    sched = Scheduler(queue=JobQueue(), pool=pool, rates=None,
                      block_width=1)
    specs = [JobSpec(job_id=f"mh{i}",
                     basis={"number_spins": 12, "hamming_weight": 6},
                     k=1, tol=1e-9, max_iters=200, mode="ell",
                     n_devices=g.world_size) for i in range(2)]
    for s in specs:
        sched.submit(s)
    n_done = sched.drain(scan_spool=False)
    recs = [sched.queue.result(s.job_id) for s in specs]
    return {"done": n_done, "builds": pool.builds, "hits": pool.hits,
            "evictions": pool.evictions,
            "statuses": [r["status"] for r in recs],
            "e0": [r["eigenvalues"][0] for r in recs],
            "engine_init": len(obs.events("engine_init")) - inits,
            "live": pool.live_device_count(),
            "pool_events": [e["event"] for e in obs.events("engine_pool")]}


class _Done(Exception):
    """The one leg asked for has run."""


def main(argv):
    rank, world, init_method, out_dir = (int(argv[1]), int(argv[2]),
                                         argv[3], argv[4])
    leg = argv[5] if len(argv) > 5 else "all"
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import warnings

    from distributed_matvec_tpu_torch.parallel.mesh import init_distributed

    g = init_distributed(backend="gloo", init_method=init_method,
                         world_size=world, rank=rank, device="cpu",
                         timeout_s=TIMEOUT_S)
    out = {"rank": rank, "world": world, "seconds": {}}
    try:
        if leg == "serve":
            out["serve"] = run_serve(g)
            raise _Done
        out["wire"] = run_wire(g)
        for name, spec in CASES[world].items():
            t0 = time.perf_counter()
            out[name] = run_case(g, name, spec)
            out["seconds"][name] = time.perf_counter() - t0
        if world == 2:
            out["forms"] = run_forms(g)
            out["tune"] = run_tune(g, out_dir)
            out["wrapped"] = run_wrapped(g)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            out["overflow"] = run_overflow(g)
        out["preempt"] = run_preempt(g)
    except _Done:
        pass
    except Exception:
        out["error"] = traceback.format_exc()
    out["jax_imported"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "distributed_matvec_tpu"))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()
    return 1 if "error" in out else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
