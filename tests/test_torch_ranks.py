"""The rank engine — ``DistributedEngine(group=…)``, one shard per process
over ``torch.distributed`` (gloo, on the CPU) — against the port's
one-process engine and the JAX ``DistributedEngine`` at the same D.

Two rank groups, W = 2 and W = 4, are spawned once for the module, side by
side (``tests/torch_rank_worker.py``; each rank imports the port only).
While they run, this process builds the references; the parametrised cases
read what the ranks saved.

Tolerances:
* per-rank plan streams, codes, dictionaries, codec spec and ELL/compact
  tables: bit-identical to the one-process engine's shard r (the same
  routing and host encode; only the exchange moved into a collective);
* matvec rows and block applies: bit-identical to the one-process engine
  on the CPU (the same per-shard work in the same order), and within atol
  1e-14 / rtol 1e-12 of the JAX ``DistributedEngine`` (the reference's
  tolerance, TestMatrixVectorProduct.chpl:15-16);
* pipelined streamed and fused applies (depth 2, 3 and past the chunk
  count): bit-identical to the rank's sequential apply and to the
  one-process engine (the staged exchange moves the same elements, and
  chunks retire in order);
* the staged exchange: element-identical to ``exchange`` in every wire
  dtype;
* ``random_hashed`` and ``dot``: rtol 1e-14 (the same draws and products,
  summed in another order across the ranks);
* Lanczos E0: within 1e-10 of the JAX solver; the 12-ring's E0/4 within
  1e-9 of −5.3873909174;
* ``lanczos_block`` and ``lobpcg`` (k = 2): eigenvalues within 1e-10 of
  the JAX solvers on the JAX engine at the same D, iteration counts equal
  to the port's one-process solve at the same D (TSQR and the reduced
  dots round differently, but no convergence test of these cases sits on
  its edge), the same bits on every rank; ``lobpcg`` on a complex sector
  raises its real-only ``ValueError``;
* KPM moments, spectral bounds, Krylov evolution and bound expectation
  values: within 1e-12 of the one-process engine (the dots are summed in
  another order); accepted step times equal;
* collective results (moments, E0) are the same bits on every rank.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from distributed_matvec_tpu.parallel.distributed import \
    DistributedEngine as JaxEngine
from distributed_matvec_tpu.parallel.engine import LocalEngine as JaxLocal
from distributed_matvec_tpu.solve import lanczos as jax_lanczos
from distributed_matvec_tpu.solve import lanczos_block as jax_lanczos_block
from distributed_matvec_tpu.solve import lobpcg as jax_lobpcg
from distributed_matvec_tpu_torch import (DistributedEngine, krylov_evolve,
                                          kpm_moments, lanczos_block, lobpcg)
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)
from distributed_matvec_tpu_torch.models.observables import \
    bind_observables
from distributed_matvec_tpu_torch.parallel import mesh

import torch_rank_worker as RW
from test_operator import build_heisenberg

ATOL, RTOL = 1e-14, 1e-12
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_rank_worker.py")
ROOT = os.path.dirname(os.path.dirname(WORKER))
#: seconds the module waits for both rank groups before killing them
JOIN_TIMEOUT_S = 300
RING_12_E0_OVER_4 = -5.3873909174

CASES = [(W, name, mode) for W in sorted(RW.CASES)
         for name, spec in RW.CASES[W].items() for mode in spec[5]]
DYN_CASES = [c for c in CASES if c[2] in RW.DYNAMICS.get(c[1], ())]
PIPE_CASES = [c for c in CASES if c[2] in RW.PIPE_MODES]


def _ids(cases):
    return ["-".join(map(str, c)) for c in cases]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Start both rank groups; yields ``{W: (out_dir, [Popen])}`` and kills
    whatever still runs at teardown."""
    root = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    groups = {}
    for W in sorted(RW.CASES):
        d = root / f"w{W}"
        d.mkdir()
        procs = []
        for r in range(W):
            log = open(d / f"log{r}.txt", "w")
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(r), str(W),
                 f"file://{d / 'rendezvous'}", str(d)],
                env=env, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT))
            log.close()
        groups[W] = (d, procs)
    yield groups
    for _, procs in groups.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


class Ref:
    """One configuration at D = W in both packages: the port's one-process
    engines by mode, the JAX engine (ell) and the JAX solver's E0."""

    def __init__(self, W, spec):
        n, hw, inv, syms, B, modes = spec
        self.op_j = build_heisenberg(n, hw, inv, list(syms))
        self.op_j.basis.build()
        self.op_t = operator_from_reference(operator_arrays(self.op_j),
                                            device="cpu")
        self.N = self.op_j.basis.number_states
        self.real = self.op_j.effective_is_real
        self.eng = {m: DistributedEngine(self.op_t, n_devices=W, mode=m,
                                         batch_size=B, device="cpu")
                    for m in modes}
        self.jax = JaxEngine(self.op_j, n_devices=W, mode="ell",
                             batch_size=B)
        self.e0 = float(jax_lanczos(JaxLocal(self.op_j).matvec, self.N, k=1,
                                    tol=1e-11).eigenvalues[0])
        # the block solvers on the JAX engine at the same D
        self.block = np.asarray(jax_lanczos_block(
            self.jax.matvec, **RW.BLOCK_KW).eigenvalues)
        self.lobpcg = None
        if self.real:
            self.lobpcg = np.asarray(jax_lobpcg(
                self.jax.matvec, self.N, **RW.LOBPCG_KW)[0])


@pytest.fixture(scope="module")
def refs(spawned):
    """The references, built while the ranks run."""
    return {(W, name): Ref(W, spec) for W in sorted(RW.CASES)
            for name, spec in RW.CASES[W].items()}


@pytest.fixture(scope="module")
def ranks(spawned, refs):
    """``{W: [rank 0's output, …]}`` once every rank has exited."""
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    out = {}
    for W, (d, procs) in spawned.items():
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                for q in (q for _, ps in spawned.values() for q in ps):
                    q.kill()
                pytest.fail(f"a W = {W} rank did not finish in "
                            f"{JOIN_TIMEOUT_S} s (killed)")
        outs = []
        for r, p in enumerate(procs):
            path = d / f"rank{r}.pt"
            log = (d / f"log{r}.txt").read_text()
            assert p.returncode == 0 and path.exists(), (
                f"W = {W} rank {r} exited {p.returncode}:\n{log}")
            outs.append(torch.load(path, weights_only=False))
        out[W] = outs
    return out


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


# -- the plan -------------------------------------------------------------------

@pytest.mark.parametrize("W,name,mode", CASES, ids=_ids(CASES))
def test_rank_plan_equals_one_process_shard(ranks, refs, W, name, mode):
    e1 = refs[W, name].eng[mode]
    for r, out in enumerate(ranks[W]):
        got = out[name][mode]["plan"]
        assert out[name][mode]["shard_size"] == e1.shard_size
        if mode == "streamed":
            assert got["spec"] == e1._codec.spec
            assert got["capacity"] == e1._capacity
            _same(got["dict"], e1._codec.dicts[r], "dict")
            _same(got["cdict"], e1._cdict[r].numpy(), "cdict")
            assert len(got["chunks"]) == e1.nchunks > 1
            for ci, chunk in enumerate(got["chunks"]):
                want = e1.plan_chunk(ci, r)
                for k in ("dest", "ridx", "rok", "coeff", "fill"):
                    _same(chunk[k], want[k], f"rank {r} chunk {ci} {k}")
        elif mode in ("ell", "compact"):
            assert (got["T0"], got["C"], got["split"]) == (
                e1._ell_T0, e1.query_capacity, tuple(e1.ell_split))
            arrays = e1.structure_arrays()
            assert sorted(k for k in got if k not in ("T0", "C", "split")) \
                == sorted(arrays)
            for k, a in arrays.items():
                _same(got[k], a[r].numpy(), f"rank {r} {k}")
            assert int((got["qin"] != 0).sum()) > 0
        else:
            assert got["capacity"] == e1._capacity
    if mode == "streamed":
        assert sum(o[name][mode]["plan"]["plan_bytes"]
                   for o in ranks[W]) == e1.plan_bytes


# -- the apply ------------------------------------------------------------------

@pytest.mark.parametrize("W,name,mode", CASES, ids=_ids(CASES))
def test_rank_matvec(ranks, refs, W, name, mode):
    ref = refs[W, name]
    e1 = ref.eng[mode]
    x = RW.inputs(ref.N, ref.real)
    X = e1.to_hashed(RW.inputs(ref.N, ref.real, seed=5, cols=3))
    y1 = e1.matvec(e1.to_hashed(x)).numpy()
    Y1 = e1.matvec(X).numpy()
    want = np.asarray(ref.jax.matvec_global(x))
    for r, out in enumerate(ranks[W]):
        got = out[name][mode]
        _same(got["y"], y1[r], f"rank {r} y")
        _same(got["Y"], Y1[r], f"rank {r} block")
        np.testing.assert_allclose(got["y_global"], want, atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(got["y_global"], ref.op_j.matvec_host(x),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got["rh"],
                                   e1.random_hashed(4)[r].numpy(),
                                   rtol=1e-14, atol=0)
        np.testing.assert_allclose(got["rh_cols"],
                                   e1.random_hashed(4, cols=3)[r].numpy(),
                                   rtol=1e-14, atol=0)
        xh = e1.to_hashed(x)
        assert got["dot"] == pytest.approx(complex(e1.dot(xh, xh)),
                                           rel=1e-14)


# -- the solvers ----------------------------------------------------------------

@pytest.mark.parametrize("W,name,mode", CASES, ids=_ids(CASES))
def test_rank_lanczos_matches_jax(ranks, refs, W, name, mode):
    e0s = [out[name][mode]["e0"] for out in ranks[W]]
    assert all(out[name][mode]["e0_converged"] for out in ranks[W])
    assert len(set(e0s)) == 1, e0s             # the same bits on every rank
    assert abs(e0s[0] - refs[W, name].e0) < 1e-10
    if name == "chain_12_symm":
        assert abs(e0s[0] / 4 - RING_12_E0_OVER_4) < 1e-9


@pytest.mark.parametrize("W,name,mode", DYN_CASES, ids=_ids(DYN_CASES))
def test_rank_dynamics_match_one_process(ranks, refs, W, name, mode):
    """KPM (given and seeded blocks), Krylov evolution and a bound
    observable on the rank engine against the same calls on the
    one-process engine."""
    ref = refs[W, name]
    e1 = ref.eng[mode]
    V0 = e1.to_hashed(RW.unit_block(ref.N, 3, 2))
    kpm = kpm_moments(e1.matvec, 32, V0=V0, bounds=RW.KPM_BOUNDS).moments
    kp = kpm_moments(e1.matvec, 24, n_vectors=3, seed=6, bounds_iters=16)
    ev = krylov_evolve(e1.matvec, psi0=e1.to_hashed(
        RW.unit_block(ref.N, 1, 7)[:, 0]), t_final=1.0, tol=1e-12,
        krylov_dim=16)
    psi_ev = e1.from_hashed(ev.psi.real) + 1j * e1.from_hashed(ev.psi.imag)
    bo = bind_observables([ref.op_t], e1)[0]
    psi = RW.unit_block(ref.N, 1, 9)[:, 0]
    outs = [out[name][mode] for out in ranks[W]]
    for got in outs:
        np.testing.assert_allclose(got["kpm"], kpm, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got["kpm_seeded"], kp.moments, rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(got["kpm_bounds"], kp.bounds, rtol=0,
                                   atol=1e-12)
        _same(got["evolve_times"], ev.times, "accepted step times")
        np.testing.assert_allclose(got["evolve_psi"], psi_ev, rtol=0,
                                   atol=1e-12)
        assert got["obs_mode"] == "fused"
        assert got["expectation"] == pytest.approx(
            bo.expectation(e1.to_hashed(psi)), abs=1e-12)
        assert got["expectation_c"] == pytest.approx(
            got["expectation"], abs=1e-12)
    for key in ("kpm", "kpm_seeded", "evolve_psi"):
        for got in outs[1:]:
            _same(got[key], outs[0][key], f"{key} across ranks")


@pytest.mark.parametrize("W,name,mode", CASES, ids=_ids(CASES))
def test_rank_block_solvers(ranks, refs, W, name, mode):
    """``lanczos_block`` and ``lobpcg`` on the rank engine against the JAX
    solvers at the same D, and the port's one-process solve's iteration
    counts; every rank returns the same bits."""
    ref = refs[W, name]
    e1 = ref.eng[mode]
    outs = [out[name][mode] for out in ranks[W]]
    one = lanczos_block(e1.matvec, **RW.BLOCK_KW)
    for got in outs:
        blk = got["block"]
        assert blk["converged"]
        np.testing.assert_allclose(blk["eigenvalues"], ref.block, rtol=0,
                                   atol=1e-10)
        assert blk["iters"] == one.num_iters
        _same(blk["eigenvalues"], outs[0]["block"]["eigenvalues"],
              "lanczos_block eigenvalues across ranks")
    if not ref.real:
        for got in outs:
            assert "real sectors only" in got["lobpcg"]["refused"]
        return
    ev1, _, it1 = lobpcg(e1.matvec, ref.N, **RW.LOBPCG_KW)
    h = ref.op_j.matvec_host
    for got in outs:
        lb = got["lobpcg"]
        np.testing.assert_allclose(lb["eigenvalues"], ref.lobpcg, rtol=0,
                                   atol=1e-10)
        assert lb["iters"] == it1
        _same(lb["eigenvalues"], outs[0]["lobpcg"]["eigenvalues"],
              "lobpcg eigenvalues across ranks")
        for i in range(RW.LOBPCG_KW["k"]):
            v = lb["vectors"][:, i]
            assert np.linalg.norm(h(v) - lb["eigenvalues"][i] * v) < 1e-6


@pytest.mark.parametrize("W,name,mode", PIPE_CASES, ids=_ids(PIPE_CASES))
def test_rank_pipelined_matvec(ranks, refs, W, name, mode):
    """Pipelined applies on the rank engine at depth 2, 3 and past the
    chunk count: the rank's sequential row bit for bit, and so the
    one-process engine's; the depth reported is the resolved one."""
    e1 = refs[W, name].eng[mode]
    for r, out in enumerate(ranks[W]):
        got = out[name][mode]
        for depth, y in got["y_pipe"].items():
            _same(y, got["y"], f"rank {r} depth {depth}")
            want = 2 if mode == "fused" else min(depth, e1.nchunks)
            assert got["pipe_reported"][depth] == want
            rec = got["pipe_record"][depth]
            assert rec["depth"] == want and rec["chunks"] == e1.nchunks
            assert rec["barrier_ms"] >= 0.0
        _same(got["Y_pipe"], got["Y"], f"rank {r} block at depth 2")


@pytest.mark.parametrize("W", sorted(RW.CASES))
@pytest.mark.parametrize("mode", ["streamed", "fused"])
def test_rank_overflow_raises_on_every_rank(ranks, W, mode):
    """A fused capacity too small: the streamed build and the first fused
    apply raise on every rank (the counts are all-reduced before the
    check), and no rank is left waiting in a collective."""
    msgs = [out["overflow"][mode] for out in ranks[W]]
    assert all(m is not None and "overflowed" in m for m in msgs), msgs
    assert len(set(msgs)) == 1


# -- the group ------------------------------------------------------------------

@pytest.mark.parametrize("W", sorted(RW.CASES))
def test_rank_wire_formats(ranks, W):
    """int16/uint16 (widened), bool (as uint8) and complex (as
    ``view_as_real``) come back in their own dtype and values, through the
    equal and the variable-size exchange, the all-gather and the
    reductions."""
    for r, out in enumerate(ranks[W]):
        wire = out["wire"]
        for name in RW.WIRE_DTYPES:
            want = torch.stack([RW.wire_block(s, r, name) for s in range(W)])
            assert wire[name].dtype == want.dtype, name
            assert torch.equal(wire[name], want), name
        for s, got in enumerate(wire["lists"]):
            assert torch.equal(got, torch.arange(s + r + 1) + 1000 * s)
        assert torch.equal(wire["gather"], torch.tensor(
            [[s, -s] for s in range(W)], dtype=torch.complex128))
        assert float(wire["sum"]) == sum(s + 0.25 for s in range(W))
        assert int(wire["max"]) == W - 1


@pytest.mark.parametrize("W", sorted(RW.CASES))
def test_rank_staged_exchange(ranks, W):
    """The staged exchange (W − 1 point-to-point rounds and the local
    copy) gives what ``exchange`` gives, element for element, in every
    wire dtype."""
    for r, out in enumerate(ranks[W]):
        wire = out["wire"]
        for name in RW.WIRE_DTYPES:
            got, want = wire["staged"][name], wire[name]
            assert got.dtype == want.dtype, name
            assert torch.equal(got, want), (r, name)


@pytest.mark.parametrize("W", sorted(RW.CASES))
def test_ranks_import_no_jax(ranks, W):
    for out in ranks[W]:
        assert out["jax_imported"] == []


def test_nccl_two_ranks_on_one_card_raise(monkeypatch):
    """NCCL refuses two ranks on one device: the check raises before NCCL
    is touched — directly, and through ``init_distributed``."""
    with pytest.raises(ValueError, match="one card per rank"):
        mesh.check_nccl_placement(1, 2, 1)
    with pytest.raises(ValueError, match="one card per rank"):
        mesh.check_nccl_placement(0, 2, 1)
    mesh.check_nccl_placement(0, 1, 1)
    mesh.check_nccl_placement(3, 4, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: pytest.fail("NCCL was touched"))
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        mesh.init_distributed(init_method="tcp://localhost:1",
                              world_size=2, rank=1)


def test_rank_engine_arguments():
    """A rank engine takes its D from the group, and a shared layout must
    be for the same D and basis, with the JAX engine's message."""
    op = build_heisenberg(8, 4)
    op.basis.build()
    op_t = operator_from_reference(operator_arrays(op), device="cpu")
    g = mesh.ShardGroup(rank=0, world_size=2, backend="gloo",
                        device=torch.device("cpu"))
    with pytest.raises(ValueError, match="one shard per rank"):
        DistributedEngine(op_t, n_devices=4, group=g)
    e2 = DistributedEngine(op_t, n_devices=2, mode="fused", device="cpu")
    with pytest.raises(ValueError, match="shared layout is for 70 states "
                                         "on 2 shards, engine needs 70 on 4"):
        DistributedEngine(op_t, n_devices=4, mode="fused", device="cpu",
                          layout=e2.layout)
    e_shared = DistributedEngine(op_t, n_devices=2, mode="fused",
                                 device="cpu", layout=e2.layout)
    assert e_shared.layout is e2.layout


# -- the block solvers' distributed pieces, ranks as threads ------------------

def _thread_ranks(W, fn):
    """Run ``fn(q, gather)`` for q = 0 … W−1 in W threads, ``gather(t)``
    stacking every thread's ``t`` in rank order as ``all_gather`` does;
    returns the results in rank order."""
    import threading

    barrier = threading.Barrier(W, timeout=60)
    slots, out, errs = [None] * W, [None] * W, []

    def run(q):
        def gather(t):
            slots[q] = t
            barrier.wait()
            got = torch.stack(list(slots))
            barrier.wait()
            return got

        try:
            out[q] = fn(q, gather)
        except BaseException as e:       # reported on the main thread
            errs.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(q,)) for q in range(W)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    if errs:
        raise errs[0]
    return out


@pytest.mark.parametrize("W,M,p", [(2, 40, 3), (4, 5, 3), (4, 2, 3)])
def test_tsqr_across_ranks(W, M, p):
    """TSQR of an ``[W·M, p]`` block held M rows per rank (fewer rows than
    columns included): Q's rows stacked are orthonormal and give back the
    block with R, R equals the whole block's QR with a non-negative
    diagonal, and every rank holds the same bits of R."""
    from distributed_matvec_tpu_torch.solve.lanczos import _tsqr

    X = torch.from_numpy(np.random.default_rng(W * 100 + M).standard_normal(
        (W * M, p)))

    class G:
        def __init__(self, q, gather):
            self.rank, self.all_gather = q, gather

    outs = _thread_ranks(W, lambda q, gather: _tsqr(
        X[q * M:(q + 1) * M], G(q, gather)))
    Q = torch.cat([o[0] for o in outs])
    R = outs[0][1]
    for _, Rq in outs[1:]:
        assert torch.equal(Rq, R)
    np.testing.assert_allclose(Q @ R, X, rtol=0, atol=1e-13)
    np.testing.assert_allclose(Q.T @ Q, np.eye(p), rtol=0, atol=1e-13)
    Qw, Rw = torch.linalg.qr(X)
    sgn = torch.where(torch.diagonal(Rw) < 0, -1.0, 1.0)
    np.testing.assert_allclose(R, sgn[:, None] * Rw, rtol=0, atol=1e-13)
    assert bool((torch.diagonal(R) >= 0).all())


@pytest.mark.parametrize("W,M,k", [(2, 30, 2), (4, 3, 2), (4, 1, 2)])
def test_lobpcg_basis_extension_across_ranks(W, M, k):
    """LOBPCG's basis extension where the k + m leading rows it reads may
    span ranks (M < 2k): the rows of every rank's extension stacked equal
    the one-process extension's (atol 1e-14) and extend X orthonormally."""
    from distributed_matvec_tpu_torch.solve.lobpcg import (_extend_basis,
                                                           _Rows)

    n = W * M
    X, _ = torch.linalg.qr(torch.from_numpy(np.random.default_rng(
        n + k).standard_normal((n, k))))
    want = _extend_basis(X, k, _Rows(n))
    outs = _thread_ranks(W, lambda q, gather: _extend_basis(
        X[q * M:(q + 1) * M], k, _Rows(n, M, red=None, gather=gather,
                                      row0=q * M)))
    got = torch.cat(outs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    B = torch.cat([X, got], dim=1)
    np.testing.assert_allclose(B.T @ B, np.eye(2 * k), rtol=0, atol=1e-13)


# -- the streamed engine's other forms (W = 2) -----------------------------------

@pytest.mark.parametrize("name", sorted(RW.FORMS))
def test_rank_stream_forms(ranks, name):
    """A mixed hybrid split and an ``f32`` engine with raw coefficient
    streams on two ranks: each rank's plan is the one-process engine's
    shard, and the gathered apply at depth 0 and 2 equals the one-process
    apply bit for bit."""
    spec = RW.FORMS[name]
    op = RW.build_op(*spec[:4])
    e1 = RW.build_form(op, spec, n_devices=2)
    x = RW.inputs(op.basis.number_states, e1.real)
    want = e1.matvec_global(x)
    for r, out in enumerate(ranks[2]):
        got = out["forms"][name]
        assert got["spec"] == e1._codec.spec
        assert got["kernel"] == e1.stream_kernel == "torch"
        for ci, chunk in enumerate(got["chunks"]):
            for k, v in e1.plan_chunk(ci, r).items():
                _same(chunk[k], v, f"rank {r} chunk {ci} {k}")
        _same(got["y_global"], want, f"rank {r} gathered apply")
        _same(got["y_global_depth2"], want, f"rank {r} at depth 2")
    if name == "f32_raw":
        assert e1._codec.spec["coeff"] == "raw"
    else:
        assert 0 < e1.hybrid_stream_fraction < 1


def test_rank_codec_mismatch_raises_on_every_rank(ranks):
    """Ranks that ask for different tiers raise together, before the codec
    is built, with the same message."""
    msgs = [out["forms"]["mismatch"] for out in ranks[2]]
    assert all(m is not None and "codecs differ" in m for m in msgs), msgs
    assert len(set(msgs)) == 1
