"""The port's solve service (``serve/``, ``apps/solve_service.py``) against
the JAX package's, on the CPU.

* Spec functions — ``engine_key``, ``column_seed``, ``pricing``,
  ``estimate_dimension`` and the JSON — equal to JAX's for the same specs.
* Pricing: ``serve.capacity.price_job`` against ``tools/capacity.price_job``
  for every mode × solver kind × {no rates, synthetic rates}: the same
  keys and non-float values, floats within 1e-12 relative.
* Drain parity: the same queue drained by both schedulers packs the same
  batches and reaches the same statuses and pool builds; eigenvalues
  within 1e-10; ``done/`` records with the same keys and the same
  non-timing values, iteration counts included (residuals, which round
  differently, each under its job's bound).
* A spool written by one package is drained by the other.
* The JAX ``tests/test_serve.py`` behaviours on the port, and a real
  SIGTERM to the service process: exit 75 with the jobs still spooled,
  then a relaunch that drains them.
* Each solver's preemption safe point: ``Preempted`` at the same
  iteration count as the JAX solver on the same operator.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import distributed_matvec_tpu.parallel.engine as JE
import distributed_matvec_tpu.serve as jserve
import distributed_matvec_tpu.solve as jsolve
import distributed_matvec_tpu.utils.preempt as jpreempt
import distributed_matvec_tpu_torch.obs as tobs
import distributed_matvec_tpu_torch.serve as tserve
import distributed_matvec_tpu_torch.solve as tsolve
from distributed_matvec_tpu_torch import LocalEngine
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)
from distributed_matvec_tpu_torch.serve import capacity as tcap
from distributed_matvec_tpu_torch.utils import preempt

from test_operator import build_heisenberg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the synthetic rate calibration of tests/test_serve.py
RATES = {"gather_rows_per_s": 1e8, "h2d_bytes_per_s": 1e9,
         "flops_per_s": 1e9, "exchange_bytes_per_s": 1e9,
         "backend": "cpu", "device_kind": "synthetic",
         "source": "synthetic"}


def _jax_capacity():
    spec = importlib.util.spec_from_file_location(
        "dmt_capacity_ref", os.path.join(ROOT, "tools", "capacity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JCAP = _jax_capacity()


def _chain_syms(n):
    return [[[*range(1, n), 0], 0], [[*reversed(range(n))], 0]]


def _spec_kwargs(tmp_path):
    """Spec constructor arguments of every kind: name → kwargs."""
    ypath = tmp_path / "model.yaml"
    ypath.write_text("basis: {number_spins: 8, hamming_weight: 4}\n")
    sym12 = {"number_spins": 12, "hamming_weight": 6, "spin_inversion": 1,
             "symmetries": _chain_syms(12)}
    return {
        "symmetric": dict(basis=sym12, k=2, tol=1e-9),
        "symmetric_known_n": dict(basis=sym12, n_states=64, mode="streamed"),
        "unsymmetric": dict(basis={"number_spins": 10,
                                   "hamming_weight": 5}),
        "no_sector": dict(basis={"number_spins": 6}, mode="compact"),
        "edge_list": dict(basis={"number_spins": 8, "hamming_weight": 4},
                          edges=[[0, 1], [1, 2], [2, 3], [3, 0], [4, 5],
                                 [5, 6], [6, 7], [7, 4], [0, 4]],
                          mode="fused", n_devices=2),
        "yaml": dict(yaml=str(ypath)),
        "kpm": dict(basis=sym12, solver="kpm", n_moments=64, n_vectors=2),
        "evolve": dict(basis={"number_spins": 10, "hamming_weight": 5},
                       solver="evolve", t_final=0.5, krylov_dim=12,
                       tol=1e-10),
        "seeded": dict(basis={"number_spins": 8, "hamming_weight": 4},
                       seed=7, deadline_s=3.0, max_iters=50),
        "inversion_only": dict(basis={"number_spins": 10,
                                      "hamming_weight": 5,
                                      "spin_inversion": -1}),
    }


SPEC_NAMES = ["symmetric", "symmetric_known_n", "unsymmetric", "no_sector",
              "edge_list", "yaml", "kpm", "evolve", "seeded",
              "inversion_only"]


@pytest.fixture
def clean():
    tobs.reset_all()
    preempt.reset()
    yield
    tobs.reset_all()
    preempt.reset()


def _both(tmp_path, name, job_id="j"):
    kw = _spec_kwargs(tmp_path)[name]
    return (tserve.JobSpec(job_id=job_id, **kw),
            jserve.JobSpec(job_id=job_id, **kw))


# -- spec functions --------------------------------------------------------------

@pytest.mark.parametrize("name", SPEC_NAMES)
def test_spec_functions_equal_jax(name, tmp_path):
    t, j = _both(tmp_path, name, job_id=f"job-{name}")
    assert t.engine_key() == j.engine_key()
    assert t.column_seed() == j.column_seed()
    assert t.pricing() == j.pricing()
    assert t.to_json() == j.to_json()
    # JSON round trips across packages
    back_t = tserve.JobSpec.from_json(j.to_json())
    back_j = jserve.JobSpec.from_json(t.to_json())
    assert back_t.to_json() == back_j.to_json() == t.to_json()
    assert back_t.engine_key() == j.engine_key()
    if t.basis is not None:
        assert tserve.estimate_dimension(t.basis) \
            == jserve.estimate_dimension(j.basis)


def test_spec_validation_equal_jax():
    bad = [dict(), dict(basis={"number_spins": 4}, yaml="m.yaml"),
           dict(basis={"number_spins": 4}, solver="dmrg"),
           dict(basis={"number_spins": 4}, solver="kpm", n_moments=1),
           dict(basis={"number_spins": 4}, solver="evolve", t_final=0.0)]
    for kw in bad:
        with pytest.raises(ValueError) as et:
            tserve.JobSpec(job_id="x", **kw)
        with pytest.raises(ValueError) as ej:
            jserve.JobSpec(job_id="x", **kw)
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError):
        tserve.JobSpec(job_id="", basis={"number_spins": 4})


# -- pricing ---------------------------------------------------------------------

def _same_priced(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) and not isinstance(w, bool):
            assert isinstance(g, float), k
            assert g == pytest.approx(w, rel=1e-12, abs=0.0), k
        else:
            assert g == w, k


PRICE_SPECS = {
    "chain16_symm": dict(basis={"number_spins": 16, "hamming_weight": 8,
                                "spin_inversion": 1,
                                "symmetries": _chain_syms(16)},
                         n_states=107),
    "chain24": dict(basis={"number_spins": 24, "hamming_weight": 12},
                    k=3, max_iters=90),
    "chain32_symm": dict(basis={"number_spins": 32, "hamming_weight": 16,
                                "spin_inversion": 1,
                                "symmetries": _chain_syms(32)},
                         n_states=4_707_969, n_devices=4),
    "chain40": dict(basis={"number_spins": 40}),          # does not fit
}


@pytest.mark.parametrize("rates", ["none", "synthetic"])
@pytest.mark.parametrize("solver", ["eigs", "kpm", "evolve"])
@pytest.mark.parametrize("mode", ["ell", "compact", "streamed", "hybrid",
                                  "fused", "unknown"])
@pytest.mark.parametrize("spec", sorted(PRICE_SPECS))
def test_price_job_equals_jax(spec, mode, solver, rates):
    kw = dict(PRICE_SPECS[spec], mode=mode, solver=solver)
    pricing = tserve.JobSpec(job_id="p", **kw).pricing()
    cal = RATES if rates == "synthetic" else None
    for hbm, host in ((16.0, 64.0), (80.0, 96.0), (0.5, 1.0)):
        _same_priced(
            tcap.price_job(dict(pricing), calibration=cal, hbm_gb=hbm,
                           host_ram_gb=host),
            JCAP.price_job(dict(pricing), calibration=cal, hbm_gb=hbm,
                           host_ram_gb=host))


def test_plan_and_hybrid_model_equal_jax():
    for compress in ("off", "lossless", "f32", "bf16"):
        got = tcap.plan(1_000_003, 64, 32, False, 16.0, 2, 3, 4,
                        rates=RATES, stream_compress=compress,
                        group_order=128)
        want = JCAP.plan(1_000_003, 64, 32, False, 16.0, 2, 3, 4,
                         rates=RATES, stream_compress=compress,
                         group_order=128)
        assert json.dumps(got, sort_keys=True) \
            == json.dumps(want, sort_keys=True)
    hg = tcap.hybrid_split_model(10 ** 6, 40, False, 1, 4, RATES,
                                 "lossless")
    hw = JCAP.hybrid_split_model(10 ** 6, 40, False, 1, 4, RATES,
                                 "lossless")
    np.testing.assert_array_equal(hg["stream_mask"], hw["stream_mask"])
    np.testing.assert_allclose(hg["recompute_ms"], hw["recompute_ms"],
                               rtol=1e-12)


def test_rate_calibration_file(tmp_path):
    path = tmp_path / "rates.json"
    path.write_text(json.dumps(RATES))
    assert tcap.load_rate_calibration(str(path)) == RATES
    assert tcap.load_rate_calibration(None) is None
    with pytest.raises(FileNotFoundError):
        tcap.load_rate_calibration(str(tmp_path / "missing.json"))
    assert tcap.load_tuning() is None


# -- drain parity ----------------------------------------------------------------

DRAIN = [  # job_id, spins, k, tol
    ("d0", 10, 1, 1e-10), ("d1", 8, 2, 1e-9), ("d2", 10, 2, 1e-8),
    ("d3", 10, 1, 1e-9), ("d4", 8, 1, 1e-10), ("d5", 10, 3, 1e-10),
]
TIMING = ("finish_ts", "latency_ms")


def _drain_specs(pkg):
    out = []
    for i, (jid, n, k, tol) in enumerate(DRAIN):
        s = pkg.JobSpec(job_id=jid, k=k, tol=tol, max_iters=300,
                        basis={"number_spins": n, "hamming_weight": n // 2})
        s.submit_ts = 1000.0 + i
        out.append(s)
    return out


def _record_batches(sched):
    batches = []
    run = sched.run_batch

    def spy(batch):
        batches.append([s.job_id for s in batch])
        return run(batch)

    sched.run_batch = spy
    return batches


def test_drain_parity_with_jax(tmp_path, clean):
    jsched = jserve.Scheduler(queue=jserve.JobQueue(str(tmp_path / "j")),
                              rates=None, block_width=3)
    tsched = tserve.Scheduler(queue=tserve.JobQueue(str(tmp_path / "t")),
                              block_width=3, device="cpu")
    for s in _drain_specs(jserve):
        jsched.submit(s)
    for s in _drain_specs(tserve):
        tsched.submit(s)
    jb, tb = _record_batches(jsched), _record_batches(tsched)
    assert tsched.drain(scan_spool=False) == jsched.drain(
        scan_spool=False) == len(DRAIN)
    assert tb == jb
    assert tsched.pool.builds == jsched.pool.builds == 2
    assert tsched.pool.hits == jsched.pool.hits
    for jid, _, k, tol in DRAIN:
        with open(tmp_path / "j" / "done" / f"{jid}.json") as f:
            want = json.load(f)
        with open(tmp_path / "t" / "done" / f"{jid}.json") as f:
            got = json.load(f)
        assert set(got) == set(want)
        assert got["status"] == want["status"] == "done"
        np.testing.assert_allclose(got["eigenvalues"], want["eigenvalues"],
                                   rtol=1e-10, atol=0)
        assert len(got["eigenvalues"]) == k
        w = np.abs(got["eigenvalues"])
        assert np.all(np.asarray(got["residuals"])
                      < tol * np.maximum(1.0, w))
        assert got["iters"] == want["iters"], jid
        for key in set(want) - set(TIMING) - {"eigenvalues", "residuals",
                                              "iters"}:
            assert got[key] == want[key], key


def test_batched_eigenvalues_match_solo_solves(clean):
    """Each batched job's eigenvalues equal a solo ``lanczos_block`` on
    the same engine seeded by the job's ``column_seed`` (the JAX test's
    check, here to 1e-12 relative)."""
    sched = tserve.Scheduler(device="cpu")
    specs = [tserve.JobSpec(job_id=f"e{i}", k=k, tol=tol,
                            basis={"number_spins": 10,
                                   "hamming_weight": 5})
             for i, (k, tol) in enumerate([(1, 1e-10), (2, 1e-9),
                                           (1, 1e-8)])]
    for s in specs:
        assert sched.submit(s)["verdict"] == "accept"
    assert sched.drain(scan_spool=False) == 3
    assert sched.pool.builds == 1
    eng = sched.pool.acquire(specs[0])
    for s in specs:
        rec = sched.queue.result(s.job_id)
        assert rec["status"] == "done" and rec["batch_width"] == 3
        solo = tsolve.lanczos_block(eng.matvec, n=eng.n_states, k=s.k,
                                    tol=s.tol, max_iters=s.max_iters,
                                    seed=s.column_seed(), device="cpu")
        for w_b, w_s in zip(rec["eigenvalues"], solo.eigenvalues):
            assert abs(w_b - w_s) <= 1e-12 * abs(w_s)


def test_dynamics_jobs_match_direct_calls(clean):
    """kpm and evolve jobs ride the eigs job's warm engine (pool hits),
    and their results equal the solvers called directly with the job's
    seed."""
    basis = {"number_spins": 10, "hamming_weight": 5}
    sched = tserve.Scheduler(device="cpu")
    sched.submit(tserve.JobSpec(job_id="g0", basis=basis))
    kpm = tserve.JobSpec(job_id="g1", basis=basis, solver="kpm",
                         n_moments=32, n_vectors=2)
    evo = tserve.JobSpec(job_id="g2", basis=basis, solver="evolve",
                         t_final=0.25, krylov_dim=12, tol=1e-10)
    sched.submit(kpm)
    sched.submit(evo)
    assert sched.drain(scan_spool=False) == 3
    assert (sched.pool.builds, sched.pool.hits) == (1, 2)
    eng = sched.pool.acquire(kpm)
    rk = sched.queue.result("g1")
    _, _, res = tsolve.kpm_dos(eng.matvec, n_moments=32, n=eng.n_states,
                               n_vectors=2, seed=kpm.column_seed(),
                               device="cpu")
    np.testing.assert_allclose(rk["moments_head"], res.moments[:8],
                               rtol=0, atol=1e-12)
    assert rk["status"] == "done" and rk["moments_per_s"] >= 0
    re_ = sched.queue.result("g2")
    ev = tsolve.krylov_evolve(eng.matvec, t_final=0.25, n=eng.n_states,
                              krylov_dim=12, tol=1e-10,
                              seed=evo.column_seed(), device="cpu")
    assert re_["status"] == "done" and re_["converged"]
    assert re_["steps"] == ev.num_steps
    assert abs(re_["energy_final"] - ev.energies[-1]) < 1e-12


# -- cross-package spools --------------------------------------------------------

def test_jax_spool_drains_in_the_port(tmp_path, clean):
    d = str(tmp_path / "spool")
    for i in range(3):
        jserve.submit_to_spool(d, jserve.JobSpec(
            job_id=f"x{i}", basis={"number_spins": 8, "hamming_weight": 4},
            k=1 + i % 2))
    assert tserve.SolveService(d, device="cpu").run(drain=True) == 0
    assert os.listdir(os.path.join(d, "queue")) == []
    for i in range(3):
        with open(os.path.join(d, "done", f"x{i}.json")) as f:
            rec = json.load(f)
        assert rec["status"] == "done" and len(rec["eigenvalues"]) \
            == 1 + i % 2
        assert jserve.JobSpec.from_json(json.dumps(rec["spec"])).job_id \
            == f"x{i}"


def test_port_spool_drains_in_jax(tmp_path, clean):
    d = str(tmp_path / "spool")
    for i in range(2):
        tserve.submit_to_spool(d, tserve.JobSpec(
            job_id=f"y{i}", basis={"number_spins": 8, "hamming_weight": 4}))
    assert jserve.SolveService(d, rates=None).run(drain=True) == 0
    assert sorted(os.listdir(os.path.join(d, "done"))) \
        == ["y0.json", "y1.json"]
    assert os.listdir(os.path.join(d, "queue")) == []


# -- the JAX test_serve.py behaviours, on the port --------------------------------

def _chain(job_id, n=10, **kw):
    kw.setdefault("basis", {"number_spins": n, "hamming_weight": n // 2})
    return tserve.JobSpec(job_id=job_id, **kw)


def test_spool_roundtrip_and_service_drain(tmp_path, clean):
    d = str(tmp_path / "spool")
    for i in range(3):
        tserve.submit_to_spool(d, _chain(f"sp{i}", n=8))
    assert tserve.SolveService(d, device="cpu").run(drain=True) == 0
    assert sorted(os.listdir(os.path.join(d, "done"))) \
        == ["sp0.json", "sp1.json", "sp2.json"]
    evs = tobs.events("serve_end")
    assert evs and evs[-1]["engine_builds"] == 1


def test_sigterm_drain_requeues_in_flight(tmp_path, clean):
    d = str(tmp_path / "spool")
    for i in range(2):
        tserve.submit_to_spool(d, _chain(f"pre{i}"))
    preempt.trigger()
    try:
        rc = tserve.SolveService(d, device="cpu").run(drain=True)
    finally:
        preempt.reset()
    assert rc == preempt.EXIT_PREEMPTED == 75
    assert sorted(os.listdir(os.path.join(d, "queue"))) \
        == ["pre0.json", "pre1.json"]
    assert os.listdir(os.path.join(d, "done")) == []
    assert tserve.SolveService(d, device="cpu").run(drain=True) == 0
    assert sorted(os.listdir(os.path.join(d, "done"))) \
        == ["pre0.json", "pre1.json"]


class _PreemptingEngine:
    """Dense stand-in engine whose matvec latches a preemption after a
    few applies: the signal lands MID-BATCH."""

    def __init__(self, n=24, seed=5, at_call=3):
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((n, n))
        self.A = torch.from_numpy((A + A.T) / 2)
        self.n_states = n
        self.calls = 0
        self.at_call = at_call

    def matvec(self, X):
        self.calls += 1
        if self.calls == self.at_call:
            preempt.trigger()
        return self.A @ X


def test_mid_solve_preemption_requeues_batch(clean):
    pool = tserve.EnginePool(builder=lambda s: _PreemptingEngine(),
                             device="cpu")
    sched = tserve.Scheduler(pool=pool)
    sched.submit(_chain("mid1"))
    sched.submit(_chain("mid2"))
    with pytest.raises(preempt.Preempted) as e:
        sched.drain(scan_spool=False)
    assert e.value.solver == "lanczos_block"
    assert {s.job_id for s in sched.queue.queued()} == {"mid1", "mid2"}
    assert sched.queue.running() == []
    pre = tobs.events("solver_preempted")
    assert pre and pre[-1]["solver"] == "lanczos_block"


def test_failed_batch_marks_jobs_failed(clean):
    pool = tserve.EnginePool(builder=lambda s: (_ for _ in ()).throw(
        RuntimeError("boom")), device="cpu")
    sched = tserve.Scheduler(pool=pool)
    sched.submit(_chain("f1", n=8))
    assert sched.drain(scan_spool=False) == 1
    rec = sched.queue.result("f1")
    assert rec["status"] == "failed" and "boom" in rec["error"]


def test_yaml_spec_fails_and_service_goes_on(tmp_path, clean):
    """A yaml spec is keyed as JAX keys it, but its engine needs the
    port's YAML loader: the job is recorded failed, the next one runs."""
    d = str(tmp_path / "spool")
    ypath = tmp_path / "model.yaml"
    ypath.write_text("basis: {number_spins: 8}\n")
    y = tserve.JobSpec(job_id="yml", yaml=str(ypath))
    y.submit_ts = 1.0
    ok = _chain("after", n=8)
    ok.submit_ts = 2.0
    tserve.submit_to_spool(d, y)
    tserve.submit_to_spool(d, ok)
    assert tserve.SolveService(d, device="cpu").run(drain=True) == 0
    with open(os.path.join(d, "done", "yml.json")) as f:
        rec = json.load(f)
    assert rec["status"] == "failed"
    assert "NotImplementedError" in rec["error"] and "YAML" in rec["error"]
    with open(os.path.join(d, "done", "after.json")) as f:
        assert json.load(f)["status"] == "done"


def test_spool_write_failure_does_not_resolve_forever(tmp_path, clean):
    d = str(tmp_path / "spool")
    queue = tserve.JobQueue(d)
    sched = tserve.Scheduler(queue=queue, device="cpu")
    tserve.submit_to_spool(d, _chain("wf1", n=8))
    sched.adopt_spool()
    ddir = os.path.join(d, "done")
    os.rmdir(ddir)
    with open(ddir, "w") as f:
        f.write("x")
    assert sched.drain(scan_spool=False) == 1
    assert queue.status("wf1") == "done"
    assert os.path.exists(os.path.join(d, "queue", "wf1.json"))
    assert sched.adopt_spool() == 0
    assert queue.status("wf1") == "done"
    failed = [e for e in tobs.events("job_event")
              if e.get("status") == "spool_write_failed"]
    assert failed
    os.remove(ddir)
    os.makedirs(ddir)
    assert sched.adopt_spool() == 0
    assert os.path.exists(os.path.join(ddir, "wf1.json"))
    assert not os.path.exists(os.path.join(d, "queue", "wf1.json"))


def test_unreadable_spool_file_reported_once(tmp_path, clean):
    d = str(tmp_path / "spool")
    queue = tserve.JobQueue(d)
    bad = os.path.join(d, "queue", "torn.json")
    with open(bad, "w") as f:
        f.write("{not json")
    for _ in range(3):
        assert queue.scan_spool() == 0
    evs = [e for e in tobs.events("job_event")
           if e.get("status") == "unreadable"]
    assert len(evs) == 1
    with open(bad, "w") as f:
        f.write(_chain("torn", n=8).to_json())
    assert queue.scan_spool() == 1


def test_spool_resubmission_runs_again(tmp_path, clean):
    d = str(tmp_path / "spool")
    queue = tserve.JobQueue(d)
    sched = tserve.Scheduler(queue=queue, device="cpu")
    tserve.submit_to_spool(d, _chain("re1", n=8, k=1))
    assert sched.adopt_spool() == 1
    assert sched.drain(scan_spool=False) == 1
    tserve.submit_to_spool(d, _chain("re1", n=8, k=2))
    assert sched.adopt_spool() == 1
    assert queue.status("re1") == "queued"
    sched.drain(scan_spool=False)
    rec = queue.result("re1")
    assert rec["status"] == "done" and len(rec["eigenvalues"]) == 2


def test_admission_accept_queue_reject(clean):
    sched = tserve.Scheduler(rates=RATES, hbm_gb=16.0, accept_horizon_s=0.0,
                             device="cpu")
    v1 = sched.submit(_chain("j1", n=16))
    assert v1["verdict"] == "accept" and v1["eta_s"] == 0.0
    v2 = sched.submit(_chain("j2", n=16))
    assert v2["verdict"] == "queue" and v2["eta_s"] > 0.0
    assert sched.queue.status("j2") == "queued"
    v3 = sched.submit(_chain("j3", n=64))
    assert v3["verdict"] == "reject"
    assert sched.queue.status("j3") == tserve.REJECTED
    assert "reason" in sched.queue.result("j3")
    v4 = sched.submit(_chain("j4", n=16, deadline_s=1e-9))
    assert v4["verdict"] == "reject"
    assert "deadline" in sched.queue.result("j4")["reason"]
    verdicts = [e["verdict"] for e in tobs.events("admission")]
    assert verdicts == ["accept", "queue", "reject", "reject"]


def test_scheduler_adopts_spool_and_rejects_unfit(tmp_path, clean):
    d = str(tmp_path / "spool")
    tserve.submit_to_spool(d, _chain("ok", n=8))
    tserve.submit_to_spool(d, _chain("nofit", n=64))
    sched = tserve.Scheduler(queue=tserve.JobQueue(d), rates=RATES,
                             device="cpu")
    assert sched.adopt_spool() == 2
    assert sched.queue.status("nofit") == tserve.REJECTED
    assert sched.queue.status("ok") == "queued"
    assert os.path.exists(os.path.join(d, "done", "nofit.json"))


def test_fingerprint_grouping_and_packing(clean):
    sched = tserve.Scheduler(block_width=2, device="cpu")
    for i, n in enumerate((10, 10, 8, 10, 8, 10)):
        s = _chain(f"j{i}", n=n)
        s.submit_ts = 100.0 + i
        sched.queue.submit(s)
    b1 = sched.next_batch()
    assert [s.job_id for s in b1] == ["j0", "j1"]
    for s in b1:
        sched.queue.finish(s, tserve.DONE)
    b2 = sched.next_batch()
    assert [s.job_id for s in b2] == ["j2", "j4"]
    for s in b2:
        sched.queue.finish(s, tserve.DONE)
    assert [s.job_id for s in sched.next_batch()] == ["j3", "j5"]


class _FakeEngine:
    def __init__(self, nbytes):
        self.ell_nbytes = int(nbytes)


def test_pool_lru_eviction_under_byte_budget(clean):
    built = []

    def builder(spec):
        built.append(spec.job_id)
        return _FakeEngine(4 * 1024)

    pool = tserve.EnginePool(max_bytes=10 * 1024, builder=builder,
                             device="cpu")
    s1, s2, s3 = _chain("p1", n=8), _chain("p2", n=10), _chain("p3", n=12)
    e1 = pool.acquire(s1)
    assert pool.acquire(s1) is e1
    assert built == ["p1"] and pool.hits == 1
    pool.acquire(s2)
    assert pool.total_bytes() == 8 * 1024 and len(pool) == 2
    pool.acquire(s1)
    pool.acquire(s3)
    assert pool.evictions == 1
    assert s2.engine_key() not in pool
    assert s1.engine_key() in pool and s3.engine_key() in pool
    pool.acquire(s2)
    assert built == ["p1", "p2", "p3", "p2"]
    ev = tobs.events("engine_pool")[-1]
    assert (ev["builds"], ev["hits"], ev["evictions"]) == (4, 2, 2)
    # a single engine over the budget serves its batch, and goes on the
    # next insertion
    big = tserve.EnginePool(max_bytes=1, device="cpu",
                            builder=lambda s: _FakeEngine(1 << 20))
    eng = big.acquire(_chain("big", n=8))
    assert len(big) == 1 and big.acquire(_chain("big", n=8)) is eng
    big.acquire(_chain("other", n=10))
    assert len(big) == 1 and big.evictions == 1


def test_pool_rebuilds_past_the_live_devices(clean):
    """A warm engine whose shard count exceeds the live devices is
    dropped and rebuilt clamped (the spec asked for 2 shards; the pool
    serves 1 device)."""
    pool = tserve.EnginePool(device="cpu", live_devices=2)
    spec = _chain("m1", n=8, mode="streamed", n_devices=2)
    eng = pool.acquire(spec)
    assert eng.n_devices == 2
    pool.live_devices = 1
    eng2 = pool.acquire(spec)
    assert eng2 is not eng and eng2.n_devices == 1
    assert pool.evictions == 1
    assert tobs.events("engine_clamp")[-1]["live_devices"] == 1


def test_job_events_and_per_job_spans(clean):
    sched = tserve.Scheduler(device="cpu")
    sched.submit(_chain("t1", n=8))
    sched.submit(_chain("t2", n=8, k=2))
    sched.drain(scan_spool=False)
    for jid in ("t1", "t2"):
        evs = [e for e in tobs.events("job_event") if e["job_id"] == jid]
        assert [e["status"] for e in evs] == ["queued", "running", "done"]
    batch, = [e for e in tobs.events("span") if e.get("cat") == "batch"]
    jobs_ = [e for e in tobs.events("span") if e.get("cat") == "job"]
    assert sorted(e["name"] for e in jobs_) == ["job:t1", "job:t2"]
    for e in jobs_:
        assert e["parent_span_id"] == batch["span_id"]
        assert e["job_id"] == e["name"][len("job:"):]
        assert e["dur_ms"] > 0


def test_service_app_sigterm_then_relaunch(tmp_path):
    """The service process under a real SIGTERM: exit 75 with both jobs
    still spooled under ``queue/`` and ``done/`` empty; the same argv
    again drains them (exit 0)."""
    d = tmp_path / "spool"
    run = tmp_path / "run"
    for i in range(2):
        tserve.submit_to_spool(str(d), _chain(f"sig{i}", n=20, k=1,
                                              tol=1e-12))
    argv = [sys.executable, "-m",
            "distributed_matvec_tpu_torch.apps.solve_service", str(d),
            "--drain", "--device", "cpu", "--obs-dir", str(run)]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    env.pop("DMT_OBS", None)
    proc = subprocess.Popen(argv, env=env, cwd=ROOT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    events = run / "rank_0" / "events.jsonl"
    deadline = time.monotonic() + 120
    try:
        while time.monotonic() < deadline:
            if events.exists() and '"status": "running"' \
                    in events.read_text():
                break
            assert proc.poll() is None, proc.communicate()[0]
            time.sleep(0.02)
        else:
            pytest.fail("no running job_event within 120 s")
        t_sig = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        stop_s = time.monotonic() - t_sig
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 75, out
    assert sorted(os.listdir(d / "queue")) == ["sig0.json", "sig1.json"]
    assert os.listdir(d / "done") == []
    assert stop_s < 60
    kinds = [json.loads(ln) for ln in events.read_text().splitlines()]
    pre = [e for e in kinds if e["kind"] == "serve_preempted"]
    assert pre and pre[-1]["exit_code"] == 75
    again = subprocess.run(argv, env=env, cwd=ROOT, capture_output=True,
                           text=True, timeout=300)
    assert again.returncode == 0, again.stdout + again.stderr
    assert sorted(os.listdir(d / "done")) == ["sig0.json", "sig1.json"]
    for i in range(2):
        with open(d / "done" / f"sig{i}.json") as f:
            rec = json.load(f)
        assert rec["status"] == "done"


# -- the solvers' safe points ----------------------------------------------------

SYMS_12 = [([*range(1, 12), 0], 0), ([*reversed(range(12))], 0)]


@pytest.fixture(scope="module")
def chain12():
    op_j = build_heisenberg(12, 6, 1, SYMS_12)
    op_j.basis.build()
    op_t = operator_from_reference(operator_arrays(op_j), device="cpu")
    return JE.LocalEngine(op_j), LocalEngine(op_t, device="cpu")


def _latching(mv, mod, at):
    """``mv`` that sets ``mod``'s preemption latch at its ``at``-th
    call."""
    calls = {"n": 0}

    def f(x):
        calls["n"] += 1
        if calls["n"] == at:
            mod.trigger()
        return mv(x)
    return f


def _solves(n, mod_solve, port, tmp_path):
    """name → callable(matvec) for each solver, in the JAX package
    (``port=False``) or the port."""
    dev = {"device": "cpu"} if port else {}
    return {
        "lanczos": lambda mv: mod_solve.lanczos(
            mv, n=n, k=1, tol=1e-14, max_iters=200, seed=3, **dev),
        "lanczos_block": lambda mv: mod_solve.lanczos_block(
            mv, n=n, k=2, block_size=2, tol=1e-14, max_iters=200, seed=3,
            **dev),
        "lobpcg": lambda mv: mod_solve.lobpcg(
            mv, n, k=2, max_iters=60, tol=1e-14, seed=3, **dev),
        "kpm": lambda mv: mod_solve.kpm_moments(
            mv, n_moments=32, n=n, n_vectors=2, bounds=(-30.0, 12.0),
            seed=3, **dev),
        "evolve": lambda mv: mod_solve.krylov_evolve(
            mv, t_final=0.5, n=n, krylov_dim=8, seed=3, **dev),
    }


#: (solver, the matvec call that sets the latch).  The JAX ``lanczos``
#: traces its 16-step block into one program, calling the Python matvec
#: only while tracing it (three calls), so its latch is set within the
#: first block; the other JAX solvers call it once per apply.  ``lobpcg``
#: without a checkpoint has no safe point in either package (below)
SAFE_POINT_CASES = [("lanczos", 1), ("lanczos", 3)] + [
    (solver, at) for solver in ("lanczos_block", "kpm", "evolve")
    for at in (1, 3, 11)]


@pytest.mark.parametrize("solver,at", SAFE_POINT_CASES)
def test_solver_safe_points_equal_jax(solver, at, chain12, tmp_path):
    """With the latch set at the ``at``-th matvec call, each port solver
    raises ``Preempted`` at its safe point with the JAX solver's iteration
    count on the same operator (the port writes no checkpoint)."""
    ej, et = chain12
    n = et.n_states
    got = want = None
    try:
        _solves(n, jsolve, False, tmp_path)[solver](
            _latching(ej.matvec, jpreempt, at))
    except jpreempt.Preempted as e:
        want = (e.solver, e.iters)
    finally:
        jpreempt.reset()
    try:
        _solves(n, tsolve, True, tmp_path)[solver](
            _latching(et.matvec, preempt, at))
    except preempt.Preempted as e:
        got = (e.solver, e.iters)
        assert e.checkpoint_path is None
    finally:
        preempt.reset()
    assert want is not None
    assert got == want


@pytest.mark.parametrize("at", [1, 3, 11])
def test_lobpcg_without_segments_has_no_safe_point(at, chain12, tmp_path):
    """Like the JAX solver without a checkpoint, a one-shot ``lobpcg``
    runs through a latch set at the ``at``-th matvec call, to the JAX
    solver's eigenvalues and iteration count."""
    ej, et = chain12
    n = et.n_states
    try:
        want = _solves(n, jsolve, False, tmp_path)["lobpcg"](
            _latching(ej.matvec, jpreempt, at))
    finally:
        jpreempt.reset()
    try:
        got = _solves(n, tsolve, True, tmp_path)["lobpcg"](
            _latching(et.matvec, preempt, at))
        assert preempt.requested()
    finally:
        preempt.reset()
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-10)
    assert got[2] == want[2]


def test_dynamics_results_carry_rates(chain12):
    _, et = chain12
    res = tsolve.kpm_moments(et.matvec, n_moments=32, n=et.n_states,
                             n_vectors=2, bounds=(-30.0, 12.0),
                             device="cpu")
    assert res.first_block_moments == 2 and res.resumed_from == 0
    assert res.first_block_seconds > 0 and res.steady_seconds > 0
    assert res.steady_moments_per_s == pytest.approx(
        30 / res.steady_seconds)
    ev = tsolve.krylov_evolve(et.matvec, t_final=0.25, n=et.n_states,
                              krylov_dim=24, tol=1e-10, device="cpu")
    assert ev.resumed_from == 0 and ev.first_step_seconds > 0
    if ev.num_steps > 1:
        assert ev.steady_steps_per_s == pytest.approx(
            (ev.num_steps - 1) / ev.steady_seconds)


def test_serve_over_two_ranks(tmp_path):
    """JAX ``tests/test_serve.py::test_multihost_serve_two_ranks`` on the
    port: two gloo ranks (``torch_rank_worker.py ... serve``) drain two
    same-basis ell jobs through ``EnginePool(group=)`` one per batch —
    on each rank builds 1, hits 1 and one ``engine_init``, both jobs done
    with the 12-ring's E0, the same bits on both ranks."""
    import subprocess
    import sys as _sys

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_rank_worker.py")
    root = os.path.dirname(os.path.dirname(worker))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    for k in ("DMT_OBS_DIR", "DMT_OBS"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [_sys.executable, worker, str(r), "2",
         f"file://{tmp_path / 'rendezvous'}", str(tmp_path), "serve"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=root) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    got = []
    for r, (p, log) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
        rec = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert rec["jax_imported"] == []
        got.append(rec["serve"])
    for s in got:
        assert s["done"] == 2 and s["statuses"] == ["done", "done"]
        assert (s["builds"], s["hits"], s["evictions"]) == (1, 1, 0)
        assert s["engine_init"] == 1
        assert s["live"] == 2
        assert s["pool_events"].count("build") == 1
        assert s["pool_events"].count("hit") == 1
        for e0 in s["e0"]:
            assert e0 / 4 == pytest.approx(-5.3873909174, abs=1e-7)
    assert got[0]["e0"] == got[1]["e0"]
