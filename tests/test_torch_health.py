"""The port's health layer (``obs/health.py``) against the JAX package's.

* ``omega_estimate`` equals the JAX function on the same ``alph``/``bet``
  (rel 1e-14), healthy and near breakdown;
* the apply probes: a NaN planted in x gives one critical
  ``nonfinite_output`` event at the next apply's drain (the JAX event's
  fields), ``DMT_HEALTH=strict`` raises ``HealthError`` from the apply,
  and the probes add no ``.item()``, no implicit tensor → Python read and
  no ``synchronize()`` to an apply (counted with the probes on and off);
* the drain resolves only probes whose copy has landed and defers the rest;
* the exchange counters ride the queue in fused and streamed mode;
* the compress-drift probe on a bf16 engine with a non-bf16-exact
  coupling: the same relative error as the JAX engine's probe on the same
  chunk (rel 1e-12);
* the solver watchdog (the JAX cases), a healthy Lanczos with
  ``health_every=1`` emitting no warn/critical event in either package,
  the ``selective_reorth_fallback`` info event, and LOBPCG's nonfinite
  eigenvalues.
"""

import sys

import numpy as np
import pytest
import torch

from distributed_matvec_tpu import obs as jax_obs
from distributed_matvec_tpu.obs import health as JH
from distributed_matvec_tpu_torch import (DistributedEngine, LocalEngine,
                                          lanczos, obs)
from distributed_matvec_tpu_torch.obs import health as H
from distributed_matvec_tpu_torch.solve.lanczos import _Watchdog
from distributed_matvec_tpu_torch.utils.config import update_config

from test_torch_solvers import Case


@pytest.fixture
def clean_obs(monkeypatch):
    monkeypatch.delenv("DMT_HEALTH", raising=False)
    obs.reset_all()
    jax_obs.reset_all()
    saved = update_config().health_every
    update_config(health_every=1)
    yield monkeypatch
    update_config(health_every=saved)
    obs.reset_all()
    jax_obs.reset_all()


@pytest.fixture(scope="module")
def case():
    return Case(12, 6, 1, [([*range(1, 12), 0], 0)], streamed=False)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("broken", [None, 40, 5])
def test_omega_estimate_equals_jax(seed, broken):
    rng = np.random.default_rng(seed)
    alph = rng.normal(0.0, 1.0, 64)
    bet = np.abs(rng.normal(1.0, 0.1, 64)) + 0.5
    if broken is not None:
        bet[broken] = 1e-13
    for lo, m in ((0, 64), (17, 48), (63, 64), (10, 10)):
        want = JH.omega_estimate(alph, bet, lo, m)
        got = H.omega_estimate(alph, bet, lo, m)
        assert got == pytest.approx(want, rel=1e-14, abs=0.0)
    if broken == 40:
        assert H.omega_estimate(alph, bet, 0, 64) >= H.OMEGA_CRITICAL
    if broken is None:
        assert H.omega_estimate(alph, bet, 0, 64) < H.OMEGA_WARN


def test_probe_nan_event_at_next_drain_and_strict(clean_obs, case):
    eng = LocalEngine(case.op_t, device="cpu")
    x = torch.randn(case.n, dtype=torch.float64)
    x[3] = float("nan")
    eng.matvec(x)
    # queued, not read inline
    assert obs.events("health") == []
    assert H.pending_count() == 1
    eng.matvec(torch.zeros(case.n, dtype=torch.float64))
    evs = obs.events("health")
    assert len(evs) == 1
    ev = evs[0]
    assert ev["check"] == "nonfinite_output" and ev["level"] == "critical"
    assert ev["engine"] == "local" and ev["apply"] == 0 and ev["rank"] == 0
    assert ev["count"] >= 1 and ev["source"] == "matvec_probe"
    snap = obs.snapshot()
    assert snap["counters"]["matvec_nonfinite{engine=local}"] >= 1
    assert snap["counters"]["health_events{level=critical}"] == 1
    clean_obs.setenv("DMT_HEALTH", "strict")
    with pytest.raises(H.HealthError, match="nonfinite_output"):
        eng.matvec(x)


class _Counter:
    """Counts the calls that read a tensor's value back to Python or wait
    for the device."""

    NAMES = ("item", "__bool__", "__int__", "__float__", "tolist")

    def __init__(self, monkeypatch):
        self.n = 0
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def wrapped(t, *a, _orig=orig, _name=name, **k):
                self.n += 1
                return _orig(t, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, wrapped)
        for mod, name in ((torch.cuda, "synchronize"),
                          (torch.cuda.Stream, "synchronize"),
                          (torch.cuda.Event, "synchronize")):
            orig = getattr(mod, name)

            def wrapped_sync(*a, _orig=orig, **k):
                self.n += 1
                return _orig(*a, **k)

            monkeypatch.setattr(mod, name, wrapped_sync)


@pytest.mark.parametrize("mode", ["ell", "streamed", "fused"])
def test_probes_add_no_sync_and_no_item(clean_obs, case, mode):
    """The reads and waits of three applies with the probes on (every
    apply probed and drained) equal those with the probes off."""
    if mode == "ell":
        eng = LocalEngine(case.op_t, device="cpu")
        x = torch.randn(case.n, dtype=torch.float64)
    else:
        eng = DistributedEngine(case.op_t, n_devices=2, mode=mode,
                                batch_size=32, stream_compress="lossless",
                                device="cpu")
        x = eng.random_hashed(2)
    eng.matvec(x)                          # first-apply checks out of the way

    def count(health):
        clean_obs.setenv("DMT_HEALTH", health)
        with pytest.MonkeyPatch.context() as mp:
            c = _Counter(mp)
            for _ in range(3):
                eng.matvec(x)
        return c.n

    off = count("off")
    on = count("on")
    assert on == off
    engine = "local" if mode == "ell" else "distributed"
    assert obs.snapshot()["counters"][
        f"matvec_nonfinite{{engine={engine}}}"] == 0


class _FakeEvent:
    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


def test_drain_defers_unlanded_copies(clean_obs):
    """Only items whose event reports the copy landed resolve; the rest
    stay queued (``block=True`` waits for them)."""
    ready = ("probe", {"engine": "e", "apply": 0}, ("nonfinite", "norm"),
             torch.tensor([0.0, 2.0]), _FakeEvent(True))
    late = ("probe", {"engine": "e", "apply": 1}, ("nonfinite", "norm"),
            torch.tensor([1.0, 3.0]), _FakeEvent(False))
    H._pending.extend([late, ready])
    H.drain()
    assert H.pending_count() == 1            # the late copy waits
    assert obs.events("health") == []        # the landed one was healthy
    H.drain()
    assert H.pending_count() == 1
    H.drain(block=True)
    assert H.pending_count() == 0
    assert [e["apply"] for e in obs.events("health")] == [1]


@pytest.mark.parametrize("mode", ["fused", "streamed"])
def test_exchange_counters_ride_the_queue(clean_obs, case, mode):
    eng = DistributedEngine(case.op_t, n_devices=2, mode=mode,
                            batch_size=32, stream_compress="lossless",
                            device="cpu")
    xh = eng.random_hashed(1)
    for _ in range(2):
        eng.matvec(xh)
    snap = obs.snapshot()["counters"]
    assert snap["exchange_overflow{engine=distributed}"] == 0
    assert snap["exchange_invalid{engine=distributed}"] == 0


def test_compress_drift_equals_jax(clean_obs):
    """A bf16 streamed engine whose coupling (0.3) is not bf16-exact: the
    drift probe's relative error equals the JAX engine's on the same
    probe chunk and input."""
    from distributed_matvec_tpu.models.basis import SpinBasis
    from distributed_matvec_tpu.models.lattices import (
        chain_edges, heisenberg_from_edges)
    from distributed_matvec_tpu.parallel.distributed import \
        DistributedEngine as JaxEngine
    from distributed_matvec_tpu.utils.config import \
        update_config as jax_update
    from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                      operator_from_reference)

    op_j = heisenberg_from_edges(
        SpinBasis(12, 6, 1, [([*range(1, 12), 0], 0)]), chain_edges(12),
        coupling=0.3)
    op_j.basis.build()
    op_t = operator_from_reference(operator_arrays(op_j), device="cpu")
    x = np.random.default_rng(4).standard_normal(op_j.basis.number_states)
    eng = DistributedEngine(op_t, mode="streamed", stream_compress="bf16",
                            batch_size=32, device="cpu")
    eng.matvec(eng.to_hashed(x))
    H.drain(block=True)
    got = [e["rel_err"] for e in obs.events("compress_drift")]
    jax_update(health_every=1, stream_compress="bf16")
    try:
        jeng = JaxEngine(op_j, n_devices=1, mode="streamed", batch_size=32)
        jeng.matvec(jeng.to_hashed(x))
    finally:
        jax_update(stream_compress="off")
    jax_obs.drain_health()
    want = [e["rel_err"] for e in jax_obs.events("compress_drift")]
    assert len(got) == len(want) == 1
    assert got[0] > 1e-5
    assert got[0] == pytest.approx(want[0], rel=1e-12)


def test_solver_watchdog_events_and_strict(clean_obs):
    wd = _Watchdog("lanczos")
    wd.breakdown(10, 1e-16, converged=True)
    assert obs.events("solver_health") == []
    wd.breakdown(10, 1e-16, converged=False)
    ev = obs.events("solver_health")[-1]
    assert ev["check"] == "beta_breakdown" and ev["level"] == "critical"
    assert ev["solver"] == "lanczos" and ev["rank"] == 0
    wd2 = _Watchdog("lanczos")
    for _ in range(_Watchdog.STALL_CHECKS + 1):
        wd2.check_stagnation(np.array([1e-3]), 1)
    stalls = [e for e in obs.events("solver_health")
              if e["check"] == "ritz_stagnation"]
    assert stalls and stalls[-1]["level"] == "warn"
    wd2.check_stagnation(np.array([np.nan]), 2)
    assert obs.events("solver_health")[-1]["check"] == "nonfinite_residual"
    wd2.report_omega(1e-6, 3)
    assert obs.events("solver_health")[-1]["level"] == "warn"
    clean_obs.setenv("DMT_HEALTH", "strict")
    with pytest.raises(H.HealthError, match="beta_breakdown"):
        wd.breakdown(11, 1e-16, converged=False)


@pytest.mark.parametrize("reorth", ["selective", "full"])
def test_healthy_lanczos_has_no_health_events(clean_obs, case, reorth):
    """A healthy solve with every apply probed: no warn/critical event in
    the port, as in the JAX solver on the same operator, the same E0."""
    from distributed_matvec_tpu.solve import lanczos as jax_lanczos
    from distributed_matvec_tpu.utils.config import \
        update_config as jax_update

    eng = LocalEngine(case.op_t, device="cpu")
    r = lanczos(eng.matvec, case.n, k=1, tol=1e-10, reorth=reorth,
                device="cpu")
    assert H.health_event_count() == 0
    assert obs.snapshot()["counters"]["matvec_nonfinite{engine=local}"] == 0
    jax_update(health_every=1, lanczos_reorth=reorth)
    try:
        rj = jax_lanczos(case.jl.matvec, case.n, k=1, tol=1e-10)
    finally:
        jax_update(lanczos_reorth="selective")
    assert JH.health_event_count() == 0
    assert r.eigenvalues[0] == pytest.approx(rj.eigenvalues[0], rel=1e-10)


def test_selective_fallback_info_event(clean_obs, case, monkeypatch):
    """A window block redone with the full sweep is an info-level
    ``solver_health`` event (the JAX event), never a warning."""
    monkeypatch.setattr(sys.modules[_Watchdog.__module__],
                        "_OMEGA_SQRT_EPS", 0.0)
    eng = LocalEngine(case.op_t, device="cpu")
    r = lanczos(eng.matvec, case.n, k=1, tol=1e-10, device="cpu")
    evs = [e for e in obs.events("solver_health")
           if e["check"] == "selective_reorth_fallback"]
    assert evs and all(e["level"] == "info" for e in evs)
    assert r.full_sweeps >= len(evs)
    assert H.health_event_count() == 0


def test_lobpcg_nonfinite_eigenvalues(clean_obs):
    from distributed_matvec_tpu_torch.obs import memory
    from distributed_matvec_tpu_torch.solve.lobpcg import _finish

    _finish(memory.NULL_HANDLE, np.array([-1.0, np.nan]), 7)
    ev = obs.events("solver_health")[-1]
    assert ev["check"] == "nonfinite_eigenvalues"
    assert ev["level"] == "critical" and ev["count"] == 1
    assert obs.events("solver_end")[-1]["iters"] == 7


def test_probes_off_with_obs_off(clean_obs, case, monkeypatch):
    eng = LocalEngine(case.op_t, device="cpu")
    x = torch.randn(case.n, dtype=torch.float64)
    y_on = eng.matvec(x)
    monkeypatch.setenv("DMT_OBS", "off")
    obs.reset_all()

    def explode(*a, **k):
        raise AssertionError("health probe dispatched while obs disabled")

    monkeypatch.setattr(H, "_stats", explode)
    assert not H.probes_enabled()
    assert torch.equal(eng.matvec(x), y_on)
    assert obs.events() == []
