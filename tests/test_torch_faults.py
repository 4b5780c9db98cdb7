"""The port's fault layer (``utils/faults.py``) and heartbeat watchdog
(``parallel/heartbeat.py``) against the JAX package's modules, and the
port's fault sites on its engines and solvers.

* the registry semantics of the JAX ``tests/test_faults.py`` cases, run on
  the port's module; the fire sequence of a ``p < 1`` spec with a seed
  equal to the JAX module's on the same spec, call for call;
* ``with_retries`` heals and exhausts as in JAX;
* unset, the layer is the shared no-op singleton and an apply takes the
  plain plan fetch (no fault wrapper in the chunk loop);
* ``plan_upload:n=2`` heals through the retries to an apply bit-equal to
  the clean one; ``exchange:n=1`` raises before any device work and the
  next apply is bit-equal to the clean one; ``solver_block`` fires at the
  solvers' block boundaries, ``delay=`` stretching a solve without
  changing its result;
* the heartbeat cases of the JAX ``test_faults.py`` and
  ``test_elastic.py``, run on the port's watchdog, and the default stall
  path in a subprocess: ``stall_report`` naming the stalled rank, a flight
  bundle on disk, exit 76.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from distributed_matvec_tpu.utils import faults as jax_faults
from distributed_matvec_tpu_torch import (DistributedEngine, LocalEngine,
                                          kpm_moments, krylov_evolve,
                                          lanczos, lanczos_block, obs)
from distributed_matvec_tpu_torch.parallel import heartbeat
from distributed_matvec_tpu_torch.utils import faults

from test_torch_solvers import Case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def clean_faults(monkeypatch):
    """Fresh fault registries (both packages) and obs state."""
    monkeypatch.delenv("DMT_FAULT", raising=False)
    faults.reset()
    jax_faults.reset()
    obs.reset_all()
    yield monkeypatch
    faults.reset()
    jax_faults.reset()
    obs.reset_all()


def _arm(monkeypatch, spec):
    monkeypatch.setenv("DMT_FAULT", spec)
    faults.reset()
    jax_faults.reset()


@pytest.fixture(scope="module")
def case():
    return Case(12, 6, 1, [([*range(1, 12), 0], 0)], streamed=False)


# ---------------------------------------------------------------------------
# registry semantics (JAX tests/test_faults.py:53-148)


def test_faults_unset_is_noop_singleton(clean_faults):
    assert not faults.enabled()
    r1 = faults._registry()
    faults.check("exchange")
    faults.check("anything_at_all", exc=RuntimeError)
    assert faults._registry() is r1 is faults._NULL
    assert faults.fired_count("exchange") == 0
    assert obs.events() == []


def test_fault_fires_then_heals(clean_faults):
    _arm(clean_faults, "plan_upload")
    with pytest.raises(OSError, match=r"\[fault-injection\]"):
        faults.check("plan_upload")
    faults.check("plan_upload")            # healed
    assert faults.fired_count("plan_upload") == 1
    assert "fault_injected" in [e["kind"] for e in obs.events()]
    assert obs.snapshot()["counters"][
        "fault_injected{site=plan_upload}"] == 1


def test_fault_spec_fields(clean_faults):
    _arm(clean_faults, "s:skip=2:n=2")
    for _ in range(2):
        faults.check("s", exc=RuntimeError)     # skipped
    for _ in range(2):
        with pytest.raises(RuntimeError):
            faults.check("s", exc=RuntimeError)
    faults.check("s", exc=RuntimeError)         # budget spent
    assert faults.fired_count("s") == 2


@pytest.mark.parametrize("spec", ["p:p=0.25:n=1000:seed=7",
                                  "p:p=0.5:n=9:skip=3:seed=11",
                                  "p:p=0.1:n=1000"])
def test_fire_sequence_equals_jax(clean_faults, spec):
    """A ``p < 1`` spec draws from the per-site seeded RNG: the port fires
    on the same calls as the JAX module, and twice alike."""
    def pattern(mod):
        mod.reset()
        hits = []
        for i in range(200):
            try:
                mod.check("p", exc=OSError)
            except OSError:
                hits.append(i)
        return hits

    clean_faults.setenv("DMT_FAULT", spec)
    got = pattern(faults)
    assert got == pattern(jax_faults) == pattern(faults)
    assert 0 < len(got) < 200


def test_fault_rank_field_reads_the_process_rank(clean_faults):
    """``rank=`` compares with the port's process rank (0 without a
    ``torch.distributed`` group)."""
    _arm(clean_faults, "a:rank=1,b:rank=0")
    faults.check("a")
    with pytest.raises(OSError):
        faults.check("b")


def test_fault_delay_injects_latency_not_error(clean_faults):
    _arm(clean_faults, "slow:delay=30:n=2")
    t0 = time.perf_counter()
    faults.check("slow")
    assert time.perf_counter() - t0 >= 0.025
    assert faults.fired_count("slow") == 1


@pytest.mark.parametrize("bad", ["site:nope=1", "site:p", ":p=1",
                                 "site:n=x"])
def test_fault_spec_errors_are_loud(clean_faults, bad):
    for mod in (faults, jax_faults):
        clean_faults.setenv("DMT_FAULT", bad)
        mod.reset()
        with pytest.raises(mod.FaultSpecError):
            mod.check("site")


def test_with_retries_heals_and_exhausts(clean_faults):
    calls = []

    def flaky(fail_times):
        def fn():
            calls.append(1)
            if len(calls) <= fail_times:
                raise OSError("transient")
            return "ok"
        return fn

    assert faults.with_retries("t", flaky(2), attempts=3,
                               base_s=0.001) == "ok"
    assert len(calls) == 3
    assert obs.snapshot()["counters"]["io_retry{site=t}"] == 2
    calls.clear()
    with pytest.raises(OSError):
        faults.with_retries("t", flaky(99), attempts=3, base_s=0.001)
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# the engines' and solvers' sites


def _streamed(case):
    return DistributedEngine(case.op_t, mode="streamed",
                             stream_compress="lossless", batch_size=32,
                             device="cpu")


def test_unset_apply_takes_the_plain_fetch(clean_faults, case,
                                           monkeypatch):
    """Unset, the chunk loop fetches the plan directly: the retrying
    fault wrapper is never entered."""
    eng = _streamed(case)

    def boom(ci):
        raise AssertionError("fault wrapper entered while unarmed")

    monkeypatch.setattr(eng, "_fetch_plan_chunk", boom)
    xh = eng.random_hashed(3)
    eng.matvec(xh)
    assert faults._registry() is faults._NULL


def test_plan_upload_fault_heals_bit_equal(clean_faults, case):
    eng = _streamed(case)
    xh = eng.random_hashed(3)
    clean = eng.matvec(xh)
    _arm(clean_faults, "plan_upload:n=2")
    from distributed_matvec_tpu_torch.utils.config import update_config
    cfg = update_config()
    base = cfg.io_retry_base_s
    update_config(io_retry_base_s=0.001)
    try:
        y = eng.matvec(xh)
    finally:
        update_config(io_retry_base_s=base)
    assert faults.fired_count("plan_upload") == 2
    assert torch.equal(y, clean)
    retries = [e for e in obs.events() if e["kind"] == "io_retry"]
    assert [e["attempt"] for e in retries] == [1, 2]


@pytest.mark.parametrize("mode", ["streamed", "ell", "fused"])
def test_exchange_fault_raises_then_next_apply_clean(clean_faults, case,
                                                     mode):
    eng = DistributedEngine(case.op_t, n_devices=2, mode=mode,
                            stream_compress="lossless", batch_size=32,
                            device="cpu")
    xh = eng.random_hashed(5)
    clean = eng.matvec(xh)
    applies = eng.n_applies
    _arm(clean_faults, "exchange:n=1")
    with pytest.raises(RuntimeError, match=r"\[fault-injection\].*exchange"):
        eng.matvec(xh)
    # raised before any device work: no apply body ran
    assert eng.n_applies == applies
    assert torch.equal(eng.matvec(xh), clean)


def test_solver_block_site_fires_at_block_boundaries(clean_faults, case):
    eng = LocalEngine(case.op_t, device="cpu")
    n = case.n
    ref = lanczos(eng.matvec, n, k=1, tol=1e-12, device="cpu")
    _arm(clean_faults, "solver_block:skip=1")
    with pytest.raises(RuntimeError, match="solver_block"):
        lanczos(eng.matvec, n, k=1, tol=1e-12, check_every=4,
                device="cpu")
    fired = [e for e in obs.events() if e["kind"] == "fault_injected"]
    assert fired and fired[0]["solver"] == "lanczos"
    # delay= stretches the solve and leaves its result alone
    _arm(clean_faults, "solver_block:delay=20:n=10000")
    t0 = time.perf_counter()
    got = lanczos(eng.matvec, n, k=1, tol=1e-12, device="cpu")
    assert time.perf_counter() - t0 >= 0.02 * (got.num_iters // 16)
    assert got.eigenvalues[0] == ref.eigenvalues[0]
    assert got.num_iters == ref.num_iters
    assert faults.fired_count("solver_block") >= 1


@pytest.mark.parametrize("solver", ["lanczos_block", "kpm", "evolve"])
def test_solver_block_site_in_every_solver(clean_faults, case, solver):
    eng = LocalEngine(case.op_t, device="cpu")
    n = case.n
    _arm(clean_faults, "solver_block")
    with pytest.raises(RuntimeError, match=r"\[fault-injection\]"):
        if solver == "lanczos_block":
            lanczos_block(eng.matvec, n, k=1, block_size=2, device="cpu")
        elif solver == "kpm":
            kpm_moments(eng.matvec, n_moments=16, n=n, n_vectors=1,
                        bounds=(-24.0, 14.0), device="cpu")
        else:
            krylov_evolve(eng.matvec, n=n, t_final=0.2, device="cpu")
    ev = [e for e in obs.events() if e["kind"] == "fault_injected"]
    assert ev[0]["solver"] == solver and ev[0]["site"] == "solver_block"


@pytest.mark.parametrize("solver", ["lanczos", "lanczos_block", "kpm",
                                    "evolve", "lobpcg"])
def test_failed_solve_leaves_no_workspace(clean_faults, case, solver):
    """A solve that raises after registering its workspace (an injected
    ``solver_block`` fault; for ``lobpcg``, which has no block site, a
    matvec that fails mid-solve) leaves no ``solver/`` ledger entry."""
    from distributed_matvec_tpu_torch import lobpcg
    from distributed_matvec_tpu_torch.obs import memory as obs_memory

    eng = LocalEngine(case.op_t, device="cpu")
    n = case.n
    seen = []
    track = obs_memory.track

    def spy(path, nbytes, **kw):
        seen.append(path)
        return track(path, nbytes, **kw)
    clean_faults.setattr(obs_memory, "track", spy)
    _arm(clean_faults, "solver_block:skip=1")
    with pytest.raises(RuntimeError):
        if solver == "lanczos":
            lanczos(eng.matvec, n, k=1, tol=1e-12, check_every=4,
                    device="cpu")
        elif solver == "lanczos_block":
            lanczos_block(eng.matvec, n, k=1, block_size=2, device="cpu")
        elif solver == "kpm":
            kpm_moments(eng.matvec, n_moments=16, n=n, n_vectors=1,
                        bounds=(-24.0, 14.0), device="cpu")
        elif solver == "evolve":
            krylov_evolve(eng.matvec, n=n, t_final=0.2, device="cpu")
        else:
            calls = []

            def failing(x):
                calls.append(1)
                if len(calls) == 5:
                    raise RuntimeError("matvec failed")
                return eng.matvec(x)
            lobpcg(failing, n, k=1, device="cpu")
    assert any(p.startswith("solver/") for p in seen)
    assert not any(p.startswith("solver/")
                   for p in obs_memory.ledger_entries())


# ---------------------------------------------------------------------------
# heartbeat watchdog (JAX tests/test_faults.py:591-652,
# tests/test_elastic.py:429-503)


def test_heartbeat_stall_report(clean_faults, tmp_path):
    d = str(tmp_path / "run")
    hb_dir = os.path.join(d, "heartbeat")
    os.makedirs(hb_dir)
    stale = os.path.join(hb_dir, "rank_1.hb")
    with open(stale, "w") as f:
        f.write("0\n")
    os.utime(stale, (1.0, 1.0))
    reports = []
    wd = heartbeat.HeartbeatWatchdog(d, interval_s=0.05, timeout_s=5.0,
                                     rank=0, n_ranks=2,
                                     on_stall=reports.append)
    wd.start()
    t = wd._thread
    assert t is not None
    t.join(timeout=10)
    assert not t.is_alive(), "watchdog thread never reported the stall"
    wd.stop()
    assert len(reports) == 1 and reports[0]["stalled"] == [1]
    assert reports[0]["ages_s"]["1"] >= 5.0
    evs = [e for e in obs.events() if e["kind"] == "stall_report"]
    assert len(evs) == 1 and evs[0]["stalled"] == [1]
    # the health layer recorded the critical condition
    assert [e["check"] for e in obs.events("health")] == ["peer_stall"]
    assert os.path.exists(os.path.join(hb_dir, "rank_0.hb"))


def test_heartbeat_healthy_peers_stay_quiet(clean_faults, tmp_path):
    d = str(tmp_path / "run")
    reports = []
    wd = heartbeat.HeartbeatWatchdog(d, interval_s=0.05, timeout_s=60.0,
                                     rank=0, n_ranks=2,
                                     on_stall=reports.append)
    with wd:
        peer = heartbeat.HeartbeatWatchdog(d, interval_s=0.05,
                                           timeout_s=60.0, rank=1,
                                           n_ranks=2,
                                           on_stall=reports.append)
        peer.beat()
        time.sleep(0.3)
    assert reports == []
    assert not any(e["kind"] == "stall_report" for e in obs.events())


def test_heartbeat_single_rank_inert(clean_faults, tmp_path):
    wd = heartbeat.HeartbeatWatchdog(str(tmp_path), rank=0, n_ranks=1)
    wd.start()
    assert wd._thread is None
    wd.stop()


def test_heartbeat_defaults_from_config(clean_faults, tmp_path):
    from distributed_matvec_tpu_torch.utils.config import update_config

    wd = heartbeat.HeartbeatWatchdog(str(tmp_path), rank=0, n_ranks=1)
    assert (wd.interval_s, wd.timeout_s) == (2.0, 120.0)   # heartbeat_s 0
    cfg = update_config()
    old = (cfg.heartbeat_s, cfg.heartbeat_timeout_s)
    update_config(heartbeat_s=0.25, heartbeat_timeout_s=7.0)
    try:
        wd = heartbeat.HeartbeatWatchdog(str(tmp_path), rank=0, n_ranks=1)
        assert (wd.interval_s, wd.timeout_s) == (0.25, 7.0)
        wd = heartbeat.HeartbeatWatchdog(str(tmp_path), interval_s=1.0,
                                         timeout_s=3.0, rank=0, n_ranks=1)
        assert (wd.interval_s, wd.timeout_s) == (1.0, 3.0)
    finally:
        update_config(heartbeat_s=old[0], heartbeat_timeout_s=old[1])
    assert heartbeat.EXIT_STALLED == 76


def test_heartbeat_ignores_and_ages_out_departed_ranks(tmp_path):
    hb_dir = tmp_path / "hb"
    os.makedirs(hb_dir / "heartbeat")
    old = time.time() - 3600
    for r in (1, 2, 3):
        p = hb_dir / "heartbeat" / f"rank_{r}.hb"
        p.write_text("0.0\n")
        os.utime(p, (old, old))
    stalls = []
    wd = heartbeat.HeartbeatWatchdog(str(hb_dir), interval_s=0.05,
                                     timeout_s=0.2, rank=0, n_ranks=2,
                                     on_stall=stalls.append)
    wd.start()
    try:
        names = sorted(os.listdir(hb_dir / "heartbeat"))
        assert "rank_2.hb" not in names and "rank_3.hb" not in names
        deadline = time.time() + 1.0
        while time.time() < deadline:
            (hb_dir / "heartbeat" / "rank_1.hb").write_text(
                f"{time.time():.3f}\n")
            time.sleep(0.05)
        assert not stalls, stalls
        assert wd.scan() is None
    finally:
        wd.stop()
    wd2 = heartbeat.HeartbeatWatchdog(str(hb_dir), timeout_s=60.0, rank=0,
                                      n_ranks=2, on_stall=lambda rep: None)
    live = hb_dir / "heartbeat" / "rank_8.hb"
    live.write_text("x\n")
    recent = time.time() - 1.0
    os.utime(live, (recent, recent))
    fresh = hb_dir / "heartbeat" / "rank_9.hb"
    fresh.write_text("x\n")
    ahead = time.time() + 60
    os.utime(fresh, (ahead, ahead))
    wd2._age_out_departed()
    assert live.exists() and fresh.exists()


def test_heartbeat_still_reports_a_real_stall(tmp_path):
    stalls = []
    wd = heartbeat.HeartbeatWatchdog(str(tmp_path), interval_s=0.05,
                                     timeout_s=0.3, rank=0, n_ranks=2,
                                     on_stall=stalls.append)
    wd.start()
    try:
        deadline = time.time() + 3.0
        while not stalls and time.time() < deadline:
            time.sleep(0.05)
    finally:
        wd.stop()
    assert stalls and stalls[0]["stalled"] == [1]


_STALL_CHILD = r"""
import sys, time
sys.path.insert(0, {root!r})
from distributed_matvec_tpu_torch import obs
from distributed_matvec_tpu_torch.parallel.heartbeat import HeartbeatWatchdog
with obs.span("solve", kind="solve"):
    HeartbeatWatchdog({d!r}, interval_s=0.05, timeout_s=0.5, rank=0,
                      n_ranks=2).start()
    time.sleep(60)
sys.exit(3)
"""


def test_heartbeat_default_stall_exits_76(tmp_path):
    """The default stall path, in a process of its own: a peer that never
    beats → ``stall_report`` naming rank 1 with this rank's span path, a
    flight bundle on disk, exit 76."""
    d = str(tmp_path / "run")
    env = dict(os.environ, DMT_OBS_DIR=d)
    env.pop("DMT_OBS", None)
    p = subprocess.Popen([sys.executable, "-c",
                          _STALL_CHILD.format(root=ROOT, d=d)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
    t0 = time.monotonic()
    try:
        out, _ = p.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        p.kill()
        raise
    assert p.returncode == heartbeat.EXIT_STALLED, out[-2000:]
    assert time.monotonic() - t0 < 30
    with open(os.path.join(d, "rank_0", "events.jsonl")) as f:
        evs = [json.loads(line) for line in f]
    stall = [e for e in evs if e["kind"] == "stall_report"]
    assert len(stall) == 1 and stall[0]["stalled"] == [1]
    assert stall[0]["span_path"] == "solve"
    bundles = obs.list_bundles(d)
    assert any(os.path.basename(b).startswith("stall-") for b in bundles)
    assert obs.read_bundle([b for b in bundles if "stall-" in b][0])[
        "exit_code"] == 76
