"""The port's timers, profiling hooks, sampled profiler and kernel-cost
attribution against the JAX package's modules.

* ``TreeTimer``: the same scopes under a fake clock give the JAX report,
  text for text, and the same ``to_dict``; ``display_timings`` prints the
  engines' construction trees;
* ``diff_profiles``/``hottest_ops``/``print_profile``/
  ``print_profile_diff`` (copied from the JAX ``obs/hlo.py``) equal the
  JAX functions on the same profile dicts;
* ``classify_kernel`` puts the decode kernel in ``compute``,
  ``index_add_``'s kernels in ``accumulate``, host-to-device copies in
  ``plan_h2d``, NCCL and device-to-host copies in ``exchange``, unknown
  names in ``overhead``;
* ``DMT_PROFILE=sampled``: the JAX cadence (apply 0 skipped, every
  ``profile_every``-th), one trace per window, one ``kernel_cost`` event
  per window with ``index_add_`` in ``accumulate`` on a streamed CPU
  apply, bit-equal results; the overhead guard's latch after two windows
  (JAX rule); ``triggered`` captures only on ``trigger_capture`` (an SLO
  alert fires it); ``off`` touches nothing;
* the roofline report's measured device-ms column from ``kernel_cost``
  events; ``maybe_profile`` writes a Chrome trace under ``profile_dir``.
"""

import io
import json
import os
import time

import pytest
import torch

from distributed_matvec_tpu.obs import hlo as jax_hlo
from distributed_matvec_tpu.utils import timers as jax_timers
from distributed_matvec_tpu_torch import (DistributedEngine, LocalEngine,
                                          obs)
from distributed_matvec_tpu_torch.obs import kernel_costs as KC
from distributed_matvec_tpu_torch.obs import profile as P
from distributed_matvec_tpu_torch.obs import roofline
from distributed_matvec_tpu_torch.utils import timers
from distributed_matvec_tpu_torch.utils.config import update_config
from distributed_matvec_tpu_torch.utils.profiling import maybe_profile

from test_torch_solvers import Case


@pytest.fixture
def clean(monkeypatch, tmp_path):
    monkeypatch.delenv("DMT_PROFILE", raising=False)
    monkeypatch.setenv("DMT_OBS_DIR", str(tmp_path / "run"))
    obs.reset_all()
    yield monkeypatch
    obs.reset_all()


@pytest.fixture(scope="module")
def case():
    return Case(12, 6, 1, [([*range(1, 12), 0], 0)], streamed=False)


# ---------------------------------------------------------------------------
# timers


def _fake_clock(monkeypatch):
    ticks = iter(range(10_000))
    monkeypatch.setattr(time, "perf_counter",
                        lambda: 0.25 * next(ticks))


def _drive(mod):
    t = mod.TreeTimer("matvec")
    with t.scope("off-diagonal"):
        with t.scope("kernel"):
            pass
        with t.scope("all_to_all"):
            pass
    for _ in range(3):
        with t.scope("diag"):
            pass
    t.stop()
    return t


def test_tree_timer_report_equals_jax(monkeypatch):
    _fake_clock(monkeypatch)
    port = _drive(timers)
    _fake_clock(monkeypatch)
    ref = _drive(jax_timers)
    assert port.report(force=True) == ref.report(force=True)
    assert port.to_dict() == ref.to_dict()
    assert port.scope_total("off-diagonal", "kernel") == \
        ref.scope_total("off-diagonal", "kernel") == 0.25
    assert port.report() is None          # display_timings off


def test_display_timings_prints_engine_trees(case, capsys):
    update_config(display_timings=True)
    try:
        LocalEngine(case.op_t, device="cpu")
        DistributedEngine(case.op_t, mode="streamed", batch_size=32,
                          stream_compress="lossless", device="cpu")
    finally:
        update_config(display_timings=False)
    err = capsys.readouterr().err
    assert "LocalEngine:" in err and "build_structure" in err
    assert "DistributedEngine:" in err and "build_plan" in err


def test_engine_init_split(clean, case):
    eng = LocalEngine(case.op_t, device="cpu")
    ev = obs.events("engine_init")[-1]
    assert ev["build_structure_s"] == round(
        eng.timer.scope_total("build_structure"), 6)
    assert ev["transfer_s"] >= 0 and ev["init_s"] >= ev["build_structure_s"]


# ---------------------------------------------------------------------------
# the copied profile functions


def _prof(fp, ops):
    return {"fingerprint": fp, "ops": [
        {"name": n, "opcode": oc, "phase": ph, "bytes": b, "flops": f}
        for n, oc, ph, b, f in ops]}


BASE = _prof("a", [("fusion.1", "fusion", "compute", 100.0, 10.0),
                   ("scatter.2", "scatter", "accumulate", 50.0, 5.0),
                   ("copy.3", "copy", "plan_h2d", 80.0, 0.0),
                   ("all-to-all.4", "all-to-all", "exchange", 40.0, 0.0)])
NEW = _prof("b", [("fusion.9", "fusion", "compute", 160.0, 10.0),
                  ("scatter.2", "scatter", "accumulate", 50.0, 7.0),
                  ("copy.3", "copy", "plan_h2d", 20.0, 0.0),
                  ("gather.5", "gather", "compute", 9.0, 0.0)])


@pytest.mark.parametrize("threshold", [0.0, 0.25, 2.0])
@pytest.mark.parametrize("top", [1, 3, 10])
def test_diff_profiles_equals_jax(threshold, top):
    assert KC.diff_profiles(BASE, NEW, threshold, top) == \
        jax_hlo.diff_profiles(BASE, NEW, threshold, top)
    assert KC.diff_profiles(BASE, BASE) == jax_hlo.diff_profiles(BASE, BASE)


@pytest.mark.parametrize("top", [0, 2, 5])
def test_hottest_ops_and_rendering_equal_jax(top):
    assert KC.hottest_ops(NEW, top) == jax_hlo.hottest_ops(NEW, top)
    prof = dict(BASE, program="p", key="k", totals={"bytes": 270.0,
                                                    "flops": 15.0},
                phases={"compute": {"bytes": 100.0, "flops": 10.0,
                                    "ops": 1}})
    a, b = io.StringIO(), io.StringIO()
    KC.print_profile(prof, top=3, out=a)
    jax_hlo.print_profile(prof, top=3, out=b)
    assert a.getvalue() == b.getvalue()
    d = jax_hlo.diff_profiles(BASE, NEW)
    a, b = io.StringIO(), io.StringIO()
    KC.print_profile_diff(d, out=a)
    jax_hlo.print_profile_diff(d, out=b)
    assert a.getvalue() == b.getvalue()


@pytest.mark.parametrize("name,phase", [
    ("void (anonymous namespace)::fused_decode_kernel<unsigned short, false>"
     "(unsigned int const*, long, ...)", "compute"),
    ("void at::native::indexFuncLargeIndex<double, long, unsigned int, 2, 2,"
     " -2, true, at::native::ReduceAdd>(...)", "accumulate"),
    ("aten::index_add_", "accumulate"),
    ("Memcpy HtoD (Pinned -> Device)", "plan_h2d"),
    ("Memcpy DtoH (Device -> Pinned)", "exchange"),
    ("ncclDevKernel_SendRecv(ncclDevComm*, unsigned long, ncclWork*)",
     "exchange"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<double>, ...>", "overhead"),
    ("Memset (Device)", "overhead"),
    ("void at::native::indexSelectLargeIndex<double, long>(...)",
     "compute"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::BinaryFunctor<double, double, double, "
     "at::native::MulFunctor<double>>>", "compute"),
    ("void (anonymous namespace)::ell_terms_kernel<(anonymous namespace)::"
     "Real, 1, false>(long, int, int const*, ...)", "compute"),
    ("void (anonymous namespace)::ell_tail_kernel<(anonymous namespace)::"
     "Complex, 4, true>(long, int, int const*, ...)", "compute"),
    ("some_unknown_kernel", "overhead"),
])
def test_classify_kernel(name, phase):
    assert KC.classify_kernel(name) == phase


def test_build_profile_merges_and_fingerprints():
    rows = [{"name": "k1", "phase": "compute", "ms": 1.0},
            {"name": "k2", "phase": "accumulate", "ms": 2.0},
            {"name": "k1", "phase": "compute", "ms": 0.5}]
    prof = KC.build_profile("key", rows, program="p")
    assert prof["totals"] == {"ms": 3.5, "calls": 3}
    assert prof["phases"]["compute"] == {"ms": 1.5, "ops": 1, "calls": 2}
    assert [o["name"] for o in KC.hottest_ops(prof, 2, ("ms",))] == \
        ["k2", "k1"]
    assert prof["fingerprint"] == KC.profile_fingerprint(rows[::-1])
    d = KC.diff_profiles(prof, KC.build_profile("key", rows[:2]),
                         axes=("ms",))
    assert d["same_program"] and d["rows"][0]["axis"] == "ms"
    out = io.StringIO()
    KC.print_profile(prof, out=out)
    assert "k2" in out.getvalue() and "ms=3.5000" in out.getvalue()


# ---------------------------------------------------------------------------
# sampled profiling


def _engine(case):
    return DistributedEngine(case.op_t, n_devices=2, mode="streamed",
                             stream_compress="lossless", batch_size=32,
                             device="cpu")


def test_sampled_cadence_traces_and_kernel_costs(clean, case, tmp_path):
    clean.setenv("DMT_PROFILE", "sampled")
    update_config(profile_every=4, profile_overhead_pct=1e9)
    try:
        eng = _engine(case)
        xh = eng.random_hashed(1)
        ref = eng._matvec_body(xh, None)
        ys = [eng.matvec(xh) for _ in range(16)]
    finally:
        update_config(profile_every=64, profile_overhead_pct=2.0)
    assert all(torch.equal(y, ref) for y in ys)
    caps = obs.events("profile_captured")
    assert [e["apply"] for e in caps] == [4, 8, 12]
    prof_dir = tmp_path / "run" / "rank_0" / "profiles"
    assert sorted(os.listdir(prof_dir)) == [
        f"distributed-apply{i}" for i in (12, 4, 8)]
    for i in (4, 8, 12):
        d = prof_dir / f"distributed-apply{i}"
        assert (d / "trace.json").exists()
        assert json.loads((d / "PROFILE_META.json").read_text())[
            "capture"] == "sampled"
        # the window's detail spans beside its trace, under its apply
        spans = json.loads((d / "spans.json").read_text())
        names = [sp["name"] for sp in spans]
        assert names.count("produce") == names.count("consume") \
            == eng.nchunks and "diag_add" in names
        assert len({sp["parent_span_id"] for sp in spans}) == 1
    kc = obs.events("kernel_cost")
    assert len(kc) == 3
    assert kc[0]["program"] == "distributed_streamed_apply"
    assert kc[0]["phase_ms_accumulate"] > 0
    names = {o["name"]: o["phase"] for o in P.last_sample()["ops"]}
    assert names.get("aten::index_add_") == "accumulate"
    assert P.overhead_snapshot()["profiled"] == 3


def test_overhead_guard_latches_after_two_windows(clean, case):
    clean.setenv("DMT_PROFILE", "sampled")
    update_config(profile_every=1, profile_overhead_pct=0.0)
    try:
        eng = _engine(case)
        xh = eng.random_hashed(1)
        for _ in range(6):
            eng.matvec(xh)
    finally:
        update_config(profile_every=64, profile_overhead_pct=2.0)
    assert P.overhead_latched()
    assert len(obs.events("profile_captured")) == 2
    latch = obs.events("profile_overhead_latch")
    assert len(latch) == 1 and latch[0]["overhead_pct"] > 0


def test_profile_off_and_triggered(clean, case):
    eng = _engine(case)
    xh = eng.random_hashed(1)

    def explode(*a, **k):
        raise AssertionError("profiler started while profiling is off")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "profile", explode)
        eng.matvec(xh)
    assert P.overhead_snapshot()["applies"] == 0      # off: no ledger
    clean.setenv("DMT_PROFILE", "triggered")
    eng.matvec(xh)
    assert obs.events("profile_captured") == []
    assert P.overhead_snapshot()["applies"] == 1
    path = P.trigger_capture("unit test!")
    assert path and os.path.basename(path).startswith("profile_unit_test")
    assert obs.events("profile_captured")[-1]["capture"] == "triggered"
    assert P.trigger_capture("unit test!") is None      # one per reason


def test_slo_alert_triggers_capture(clean):
    from distributed_matvec_tpu_torch.obs import slo

    clean.setenv("DMT_PROFILE", "triggered")
    now = time.time()
    evs = [{"kind": "matvec_apply", "ts": now - 1.0, "wall_ms": 5000.0,
            "engine": "local"} for _ in range(20)]
    spec = slo.SloSpec(name="apply_p99", kind="matvec_apply",
                       field="wall_ms", target=1.0, mode="threshold",
                       windows=((60.0, 1.0),))
    st = slo.check_slos([spec], now=now, events=evs)
    assert st[0]["state"] == "firing"
    caps = [e for e in obs.events("profile_captured")
            if e["capture"] == "triggered"]
    assert caps and caps[0]["reason"] == "slo_burn_apply_p99"


def test_roofline_device_column(clean, case, capsys):
    clean.setenv("DMT_PROFILE", "sampled")
    update_config(profile_every=2, profile_overhead_pct=1e9)
    try:
        eng = _engine(case)
        xh = eng.random_hashed(1)
        for _ in range(3):
            eng.matvec(xh)
    finally:
        update_config(profile_every=64, profile_overhead_pct=2.0)
    rep = roofline.roofline_report(obs.events())
    grp = rep["groups"]["distributed/streamed"]
    kc = obs.events("kernel_cost")[-1]
    assert grp["phases"]["accumulate"]["device_ms"] == round(
        kc["phase_ms_accumulate"], 4)
    assert grp["kernels"]["program"] == "distributed_streamed_apply"
    roofline.print_roofline(rep)
    out = capsys.readouterr().out
    assert "device ms" in out and "kernels: distributed_streamed_apply" \
        in out


def test_maybe_profile_writes_a_trace(clean, tmp_path):
    d = tmp_path / "prof"
    with maybe_profile(str(d)):
        torch.ones(8).sum()
    traces = [f for f in os.listdir(d) if f.endswith(".json")
              and f.startswith("trace-")]
    assert len(traces) == 1
    assert json.loads((d / "PROFILE_META.json").read_text())["capture"] \
        == "manual"
    assert obs.events("profile_captured")[-1]["capture"] == "manual"
    with maybe_profile(""):
        pass                                  # forced no-op
