"""Phase attribution and the roofline model of the port against the JAX
package's, on the CPU: the counterpart of ``tests/test_phases.py``.

* ``apply_phases`` counts: the port's ``LocalEngine`` (ell, compact,
  fused) and ``DistributedEngine`` (streamed, ell, compact, fused, hybrid
  at D = 1 and 2, depth 0 and 2) give the JAX engines' structural counts
  for the same operator, mode, D, row chunk and columns — integer-exact;
  the per-phase counts sum to the event's totals exactly, and the
  attributed walls to the measured wall (1e-12 relative: float sums).
* ``DMT_PHASES=off``: no event, and the apply bit-identical.
* The model: ``attribute_phases``, ``roofline_report``,
  ``reconcile_error``, ``choose_pipeline_depth`` and
  ``choose_hybrid_split`` equal the JAX functions' on the same events and
  calibration (exact: the same float operations).
* The calibration sidecar round-trips and is content-addressed.
"""

import json
import os

import numpy as np
import pytest

from distributed_matvec_tpu.obs import roofline as JR
from distributed_matvec_tpu.parallel.distributed import \
    DistributedEngine as JaxEngine
from distributed_matvec_tpu.parallel.engine import LocalEngine as JaxLocal
from distributed_matvec_tpu.utils.config import update_config
from distributed_matvec_tpu_torch import DistributedEngine, LocalEngine, obs
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)
from distributed_matvec_tpu_torch.obs import phases as P
from distributed_matvec_tpu_torch.obs import roofline as R

from test_operator import build_heisenberg

SYMS_10 = [([*range(1, 10), 0], 0), ([*reversed(range(10))], 0)]
B = 32                          # several row chunks per shard


@pytest.fixture
def clean_obs():
    obs.reset_all()
    yield
    obs.reset_all()


@pytest.fixture(scope="module")
def ops():
    """(JAX operator, port operator) of chain_10 in its symmetric sector
    (|G| > 1, real: every mode incl. compact) and the trivial-group
    chain_10."""
    out = {}
    for name, (inv, syms) in {"symm": (1, SYMS_10),
                              "plain": (None, [])}.items():
        op_j = build_heisenberg(10, 5, inv, syms)
        op_j.basis.build()
        out[name] = (op_j, operator_from_reference(operator_arrays(op_j),
                                                   device="cpu"))
    return out


def _x(op, seed, cols=None):
    rng = np.random.default_rng(seed)
    shape = (op.basis.number_states,) + ((cols,) if cols else ())
    return rng.random(shape) - 0.5


def _last(engine):
    evs = [e for e in obs.events("apply_phases") if e["engine"] == engine]
    assert evs, f"no apply_phases event from {engine}"
    return evs[-1]


def _assert_totals_exact(ev):
    for field in ("bytes", "gathers", "flops"):
        assert sum(p[field] for p in ev["phases"].values()) \
            == ev[f"{field}_total"]


def _counts(c):
    """Plain ints: the JAX counts may hold numpy integers."""
    return {p: {k: int(v) for k, v in d.items()} for p, d in c.items()}


# -- LocalEngine ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["ell", "compact", "fused"])
@pytest.mark.parametrize("R", [1, 4])
def test_local_phase_counts_equal_jax(mode, R, ops, clean_obs):
    op_j, op_t = ops["symm"]
    eng = LocalEngine(op_t, mode=mode, batch_size=64, device="cpu")
    jeng = JaxLocal(op_j, mode=mode, batch_size=64)
    eng.matvec(_x(op_t, 0, R if R > 1 else None))
    ev = _last("local")
    assert ev["mode"] == mode and ev["columns"] == R
    assert ev["chunks"] == (eng.num_chunks if mode == "fused" else 1)
    _assert_totals_exact(ev)
    got = {p: {k: v for k, v in d.items() if k != "wall_ms"}
           for p, d in ev["phases"].items()}
    assert got == _counts(jeng._phase_counts(R))
    ma = [e for e in obs.events("matvec_apply") if e["engine"] == "local"]
    assert ma and ma[-1]["bytes"] == 0 and ma[-1]["wall_ms"] > 0


# -- DistributedEngine -----------------------------------------------------------

DIST_CASES = [(mode, D) for mode in ("streamed", "ell", "compact", "fused",
                                     "hybrid") for D in (1, 2)]


@pytest.fixture(scope="module")
def jax_engines(ops):
    """The JAX engine of each (mode, D) case, built once, after one apply
    (the fused counts read the last program's row chunk)."""
    op_j, _ = ops["symm"]
    out = {}
    for mode, D in DIST_CASES:
        kw = {"hybrid_split": "stream:0,2"} if mode == "hybrid" else {}
        update_config(stream_compress="lossless")
        try:
            eng = JaxEngine(op_j, n_devices=D, mode=mode, batch_size=B, **kw)
        finally:
            update_config(stream_compress="off")
        x = _x(op_j, 1)
        eng.matvec(eng.to_hashed(x))
        out[(mode, D)] = eng
    return out


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("mode,D", DIST_CASES,
                         ids=[f"{m}-D{d}" for m, d in DIST_CASES])
def test_distributed_phase_counts_equal_jax(mode, D, depth, ops,
                                            jax_engines, clean_obs):
    _, op_t = ops["symm"]
    kw = {"hybrid_split": "stream:0,2"} if mode == "hybrid" else {}
    eng = DistributedEngine(op_t, n_devices=D, mode=mode, batch_size=B,
                            stream_compress="lossless", device="cpu",
                            pipeline_depth=depth, **kw)
    xh = eng.to_hashed(_x(op_t, 1))
    eng.matvec(xh)
    ev = _last("distributed")
    _assert_totals_exact(ev)
    jeng = jax_engines[(mode, D)]
    got = {p: {k: v for k, v in d.items() if k != "wall_ms"}
           for p, d in ev["phases"].items()}
    assert got == _counts(jeng._phase_counts(1))
    assert ev["chunks"] == jeng._nchunks()
    ma = [e for e in obs.events("matvec_apply")
          if e["engine"] == "distributed"][-1]
    assert ma["bytes"] == ev["phases"]["exchange"]["bytes"] \
        == jeng._exchange_nbytes(jeng.to_hashed(_x(op_t, 1)))
    if mode in ("streamed", "hybrid"):
        assert ev["phases"]["plan_h2d"]["bytes"] == int(eng.plan_bytes)
        tl = ev["chunk_timeline"]
        assert [c["chunk"] for c in tl] == list(range(eng.nchunks))
        assert ev["phases"]["plan_h2d"]["wall_ms"] == pytest.approx(
            sum(c["stall_ms"] for c in tl), abs=1e-3)
        if eng.pipeline_depth:
            assert ev["pipeline"]["depth"] == eng.pipeline_depth
            assert all("exch_ms" in c for c in tl)
    # a 4-column block: four times the vector bytes, the same slots
    eng.matvec(eng.to_hashed(_x(op_t, 2, 4)))
    ev4 = _last("distributed")
    assert ev4["columns"] == 4
    if mode != "fused":
        got4 = {p: {k: v for k, v in d.items() if k != "wall_ms"}
                for p, d in ev4["phases"].items()}
        assert got4 == _counts(jeng._phase_counts(4))
    # the attributed walls sum to the measured wall
    att = R.attribute_phases(ev["phases"], ev["wall_ms"],
                             R.default_calibration("cpu"))
    assert sum(a["wall_ms"] for a in att.values()) == pytest.approx(
        ev["wall_ms"], rel=1e-12)


def test_phases_off_no_events_bit_identical(ops, clean_obs, monkeypatch):
    """``DMT_PHASES=off``: no apply_phases event, the apply bit-identical,
    matvec_apply still flows; ``DMT_OBS=off`` implies phases off."""
    _, op_t = ops["symm"]
    for eng in (LocalEngine(op_t, mode="ell", device="cpu"),
                DistributedEngine(op_t, n_devices=2, mode="streamed",
                                  batch_size=B, stream_compress="lossless",
                                  device="cpu")):
        x = _x(op_t, 3)
        run = (eng.matvec if isinstance(eng, LocalEngine)
               else eng.matvec_global)
        y_on = np.asarray(run(x))
        assert obs.events("apply_phases")
        obs.reset_all()
        monkeypatch.setenv("DMT_PHASES", "off")
        assert not P.phases_enabled()
        y_off = np.asarray(run(x))
        np.testing.assert_array_equal(y_on, y_off)
        assert obs.events("apply_phases") == []
        assert obs.events("matvec_apply")
        monkeypatch.delenv("DMT_PHASES")
    monkeypatch.setenv("DMT_OBS", "off")
    assert not P.phases_enabled()


def test_phase_vocabulary_equals_jax():
    from distributed_matvec_tpu.obs import phases as JP

    assert P.PHASES == JP.PHASES
    assert P.PHASE_RESOURCE == JP.PHASE_RESOURCE
    assert P.ORBIT_OPS == JP.ORBIT_OPS
    assert P.zero_counts() == JP.zero_counts()
    assert R.RATE_FIELDS == JR.RATE_FIELDS
    assert R.DEFAULT_CALIBRATIONS["cpu"] == JR.DEFAULT_CALIBRATIONS["cpu"]
    assert "tpu" not in R.DEFAULT_CALIBRATIONS


# -- the model against the JAX functions -----------------------------------------

def _synthetic(wall_ms, plan_bytes, stall_ms, nchunks, depth=0, seed=0):
    rng = np.random.default_rng(seed)
    ev = {"kind": "apply_phases", "engine": "distributed",
          "mode": "streamed", "apply": 1, "wall_ms": wall_ms,
          "chunks": nchunks, "columns": 1,
          "phases": {
              "plan_h2d": {"bytes": plan_bytes, "gathers": 0, "flops": 0,
                           "wall_ms": stall_ms},
              "compute": {"bytes": int(rng.integers(1 << 18, 1 << 22)),
                          "gathers": 0,
                          "flops": int(rng.integers(1 << 20, 1 << 24))},
              "exchange": {"bytes": int(rng.integers(1 << 16, 1 << 21)),
                           "gathers": 0, "flops": 0},
              "accumulate": {"bytes": 1 << 19, "gathers": 1 << 16,
                             "flops": 1 << 16}},
          "chunk_timeline": [{"chunk": c, "stall_ms": stall_ms / nchunks}
                             for c in range(nchunks)]}
    if depth:
        ev["pipeline"] = {"depth": depth, "barrier_ms": 0.5,
                          "hidden_ms": 1.5, "overlap_fraction": 0.75}
    return ev


@pytest.mark.parametrize("seed", range(4))
def test_roofline_report_equals_jax(seed):
    cal = R.default_calibration("cpu")
    rng = np.random.default_rng(seed)
    evs = [_synthetic(float(rng.uniform(5, 100)), int(rng.integers(1, 50e6)),
                      float(rng.uniform(0, 3)), int(rng.integers(1, 9)),
                      seed=seed * 10 + i) for i in range(3)]
    evs += [_synthetic(float(rng.uniform(5, 100)), 1 << 20, 0.2, 8, depth=2,
                       seed=seed * 10 + 5 + i) for i in range(2)]
    evs += [{"kind": "tune_config", "engine": "distributed",
             "mode": "streamed", "token": "B64|pipe0", "priced_ms": 1.5,
             "source": "search", "search_s": 0.01}]
    got, want = R.roofline_report(evs, cal), JR.roofline_report(evs, cal)
    assert got == want
    # the report rounds to 1e-4 ms: the JAX bound, 1e-3
    assert R.reconcile_error(got) == JR.reconcile_error(want) < 1e-3
    for ev in evs[:5]:
        assert R.attribute_phases(ev["phases"], ev["wall_ms"], cal) \
            == JR.attribute_phases(ev["phases"], ev["wall_ms"], cal)
        assert R.phase_bounds_ms(ev["phases"], cal) \
            == JR.phase_bounds_ms(ev["phases"], cal)
    R.print_roofline(got)


@pytest.mark.parametrize("nchunks,D", [(1, 2), (8, 2), (8, 1), (3, 4)])
def test_choose_pipeline_depth_equals_jax(nchunks, D):
    cal = R.default_calibration("cpu")
    for counts in (
            {"plan_h2d": {"bytes": 10_000_000},
             "compute": {"bytes": 0, "gathers": 0, "flops": 1_000_000},
             "exchange": {"bytes": 100_000},
             "accumulate": {"gathers": 1000}},
            {"plan_h2d": {"bytes": 0}, "compute": {"gathers": 10_000_000},
             "exchange": {"bytes": 0}, "accumulate": {"gathers": 1000}},
            {"compute": {"gathers": 1_000_000, "flops": 4_000_000},
             "exchange": {"bytes": 80_000_000},
             "accumulate": {"gathers": 2_000_000}}):
        assert R.choose_pipeline_depth(counts, cal, nchunks, D) \
            == JR.choose_pipeline_depth(counts, cal, nchunks, D)


@pytest.mark.parametrize("seed", range(3))
def test_choose_hybrid_split_equals_jax(seed):
    rng = np.random.default_rng(seed)
    live = rng.integers(0, 50_000, 24)
    for cal in (R.default_calibration("cpu"),
                dict(R.default_calibration("cpu"), flops_per_s=1e15),
                dict(R.default_calibration("cpu"), flops_per_s=1e3)):
        for G, cplx in ((1, False), (20, False), (40, True)):
            np.testing.assert_array_equal(
                R.choose_hybrid_split(live, 65536, G, cal, 3.5, cplx),
                JR.choose_hybrid_split(live, 65536, G, cal, 3.5, cplx))


def test_engine_auto_policies_equal_jax(ops):
    """The engines' resolved ``pipeline_depth="auto"`` and
    ``hybrid_split="auto"`` equal the JAX engine's under the same (CPU
    default) calibration, and the auto split's apply equals the hand-set
    ``stream:<mask>`` engine's bit for bit."""
    for name in ("symm", "plain"):
        op_j, op_t = ops[name]
        x = _x(op_t, 4)
        for mode in ("streamed", "hybrid"):
            update_config(stream_compress="lossless")
            try:
                jeng = JaxEngine(op_j, n_devices=2, mode=mode, batch_size=B,
                                 pipeline_depth="auto",
                                 **({"hybrid_split": "auto"}
                                    if mode == "hybrid" else {}))
            finally:
                update_config(stream_compress="off")
            eng = DistributedEngine(op_t, n_devices=2, mode=mode,
                                    batch_size=B, stream_compress="lossless",
                                    device="cpu", pipeline_depth="auto")
            assert eng.pipeline_depth == jeng.pipeline_depth
            if mode == "hybrid":
                np.testing.assert_array_equal(eng._hybrid_mask,
                                              jeng._hybrid_mask)
                twin = DistributedEngine(
                    op_t, n_devices=2, mode="hybrid", batch_size=B,
                    stream_compress="lossless", device="cpu",
                    hybrid_split=eng.hybrid_split,
                    pipeline_depth=eng.pipeline_depth)
                np.testing.assert_array_equal(eng.matvec_global(x),
                                              twin.matvec_global(x))


# -- calibration sidecar -----------------------------------------------------------

def test_calibration_roundtrip_content_addressed(tmp_path, monkeypatch):
    monkeypatch.setenv("DMT_ARTIFACT_CACHE", "on")
    monkeypatch.setenv("DMT_ARTIFACT_DIR", str(tmp_path))
    p1 = R.calibration_path("cpu")
    assert p1 and str(tmp_path) in p1 and "calibration" in p1
    assert R.calibration_path("cpu") == p1          # content-addressed
    assert R.calibration_path("cpu", "other") != p1
    assert R.load_calibration(device="cpu") is None
    cal = dict(R.default_calibration("cpu"), gather_rows_per_s=123e6,
               device_kind=R.device_identity("cpu")[1])
    assert R.save_calibration(cal) == p1 and os.path.exists(p1)
    got = R.load_calibration(device="cpu")
    assert got["gather_rows_per_s"] == 123e6 and got["source"] == "measured"
    assert R.resolve_calibration(device="cpu")["gather_rows_per_s"] == 123e6
    other = tmp_path / "cal.json"
    other.write_text(json.dumps(dict(cal, gather_rows_per_s=9e6)))
    assert R.resolve_calibration(str(other))["gather_rows_per_s"] == 9e6
    with pytest.raises(FileNotFoundError):
        R.resolve_calibration(str(tmp_path / "nope.json"))
    monkeypatch.setenv("DMT_ARTIFACT_CACHE", "off")
    assert R.calibration_path("cpu") is None
    assert R.save_calibration(R.default_calibration("cpu")) is None
    assert R.resolve_calibration(device="cpu")["source"] == "default"


def test_calibrate_writes_measured_sidecar(tmp_path, monkeypatch):
    """``obs/calibrate`` on the CPU (asked for): four positive rates,
    ``source="measured"``, saved where ``resolve_calibration`` finds
    them."""
    from distributed_matvec_tpu_torch.obs import calibrate

    monkeypatch.setenv("DMT_ARTIFACT_CACHE", "on")
    monkeypatch.setenv("DMT_ARTIFACT_DIR", str(tmp_path))
    out = tmp_path / "c.json"
    assert calibrate.main(["--device", "cpu", "--quick",
                           "--calibration-out", str(out)]) == 0
    cal = json.loads(out.read_text())
    assert cal["source"] == "measured" and cal["backend"] == "cpu"
    assert all(cal[k] > 0 for k in R.RATE_FIELDS)
    got = R.resolve_calibration(device="cpu")
    assert got["source"] == "measured"
    assert got["gather_rows_per_s"] == cal["gather_rows_per_s"]
