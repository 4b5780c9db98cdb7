"""The port's self-tuning runtime against the JAX package's, on the CPU:
the counterpart of ``tests/test_autotune.py``.

* the knob grid, the prices, ``choose_config``'s answer and
  ``tuning_fingerprint`` equal the JAX functions' on the same stats and
  rates (exact: the same float operations);
* the posterior's log-EMA update equals the JAX posterior's to 1e-12
  (relative) and walks a 10× mis-calibration to within 25 % in four
  windows; the live tuner keeps its window discipline;
* a tuned engine is bit-identical to a hand-set engine at the same knobs,
  and picks the JAX engine's config on the same operator; a tuned
  artifact restores with no search; explicit knobs win; ``tune="bogus"``
  is refused; a live re-key lands at the next apply, bit-equal to a
  hand-set engine at the new knobs.
"""

import os

import numpy as np
import pytest

from distributed_matvec_tpu import tune as jtune
from distributed_matvec_tpu.obs.roofline import \
    phase_bounds_ms as jax_phase_bounds
from distributed_matvec_tpu.parallel.distributed import \
    DistributedEngine as JaxEngine
from distributed_matvec_tpu.utils.config import \
    update_config as jax_update_config
from distributed_matvec_tpu_torch import DistributedEngine, obs, tune
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)
from distributed_matvec_tpu_torch.obs.roofline import phase_bounds_ms
from distributed_matvec_tpu_torch.utils.config import update_config

from test_operator import build_heisenberg

#: the JAX test's mid-size streamed geometry: multi-chunk at the small
#: batch candidates, single-chunk at the large ones
STATS = {"shard_size": 40960, "num_terms": 24, "n_my_shards": 1,
         "n_devices": 4, "pair": False, "cplx": False, "columns": 1,
         "group_order": 2, "ram_budget_bytes": 8e9,
         "disk_available": True}

CAL = {"gather_rows_per_s": 25e6, "h2d_bytes_per_s": 8e9,
       "exchange_bytes_per_s": 4e9, "flops_per_s": 5e9,
       "backend": "cpu", "device_kind": "cpu", "source": "default"}

#: geometries the grid and search are held to JAX on: the above, a
#: RAM-starved one (disk forced), a complex hybrid one, a tiny one
STATS_CASES = {
    "mid": STATS,
    "ram_starved": dict(STATS, ram_budget_bytes=1.0),
    "complex": dict(STATS, cplx=True, group_order=64, n_devices=1,
                    shard_size=4_707_969, num_terms=32),
    "tiny": dict(STATS, shard_size=35, disk_available=False),
}
RATES = {"cpu": CAL,
         "fast_flops": dict(CAL, flops_per_s=5e12, h2d_bytes_per_s=1e9),
         "card_like": dict(CAL, gather_rows_per_s=4.5e10,
                           h2d_bytes_per_s=5.2e10,
                           exchange_bytes_per_s=1.1e12, flops_per_s=1.6e11)}


@pytest.fixture
def art_root(tmp_path, monkeypatch):
    """An isolated artifact cache, switched on."""
    root = tmp_path / "artifacts"
    monkeypatch.setenv("DMT_ARTIFACT_DIR", str(root))
    monkeypatch.setenv("DMT_ARTIFACT_CACHE", "on")
    return root


@pytest.fixture
def tune_off():
    yield
    update_config(tune="off")
    jax_update_config(tune="off")


@pytest.fixture(scope="module")
def chain12():
    op_j = build_heisenberg(12, 6, None, ())
    op_j.basis.build()
    return op_j, operator_from_reference(operator_arrays(op_j),
                                         device="cpu")


# -- the pure search against JAX ---------------------------------------------------

@pytest.mark.parametrize("rates", sorted(RATES))
@pytest.mark.parametrize("stats", sorted(STATS_CASES))
@pytest.mark.parametrize("mode", ["streamed", "hybrid"])
def test_grid_prices_and_choice_equal_jax(mode, stats, rates):
    st, cal = STATS_CASES[stats], RATES[rates]
    got = list(tune.knob_grid(st, mode))
    want = list(jtune.knob_grid(st, mode))
    assert [c.token() for c in got] == [c.token() for c in want]
    for a, b in zip(got, want):
        assert tune.price_config(st, a, cal) == jtune.price_config(st, b, cal)
        assert _plain(tune.model_counts(st, a)) \
            == _plain(jtune.model_counts(st, b))
    a, b = tune.choose_config(st, cal, mode), jtune.choose_config(st, cal,
                                                                  mode)
    assert a.token() == b.token() and a.priced_ms == b.priced_ms
    assert tune.tuning_fingerprint(st, cal, mode) \
        == jtune.tuning_fingerprint(st, cal, mode)


def _plain(c):
    return {p: {k: int(v) for k, v in d.items()} for p, d in c.items()}


def test_fingerprint_misses_on_calibration_change():
    fp = tune.tuning_fingerprint(STATS, CAL, "streamed")
    assert fp == tune.tuning_fingerprint(dict(STATS), dict(CAL), "streamed")
    assert fp != tune.tuning_fingerprint(
        STATS, dict(CAL, flops_per_s=2 * CAL["flops_per_s"]), "streamed")
    assert fp != tune.tuning_fingerprint(STATS, CAL, "hybrid")


def test_encode_decode_roundtrip():
    for cand in tune.knob_grid(STATS, "hybrid"):
        back = tune.TunedConfig.decode(cand.encode(), cand.mode)
        assert back.same_knobs(cand), (cand.token(), back.token())
        assert cand.encode() == jtune.TunedConfig.decode(
            cand.encode(), cand.mode).encode()


def test_search_value_exact_tiers_only():
    for mode in ("streamed", "hybrid"):
        for cand in tune.knob_grid(STATS, mode):
            assert cand.stream_compress in ("off", "lossless")


# -- artifacts ----------------------------------------------------------------------

def test_tuned_artifact_and_posterior_roundtrip(art_root):
    cfg = tune.choose_config(STATS, CAL, "streamed")
    fp = tune.tuning_fingerprint(STATS, CAL, "streamed")
    path = tune.save_tuned(fp, cfg, STATS, CAL, search_s=0.01)
    assert path and os.path.exists(path) and str(art_root) in path
    back = tune.load_tuned(fp)
    assert back is not None and back.same_knobs(cfg)
    assert back.source == "artifact"
    fp2 = tune.tuning_fingerprint(
        STATS, dict(CAL, flops_per_s=CAL["flops_per_s"] * 10), "streamed")
    assert tune.load_tuned(fp2) is None
    recs = tune.find_tuned("streamed", "cpu")
    assert recs and recs[0]["fingerprint"] == fp
    post = tune.RatePosterior(CAL)
    post.update({"compute": {"bytes": 0, "gathers": 10 ** 7,
                             "flops": 10 ** 8}}, wall_ms=100.0)
    assert tune.save_posterior(post, "streamed")
    d = tune.load_posterior("cpu", "cpu", "streamed")
    assert d is not None and d["source"] == "posterior"
    back = tune.RatePosterior.from_dict(d)
    for k in ("gather_rows_per_s", "flops_per_s"):
        assert back.rates()[k] == pytest.approx(post.rates()[k], rel=1e-12)
    # serve admission reads both
    from distributed_matvec_tpu_torch.serve import capacity
    t = capacity.load_tuning("cpu", "cpu")
    assert t["rates"]["streamed"]["source"] == "posterior"
    assert t["configs"][0]["fingerprint"] == fp


# -- the posterior against JAX ---------------------------------------------------------

POSTERIOR_STEPS = [
    ({"compute": {"bytes": 0, "gathers": 2 * 10 ** 6, "flops": 5 * 10 ** 7}},
     None, 10.0),
    ({"plan_h2d": {"bytes": 16 * 10 ** 6, "gathers": 0, "flops": 0}},
     {"plan_h2d": 4.0}, 4.0),
    ({"plan_h2d": {"bytes": 10 ** 7, "gathers": 0, "flops": 0},
      "compute": {"bytes": 0, "gathers": 10 ** 6, "flops": 10 ** 7},
      "exchange": {"bytes": 4 * 10 ** 6, "gathers": 0, "flops": 0},
      "accumulate": {"bytes": 0, "gathers": 10 ** 5, "flops": 10 ** 5}},
     {"plan_h2d": 0.5}, 3.0),
]


def test_posterior_math_equals_jax():
    got, want = tune.RatePosterior(CAL), jtune.RatePosterior(CAL)
    for _ in range(3):
        for counts, measured, scale in POSTERIOR_STEPS:
            priced = sum(phase_bounds_ms(counts, got.rates()).values())
            wall = scale * priced
            a = got.update(counts, wall, measured)
            b = want.update(counts, wall, measured)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k] == pytest.approx(b[k], rel=1e-12)
            for k in tune.RatePosterior(CAL).rates():
                if isinstance(got.rates()[k], float):
                    assert got.rates()[k] == pytest.approx(
                        want.rates()[k], rel=1e-12)
    assert got.to_dict().keys() == want.to_dict().keys()


def test_posterior_documented_steps():
    post = tune.RatePosterior(CAL)
    counts = POSTERIOR_STEPS[0][0]
    before = post.rates()
    priced = sum(phase_bounds_ms(counts, before).values())
    post.update(counts, wall_ms=10.0 * priced)
    for f in ("gather_rows_per_s", "flops_per_s"):
        assert post.rates()[f] == pytest.approx(before[f] * 0.1 ** 0.6,
                                                rel=1e-12)
    assert post.rates()["exchange_bytes_per_s"] \
        == pytest.approx(before["exchange_bytes_per_s"], rel=1e-12)
    post = tune.RatePosterior(CAL)
    post.update(POSTERIOR_STEPS[1][0], wall_ms=4.0,
                measured={"plan_h2d": 4.0})
    assert post.rates()["h2d_bytes_per_s"] == pytest.approx(
        8e9 * 0.5 ** 0.6, rel=1e-12)


def test_posterior_converges_ten_x_miscalibration():
    post = tune.RatePosterior(CAL)
    counts = {"compute": {"bytes": 0, "gathers": 10 ** 6, "flops": 10 ** 7},
              "plan_h2d": {"bytes": 10 ** 7, "gathers": 0, "flops": 0}}
    true_wall = 10.0 * sum(phase_bounds_ms(counts, CAL).values())
    ratios = []
    for _ in range(4):
        priced = sum(phase_bounds_ms(counts, post.rates()).values())
        ratios.append(true_wall / priced)
        post.update(counts, true_wall)
    final = sum(phase_bounds_ms(counts, post.rates()).values())
    assert abs(true_wall / final - 1.0) < 0.25, ratios
    assert all(b < a for a, b in zip(ratios, ratios[1:])), ratios
    assert phase_bounds_ms(counts, CAL) == jax_phase_bounds(counts, CAL)


def test_live_tuner_window_discipline(monkeypatch):
    monkeypatch.setenv("DMT_ARTIFACT_CACHE", "off")
    cfg = tune.choose_config(STATS, CAL, "streamed")
    t = tune.LiveTuner("streamed", STATS, CAL, cfg, window=2)
    counts = tune.model_counts(STATS, cfg)
    priced = sum(phase_bounds_ms(counts, CAL).values())
    assert t.observe(counts, priced) is None          # first apply skipped
    assert not t.window_closed and t.windows == 0
    assert t.observe(counts, priced) is None
    assert not t.window_closed
    assert t.observe(counts, priced) is None          # closes window 1
    assert t.window_closed and t.windows == 1
    assert t.last_ratio == pytest.approx(1.0, rel=0.01)
    t.note_rebuild(cfg)
    assert t.observe(counts, priced) is None and t.windows == 1
    # a 10x slow window leaves the drift band and proposes a re-search
    slow = tune.LiveTuner("streamed", STATS, dict(CAL, flops_per_s=1e15,
                                                  gather_rows_per_s=1e15),
                          cfg, window=1)
    slow.observe(counts, priced)
    slow.observe(counts, 1e3 * priced)
    assert slow.window_closed and slow.last_ratio > tune.DRIFT_BAND[1]


# -- the engine ---------------------------------------------------------------------------

def _build(op, D=4, **kw):
    kw.setdefault("stream_compress", None)
    return DistributedEngine(op, n_devices=D, mode=kw.pop("mode", "streamed"),
                             device="cpu", **kw)


def test_tuned_engine_bit_identical_and_equal_to_jax(chain12, tune_off):
    """tune=static: the JAX engine's choice on the same operator (the
    stats, the fingerprint and the token), and an apply bit-identical to
    a hand-set engine at the tuned knobs (and to the untuned default:
    every searched knob is value-exact)."""
    op_j, op_t = chain12
    x = np.random.default_rng(0).random(op_t.basis.number_states) - 0.5
    y_plain = _build(op_t).matvec_global(x)
    update_config(tune="static")
    jax_update_config(tune="static")
    eng = _build(op_t)
    jeng = JaxEngine(op_j, n_devices=4, mode="streamed")
    t = eng._tuned
    assert t is not None and t.source == "search"
    assert eng._tune_stats() == jeng._tune_stats()
    cal = dict(eng._tune_cal)
    assert tune.tuning_fingerprint(eng._tune_stats(), cal, "streamed") \
        == jtune.tuning_fingerprint(jeng._tune_stats(), cal, "streamed")
    assert t.token() == jeng._tuned.token()
    y_t = eng.matvec_global(x)
    update_config(tune="off")
    twin = _build(op_t, batch_size=eng.batch_size,
                  pipeline_depth=t.pipeline_depth,
                  stream_compress=t.stream_compress)
    np.testing.assert_array_equal(y_t, twin.matvec_global(x))
    np.testing.assert_array_equal(y_t, y_plain)
    evs = [e for e in obs.events("tune_config")
           if e["engine"] == "distributed"]
    assert evs and evs[-1]["token"] == t.token()


def test_tuned_hybrid_equals_jax(chain12, tune_off):
    op_j, op_t = chain12
    update_config(tune="static")
    jax_update_config(tune="static")
    eng = _build(op_t, D=2, mode="hybrid")
    jeng = JaxEngine(op_j, n_devices=2, mode="hybrid")
    assert eng._tuned.token() == jeng._tuned.token()
    np.testing.assert_array_equal(eng._hybrid_mask, jeng._hybrid_mask)
    assert eng.batch_size == jeng.batch_size


def test_tuned_artifact_restore_and_explicit_override(chain12, art_root,
                                                      tune_off):
    _, op_t = chain12
    update_config(tune="static")
    eng1 = _build(op_t)
    assert eng1._tuned.source == "search" and eng1.tune_search_s > 0
    eng2 = _build(op_t)
    assert eng2._tuned.source == "artifact" and eng2.tune_search_s == 0.0
    assert eng2._tuned.same_knobs(eng1._tuned)
    assert eng2.batch_size == eng1.batch_size
    eng3 = _build(op_t, batch_size=24, pipeline_depth=0)
    assert eng3.batch_size == 24 and eng3.pipeline_depth == 0
    update_config(tune="off")
    x = np.random.default_rng(1).random(op_t.basis.number_states) - 0.5
    plain = _build(op_t, batch_size=24,
                   stream_compress=eng3.stream_compress)
    np.testing.assert_array_equal(eng3.matvec_global(x),
                                  plain.matvec_global(x))


def test_bad_tune_knob_rejected(chain12, tune_off):
    _, op_t = chain12
    update_config(tune="bogus")
    with pytest.raises(ValueError, match="unknown tune setting"):
        _build(op_t, D=2)


def test_live_rekey_lands_bit_equal_to_hand_set(chain12, tune_off,
                                                monkeypatch):
    """tune=live with rates 10⁶× too fast: every window's measured/priced
    ratio leaves the drift band and the posterior walks toward the
    measured walls.  A rate error that scales every rate alike moves no
    argmin (the search re-picks the current knobs), so the proposal is
    injected at a window boundary, through the engine's own observe path;
    the next apply runs at the new knobs — bit-equal to a hand-set engine
    at them — and a retune event records it."""
    _, op_t = chain12
    monkeypatch.setenv("DMT_TUNE_WINDOW", "2")
    fast = {"gather_rows_per_s": 1e15, "h2d_bytes_per_s": 1e15,
            "exchange_bytes_per_s": 1e15, "flops_per_s": 1e15,
            "backend": "cpu", "source": "test"}
    from distributed_matvec_tpu_torch.obs import roofline
    monkeypatch.setattr(roofline, "resolve_calibration",
                        lambda *a, **k: dict(fast))
    update_config(tune="live")
    eng = _build(op_t, D=2)
    first = eng._tuned
    # every apply reaches the tuner with the same measured wall (and no
    # directly measured phase): the ratio's fall then follows from the
    # posterior update alone, not from the CPU's load during the test
    measure = eng._tuner.observe

    def fixed_wall(counts, wall_ms, measured=None):
        return measure(counts, 5.0, None)

    monkeypatch.setattr(eng._tuner, "observe", fixed_wall)
    x = np.random.default_rng(2).random(op_t.basis.number_states) - 0.5
    xh = eng.to_hashed(x)
    ratios = []
    for _ in range(7):
        eng.matvec(xh)
        if eng._tuner.window_closed:
            ratios.append(eng._tuner.last_ratio)
    assert len(ratios) == 3 and ratios[0] > tune.DRIFT_BAND[1]
    assert all(b < a for a, b in zip(ratios, ratios[1:])), ratios
    assert eng._retune_pending is None and eng._tuned.same_knobs(first)
    cand = [c for c in tune.knob_grid(eng._tune_stats(), "streamed")
            if not c.same_knobs(first)][0]
    observe = eng._tuner.observe

    def proposing(*a, **k):
        observe(*a, **k)
        return cand if eng._tuner.window_closed else None

    monkeypatch.setattr(eng._tuner, "observe", proposing)
    while eng._retune_pending is None:
        eng.matvec(xh)
    y = eng.matvec(xh)                        # the re-key lands here
    assert eng._tuned.same_knobs(cand)
    assert eng.stream_compress == cand.stream_compress
    assert obs.events("retune")[-1]["new_token"] == cand.token()
    update_config(tune="off")
    twin = _build(op_t, D=2, batch_size=eng.batch_size,
                  pipeline_depth=cand.pipeline_depth,
                  stream_compress=cand.stream_compress)
    np.testing.assert_array_equal(y.numpy(), twin.matvec(xh).numpy())


def test_serve_pool_retunes_between_jobs(chain12, tune_off):
    """The pool's safe boundary: a warm engine with a pending re-tune
    rebuilds on acquire, before the next job's applies."""
    from distributed_matvec_tpu_torch.serve import EnginePool, JobSpec

    _, op_t = chain12
    update_config(tune="static")
    eng = _build(op_t, D=1)
    cand = [c for c in tune.knob_grid(eng._tune_stats(), "streamed")
            if not c.same_knobs(eng._tuned)][0]
    pool = EnginePool(device="cpu", builder=lambda spec: eng)
    spec = JobSpec(job_id="a", basis={"number_spins": 12,
                                      "hamming_weight": 6})
    assert pool.acquire(spec) is eng
    eng._retune_pending = cand
    assert pool.acquire(spec) is eng and eng._tuned.same_knobs(cand)
    assert eng._retune_pending is None
