"""The port's spans on the CPU: the detail spans below ``apply`` and inside
a solver's step are recorded only while a ``torch.profiler`` window records
(and emit no event), one ``fetch``/``produce``/``consume`` triple per
chunk of a streamed apply, one ``algebra`` per Lanczos step and one
``check`` per convergence-check block; the ``apply`` span's ``columns``;
the engine build's ``plan_encode`` scope as the one stopwatch of
``timings["plan_encode_s"]``.  The card's check of the clock is in
``test_torch_cuda.py``."""

from collections import Counter

import pytest
import torch

from distributed_matvec_tpu_torch import (DistributedEngine, LocalEngine,
                                          lanczos, obs)
from distributed_matvec_tpu_torch.models.lattices import heisenberg_chain
from distributed_matvec_tpu_torch.obs import trace
from distributed_matvec_tpu_torch.utils.timers import TreeTimer

CPU = torch.profiler.ProfilerActivity.CPU
#: a span event's ``t0`` is rounded to the µs, its ``dur_ms`` to 0.1 µs
ROUND_S = 1e-6


@pytest.fixture
def clean(monkeypatch):
    monkeypatch.delenv("DMT_OBS", raising=False)
    monkeypatch.delenv("DMT_TRACE", raising=False)
    monkeypatch.delenv("DMT_PROFILE", raising=False)
    obs.reset_all()
    yield monkeypatch
    obs.reset_all()


@pytest.fixture(scope="module")
def chain16():
    op = heisenberg_chain(16, symmetric=True)
    op.basis.build()
    return op


def _streamed(op, **kw):
    return DistributedEngine(op, n_devices=1, mode="streamed",
                             stream_compress="lossless", batch_size=32,
                             device="cpu", **kw)


def _window(fn):
    """``fn()`` inside a CPU profiler window: the detail spans recorded in
    it, and the ``span`` events of the regular spans that closed in it."""
    n0 = len(obs.events("span"))
    with torch.profiler.profile(activities=[CPU]):
        t0 = trace.clock()
        fn()
        t1 = trace.clock()
    return trace.detail_spans(t0, t1), obs.events("span")[n0:]


def _names(spans):
    return Counter(s["name"] for s in spans)


def _inside(detail, event):
    """Whether a detail span lies inside a span event's interval."""
    t0 = event["t0"]
    t1 = t0 + event["dur_ms"] * 1e-3
    return t0 - ROUND_S <= detail["t0"] <= detail["t1"] <= t1 + ROUND_S


def test_detail_spans_only_inside_a_profiler_window(clean, chain16):
    eng = LocalEngine(chain16, device="cpu")
    x = torch.randn(chain16.basis.number_states, dtype=torch.float64)
    eng.matvec(x)
    assert not trace.profiling()
    assert trace.detail_spans() == []
    got, _ = _window(lambda: eng.matvec(x))
    assert _names(got)["terms"] == 1
    eng.matvec(x)
    assert len(trace.detail_spans()) == len(got)


def test_no_event_below_apply(clean, chain16):
    """A profiled apply emits the same events as an unprofiled one: the
    detail spans only fill the trace module's buffer."""
    eng = _streamed(chain16)
    xh = eng.random_hashed(0)
    eng.matvec(xh)
    n0 = len(obs.events())
    eng.matvec(xh)
    plain = [e["kind"] for e in obs.events()[n0:]]
    n1 = len(obs.events())
    _window(lambda: eng.matvec(xh))
    assert [e["kind"] for e in obs.events()[n1:]] == plain
    assert [e["name"] for e in obs.events("span")[-2:]] == ["apply"] * 2


def test_ell_apply_spans_nest_under_apply(clean, chain16):
    eng = LocalEngine(chain16, device="cpu")
    x = torch.randn(chain16.basis.number_states, 4, dtype=torch.float64)
    detail, events = _window(lambda: eng.matvec(x))
    (app,) = [e for e in events if e["name"] == "apply"]
    assert app["cat"] == "apply" and app["columns"] == 4
    assert "chunks" not in app
    want = {"terms", "obs"} | ({"tail"} if eng._ell_tail is not None
                               else set())
    assert {s["name"] for s in detail} == want
    for s in detail:
        assert s["parent_span_id"] == app["span_id"]
        assert _inside(s, app)
    (terms,) = [s for s in detail if s["name"] == "terms"]
    assert terms["attr"] == eng.ell_split[0]


@pytest.mark.parametrize("columns", [1, 4, 6])
def test_streamed_apply_one_triple_per_chunk(clean, chain16, columns):
    eng = _streamed(chain16)
    shape = (1, eng.shard_size) + ((columns,) if columns > 1 else ())
    xh = torch.randn(shape, dtype=torch.float64)
    detail, events = _window(lambda: eng.matvec(xh))
    n = eng.nchunks
    groups = -(-columns // 4)
    (app,) = [e for e in events if e["name"] == "apply"]
    assert app["columns"] == columns
    names = _names(detail)
    assert n > 1
    for phase in ("fetch", "produce", "consume"):
        assert names[phase] == n * groups
        assert sorted(s["attr"] for s in detail
                      if s["name"] == phase) == sorted(
            list(range(n)) * groups)
    assert names["diag_add"] == groups and names["obs"] == 1
    assert all(s["parent_span_id"] == app["span_id"] for s in detail)
    # per chunk in order: fetched, produced, consumed
    order = sorted((s["t0"], s["name"], s["attr"]) for s in detail
                   if s["name"] in ("fetch", "produce", "consume"))
    assert [o[1:] for o in order[:3]] == [("fetch", 0), ("produce", 0),
                                          ("consume", 0)]


def test_pipelined_streamed_apply_consumes_every_chunk(clean, chain16):
    eng = _streamed(chain16, pipeline_depth=3)
    xh = eng.random_hashed(0)
    names = _names(_window(lambda: eng.matvec(xh))[0])
    assert names["produce"] == names["consume"] == names["fetch"] \
        == eng.nchunks


def test_lanczos_algebra_per_step_and_check_per_block(clean, chain16):
    eng = LocalEngine(chain16, device="cpu")
    x = torch.randn(chain16.basis.number_states, dtype=torch.float64)
    box = {}
    detail, events = _window(lambda: box.update(r=lanczos(
        eng.matvec, v0=x, k=1, check_every=8, reorth="full")))
    r = box["r"]
    names, regular = _names(detail), _names(events)
    blocks = -(-r.num_iters // 8)
    assert names["algebra"] == regular["apply"] == r.num_iters
    assert names["check"] == regular["iteration"] == blocks
    (solve,) = [e for e in events if e["cat"] == "solve"]
    ids = {e["span_id"]: e for e in events}
    for s in detail:
        if s["name"] == "check":
            assert s["parent_span_id"] == solve["span_id"]
        if s["name"] == "algebra":
            assert ids[s["parent_span_id"]]["name"] == "iteration"
            assert _inside(s, ids[s["parent_span_id"]])
    steps = sorted(s["attr"] for s in detail if s["name"] == "algebra")
    assert steps == list(range(r.num_iters))
    checks = [s["attr"] for s in detail if s["name"] == "check"]
    assert checks == sorted(checks) and checks[-1] == r.num_iters


def test_no_detail_spans_with_obs_off(clean, chain16):
    clean.setenv("DMT_OBS", "off")
    eng = LocalEngine(chain16, device="cpu")
    x = torch.randn(chain16.basis.number_states, dtype=torch.float64)
    assert _window(lambda: lanczos(eng.matvec, v0=x, k=1)) == ([], [])


def test_setup_one_stopwatch_and_no_apply_scope(clean, chain16):
    """The engines' timers are the build's one stopwatch: the plan's build
    and encode seconds in ``timings`` are their scopes' own; set-up opens
    no span, and an apply adds no scope to the tree."""
    eng = _streamed(chain16)
    loc = LocalEngine(chain16, device="cpu")
    assert eng.timings["plan_encode_s"] == eng.timer.last("plan_encode") > 0
    assert eng.timings["plan_build_s"] == eng.timer.last("build_plan") > 0
    assert obs.events("span") == []
    loc.matvec(torch.ones(chain16.basis.number_states, dtype=torch.float64))
    eng.matvec(eng.random_hashed(0))
    assert "matvec" not in loc.timer.root.children
    assert "matvec" not in eng.timer.root.children


def test_timer_last_reads_the_latest_run(clean):
    t = TreeTimer("x")
    for _ in range(3):
        with t.scope("outer"):
            with t.scope("inner"):
                pass
    inner = t.root.children["outer"].children["inner"]
    assert inner.count == 3 and t.last("outer", "inner") == inner.samples[-1]
    assert t.scope_total("outer", "inner") == pytest.approx(
        sum(inner.samples))
    assert t.last("missing") == 0.0 and t.scope_total("missing") == 0.0
    assert obs.events("span") == []


def test_detail_spans_window_filter(clean):
    with torch.profiler.profile(activities=[CPU]):
        # no regular span open: nothing to hang a detail span on
        assert trace.detail_start() is None
        with trace.span("apply", kind="apply"):
            a = trace.detail_start()
            b = trace.detail_end("one", a, 1)
            trace.detail_end("two", b)
    one, two = sorted(trace.detail_spans(), key=lambda s: s["t0"])
    (app,) = obs.events("span")
    assert (one["name"], one["attr"], two["attr"]) == ("one", 1, None)
    assert one["parent_span_id"] == two["parent_span_id"] == app["span_id"]
    assert one["t1"] == two["t0"]
    assert [s["name"] for s in trace.detail_spans(two["t0"], None)] == [
        "one", "two"]
    assert trace.detail_spans(one["t1"] + 10, None) == []
    assert trace.detail_end("none", None) is None


def test_profiler_flag_without_the_python_attribute(clean):
    """Where ``torch.autograd.profiler`` lacks ``_is_profiler_enabled``,
    the flag falls back to the C++ query."""
    import torch.autograd.profiler as prof_mod

    saved = prof_mod._is_profiler_enabled
    del prof_mod._is_profiler_enabled
    trace._flag = trace._bind_flag
    try:
        assert not trace.profiling()
        assert trace._flag is torch.autograd._profiler_enabled
        with torch.profiler.profile(activities=[CPU]):
            assert trace.profiling()
        assert not trace.profiling()
    finally:
        prof_mod._is_profiler_enabled = saved
        trace._flag = trace._bind_flag
