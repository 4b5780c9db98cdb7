"""``spans.py`` on the CPU: the device's idle time cut at span boundaries
and given to the innermost span, on synthetic profiles and on the
program's own spans in a profiler window; the readers' None and 0.0."""

import os
from types import SimpleNamespace

import pytest

import harness
import spans
import tracing

HERE = os.path.dirname(os.path.abspath(__file__))


def _read(name, ctx):
    return harness.load_reader(os.path.dirname(HERE), name)(ctx)


def _span(name, a, b, kind=None, **attrs):
    return (name, kind or name, a, b, attrs)


def test_pieces_sum_to_the_idle_time():
    dev = [(10, 20, "k"), (15, 30, "k"), (50, 60, "k"), (95, 130, "k")]
    sp = [_span("lanczos", 0, 100, "solve"),
          _span("iteration", 5, 70),
          _span("apply", 5, 40, columns=2),
          _span("terms", 8, 25, "detail"),
          _span("obs", 35, 40, "detail"),
          _span("algebra", 40, 70, "detail"),
          _span("check", 70, 90)]
    r = spans.attribute(dev, sp, 0, 100)
    # idle: [0, 10) [30, 50) [60, 95); apply starts with iteration, so
    # [5, 8) is the apply's
    assert r["idle_us"] == 65
    assert sum(r["by_span"].values()) == r["idle_us"]
    assert r["by_span"] == {"lanczos": 5 + 5, "apply": 3 + 5,
                            "terms": 2, "obs": 5, "algebra": 10 + 10,
                            "check": 20}
    assert r["apply_us"] == 3 + 2 + 5 + 5
    assert r["solver_us"] == r["idle_us"] - r["apply_us"]
    assert (r["n_apply"], r["n_solve"], r["columns"]) == (1, 1, 2)


def test_an_idle_interval_is_split_at_a_span_boundary():
    sp = [_span("apply", 0, 20), _span("obs", 15, 20, "detail")]
    r = spans.attribute([(0, 10, "k"), (30, 40, "k")], sp, 0, 40)
    # idle [10, 30): apply 10–15, obs 15–20, outside 20–30
    assert r["by_span"] == {"apply": 5, "obs": 5, spans.OUTSIDE: 10}
    assert r["apply_us"] == 10 and r["solver_us"] == 0
    assert r["idle_us"] == 20


def test_spans_and_intervals_are_clipped_to_the_segment():
    sp = [_span("apply", -50, 150), _span("fetch", 95, 105, "detail")]
    r = spans.attribute([(-10, 5, "k"), (99, 200, "k")], sp, 0, 100)
    assert r["idle_us"] == 94
    assert r["by_span"] == {"apply": 90, "fetch": 4}
    assert spans.idle_intervals([], 0, 7) == [(0, 7)]


def test_equal_boundaries_nest():
    """Spans that start or end on one instant still nest: the outer is
    pushed first and popped last."""
    sp = [_span("apply", 0, 10), _span("produce", 0, 5, "detail"),
          _span("consume", 5, 10, "detail")]
    r = spans.attribute([], sp, 0, 10)
    assert r["by_span"] == {"produce": 5, "consume": 5}
    assert r["apply_us"] == 10


def _ctx(result, columns=4):
    return SimpleNamespace(idle_by_span=result,
                           profile={"columns": columns},
                           loop=SimpleNamespace(segment=None))


def test_readers_none_only_where_the_spans_are_missing():
    empty = spans.attribute([(0, 10, "k")], [], 0, 10)
    assert _read("idle_apply_ms", _ctx(empty)) is None
    assert _read("idle_solver_ms", _ctx(empty)) is None
    busy = spans.attribute([(0, 10, "k")], [
        _span("lanczos", 0, 10, "solve"), _span("apply", 0, 10)], 0, 10)
    assert _read("idle_apply_ms", _ctx(busy)) == 0.0
    assert _read("idle_solver_ms", _ctx(busy)) == 0.0
    idle = spans.attribute([], [_span("lanczos", 0, 8000, "solve"),
                                _span("apply", 0, 2000)], 0, 8000)
    assert _read("idle_apply_ms", _ctx(idle)) == 0.5
    assert _read("idle_solver_ms", _ctx(idle)) == 1.5
    no_trace = SimpleNamespace(profile=None,
                               loop=SimpleNamespace(segment=None))
    assert _read("idle_apply_ms", no_trace) is None


@pytest.fixture
def program(monkeypatch):
    import torch

    from distributed_matvec_tpu_torch import DistributedEngine, obs
    from distributed_matvec_tpu_torch.models.lattices import \
        heisenberg_chain

    monkeypatch.setenv("DMT_ARTIFACT_CACHE", "off")
    obs.reset_all()
    op = heisenberg_chain(16, symmetric=True)
    op.basis.build()
    eng = DistributedEngine(op, n_devices=1, mode="streamed",
                            stream_compress="lossless", batch_size=32,
                            device="cpu")
    xh = torch.randn((1, eng.shard_size, 4), dtype=torch.float64)
    yield eng, xh
    obs.reset_all()


def test_the_programs_spans_in_a_segment(program, capsys):
    """Three calls of 4 columns in a CPU profiler window: every span
    overlapping the window is read, the ``apply`` spans' columns add up
    to the segment's, and with no device work the whole segment is idle,
    all of it put down to some span or ``outside``."""
    eng, xh = program
    eng.matvec(xh)
    seg = tracing.Segment(lambda: None)
    seg.start()
    for _ in range(3):
        eng.matvec(xh)
    seg.stop()
    eng.matvec(xh)
    got = spans.program_spans(*seg.wall)
    names = [s[0] for s in got]
    assert names.count("apply") == 3
    assert names.count("produce") == 3 * eng.nchunks
    ctx = SimpleNamespace(profile={"columns": 12}, loop=SimpleNamespace(
        segment=seg))
    r = spans.segment_idle(ctx)
    assert spans.segment_idle(ctx) is r
    assert r["columns"] == 12
    # µs since the epoch as doubles: a quarter of a µs apart
    w = (seg.wall[1] - seg.wall[0]) * 1e6
    assert r["idle_us"] == pytest.approx(w, abs=1.0)
    assert sum(r["by_span"].values()) == pytest.approx(r["idle_us"],
                                                       abs=1e-6)
    assert {"fetch", "produce", "consume"} <= set(r["by_span"])
    assert _read("idle_apply_ms", ctx) == pytest.approx(
        r["apply_us"] * 1e-3 / 12)
    line = [x for x in capsys.readouterr().err.splitlines()
            if x.startswith("idle_by_span ")]
    assert len(line) == 1 and '"apply_host_ms_after"' in line[0]


def test_encode_s_reads_the_programs_stopwatch(program):
    eng, _ = program
    assert _read("encode_s", SimpleNamespace(engine=eng)) == \
        eng.timings["plan_encode_s"] > 0
    assert _read("encode_s", SimpleNamespace(engine=None)) is None


def test_a_program_without_detail_spans_reads_the_same_metrics(
        program, monkeypatch):
    """The metrics read the regular spans' events alone: a program that
    records no detail spans (the parent of this reader) gives the same
    numbers, and only the breakdown by innermost span is coarser."""
    from distributed_matvec_tpu_torch.obs import trace

    eng, xh = program
    eng.matvec(xh)
    seg = tracing.Segment(lambda: None)
    seg.start()
    for _ in range(2):
        eng.matvec(xh)
    seg.stop()
    full = spans.attribute([], spans.program_spans(*seg.wall),
                           *(w * 1e6 for w in seg.wall))
    monkeypatch.delattr(trace, "detail_spans")
    got = spans.program_spans(*seg.wall)
    assert {(s[0], s[1]) for s in got} == {("apply", "apply")}
    bare = spans.attribute([], got, *(w * 1e6 for w in seg.wall))
    for key in ("idle_us", "apply_us", "solver_us", "n_apply", "columns"):
        assert bare[key] == pytest.approx(full[key], abs=1e-3)
    assert set(bare["by_span"]) <= {"apply", spans.OUTSIDE}
    assert "produce" in full["by_span"]
