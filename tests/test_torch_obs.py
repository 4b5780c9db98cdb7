"""The port's telemetry core (``obs/``) against the JAX package's: the same
registry snapshot and OpenMetrics text for the same instrument calls, the
same SLO verdicts for the same events, the same event envelope, spans
parented alike, and the crash bundle, the exporter and the preemption
latch's flight hook on the port's own."""

import json
import os
import signal
import threading
import urllib.request

import pytest

import distributed_matvec_tpu.obs as jobs
import distributed_matvec_tpu_torch.obs as tobs
from distributed_matvec_tpu.obs import slo as jslo
from distributed_matvec_tpu_torch.obs import slo as tslo
from distributed_matvec_tpu_torch.utils import preempt


@pytest.fixture
def clean():
    jobs.reset_all()
    tobs.reset_all()
    yield
    jobs.reset_all()
    tobs.reset_all()


def _calls_basic(o):
    o.counter("serve_total").inc(3)
    o.counter("artifact_cache", kind="structure", event="hit").inc()
    o.gauge("engine_pool_bytes").set(0.1 + 0.2)        # not repr-trivial
    o.gauge("job_queue_depth").set(4)


def _calls_hist(o):
    h = o.histogram("matvec_apply_ms", engine="local")
    for v in (0.05, 0.3, 7.0, 7.0, 12_000.0):
        h.observe(v)
    g = o.histogram("serve_latency_ms", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        g.observe(v)


def _calls_labels(o):
    o.counter("odd", path='a "quoted"\nvalue', z="1").inc(2.5)
    o.gauge("slo_alert_count").set(float("inf"))
    o.counter("odd", path="plain", z="1").inc()


SEQUENCES = {"basic": _calls_basic, "hist": _calls_hist,
             "labels": _calls_labels,
             "all": lambda o: (_calls_basic(o), _calls_hist(o),
                               _calls_labels(o))}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_snapshot_and_openmetrics_equal_jax(seq, clean):
    SEQUENCES[seq](jobs)
    SEQUENCES[seq](tobs)
    jsnap = jobs.metrics.snapshot()
    tsnap = tobs.metrics.snapshot()
    assert tsnap == jsnap
    info = {"trace_id": "abc123", "job_id": "j1"}
    for extra in (None, {"rank": "0"}, {"rank": "3"}):
        assert tobs.render_openmetrics(tsnap, extra_labels=extra,
                                       info=info) \
            == jobs.render_openmetrics(jsnap, extra_labels=extra, info=info)
    text = tobs.render_openmetrics(tsnap)
    assert tobs.parse_openmetrics(text) == jobs.parse_openmetrics(text)
    r0 = tobs.render_openmetrics(tsnap, extra_labels={"rank": "0"})
    r1 = tobs.render_openmetrics(tsnap, extra_labels={"rank": "1"})
    assert tobs.merge_openmetrics([r0, r1]) \
        == jobs.merge_openmetrics([r0, r1])


def test_render_parse_roundtrip(clean):
    SEQUENCES["basic"](tobs)
    SEQUENCES["hist"](tobs)
    snap = tobs.snapshot()
    assert tobs.parse_openmetrics(tobs.render_openmetrics(snap)) == snap


# -- SLO evaluation --------------------------------------------------------------

def _apply_events(values, t0=1000.0, dt=1.0):
    return [{"kind": "matvec_apply", "ts": t0 + i * dt, "wall_ms": v}
            for i, v in enumerate(values)]


def _done_events(n, dt, t0=1000.0):
    return [{"kind": "job_event", "status": "done", "ts": t0 + dt * i,
             "latency_ms": 100.0 + i} for i in range(n)]


EVENT_SETS = {
    "empty": [],
    "threshold_fires": _apply_events([1.0] * 7 + [100.0] * 3),
    "auto_baseline": _apply_events([10.0] * 20 + [500.0] * 10),
    "multiwindow": _apply_events([1.0] * 3000, t0=0.0)
    + _apply_events([100.0] * 10, t0=3005.0),
    "fault": [{"kind": "fault_injected", "ts": 1.0, "site": "x"}],
    "serve_fast": _done_events(6, 0.4),
    "serve_slow": _done_events(6, 30.0),
    "spans": [{"kind": "span", "cat": "iteration", "ts": 5.0 + i,
               "dur_ms": 3.0 + (i % 4) * 9.0} for i in range(40)],
}

SPEC_SETS = {
    "default": lambda m: m.default_slos(),
    "pinned": lambda m: m.default_slos(
        {"serve_p99_latency_ms": 101.5, "serve_solves_per_min": 60.0,
         "steady_apply_ms": 10.0, "faults_injected": 2.0}),
    "custom": lambda m: [
        m.SloSpec("steady_apply_ms", kind="matvec_apply", field="wall_ms",
                  target=10.0, windows=((60.0, 10.0), (3600.0, 30.0))),
        m.SloSpec("serve_solves_per_min", kind="job_event",
                  where={"status": "done"}, mode="rate_min")],
}


@pytest.mark.parametrize("specs", sorted(SPEC_SETS))
@pytest.mark.parametrize("events", sorted(EVENT_SETS))
def test_slo_evaluate_equals_jax(events, specs):
    evs = EVENT_SETS[events]
    for now in (None, 4000.0):
        got = tslo.evaluate(evs, SPEC_SETS[specs](tslo), now=now)
        want = jslo.evaluate(evs, SPEC_SETS[specs](jslo), now=now)
        assert got == want


def test_check_slos_alert_transitions(clean):
    spec = tslo.SloSpec("steady_apply_ms", kind="matvec_apply",
                        field="wall_ms", target=10.0)
    st, = tobs.check_slos([spec], events=_apply_events([100.0] * 5))
    assert st["state"] == "firing"
    st, = tobs.check_slos([spec], events=_apply_events([100.0] * 5))
    alerts = tobs.events("slo_alert")
    assert [a["state"] for a in alerts] == ["firing"]
    assert tobs.snapshot()["counters"]["slo_alert_count"] == 1
    tobs.check_slos([spec], events=_apply_events([1.0] * 5))
    assert [a["state"] for a in tobs.events("slo_alert")] \
        == ["firing", "clear"]


# -- events, trace ids and spans -------------------------------------------------

def test_event_envelope_matches_jax(clean):
    tev = tobs.emit("engine_pool", event="build", seq=99, rank=7, x=1)
    jev = jobs.emit("engine_pool", event="build", seq=99, rank=7, x=1)
    # the envelope wins over colliding payload fields, in both packages
    assert tev["seq"] == 0 and tev["rank"] == 0 and tev["x"] == 1
    assert set(tev) == set(jev)
    for k in ("seq", "proc", "rank", "n_ranks", "kind", "event", "x"):
        assert tev[k] == jev[k], k


def test_span_parentage_and_job_scope(clean):
    with tobs.span("serve_batch", kind="batch", jobs=2):
        outer = tobs.current_span_id()
        with tobs.job_scope("job-a"):
            tobs.emit_span("job:job-a", "job", t0=1.0, dur_ms=5.0)
            tobs.emit("job_event", job_id="spoofed", status="done")
        with tobs.span("inner", kind="iteration"):
            tobs.emit("note")
    spans = {e["name"]: e for e in tobs.events("span")}
    assert spans["serve_batch"]["parent_span_id"] is None
    assert spans["serve_batch"]["span_id"] == outer
    assert spans["job:job-a"]["parent_span_id"] == outer
    assert spans["job:job-a"]["job_id"] == "job-a"
    assert spans["job:job-a"]["dur_ms"] == 5.0
    assert spans["inner"]["parent_span_id"] == outer
    ev, = [e for e in tobs.events("job_event")]
    assert ev["job_id"] == "job-a" and ev["span_id"] == outer
    note, = tobs.events("note")
    assert note["span_id"] == spans["inner"]["span_id"]
    # outside the scope the envelope job id is the trace id again
    assert tobs.emit("after")["job_id"] == tobs.trace_id()
    assert tobs.open_spans() == []


def test_span_ids_unique_with_one_random_draw(clean, monkeypatch):
    """Span ids keep the JAX form ``<ordinal hex>-<4 hex>`` and stay
    unique, but the random hex is drawn once per process (and again after
    a reset), not once per span: ``os.urandom`` is slow on some hosts."""
    import re

    from distributed_matvec_tpu_torch.obs import trace

    tobs.trace_id()
    draws = []
    orig = trace._rand_id

    def counting(nbytes=8):
        draws.append(nbytes)
        return orig(nbytes)
    monkeypatch.setattr(trace, "_rand_id", counting)
    ids = []
    for _ in range(50):
        with tobs.span("apply", kind="apply"):
            ids.append(tobs.current_span_id())
    assert len(set(ids)) == 50
    assert all(re.fullmatch(r"[0-9a-f]+-[0-9a-f]{4}", i) for i in ids)
    assert draws == [2]
    tobs.reset_trace()
    with tobs.span("apply", kind="apply"):
        pass
    assert draws.count(2) == 2


def test_jsonl_sink_and_trace_id_agreement(clean, monkeypatch, tmp_path):
    run = tmp_path / "run"
    monkeypatch.setenv("DMT_OBS_DIR", str(run))
    tobs.emit("hello", a=1)
    tobs.flush()
    path = run / "rank_0" / "events.jsonl"
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert lines[-1]["kind"] == "hello" and lines[-1]["a"] == 1
    tid = (run / "trace_id").read_text().strip()
    assert lines[-1]["trace_id"] == tid
    # a second process of the same run (here: the trace layer reset)
    # reads the agreed id from the run directory
    tobs.reset_trace()
    assert tobs.trace_id() == tid


def test_obs_off_is_inert(monkeypatch, tmp_path):
    monkeypatch.setenv("DMT_OBS", "off")
    monkeypatch.setenv("DMT_OBS_DIR", str(tmp_path / "run"))
    assert tobs.emit("x") is None
    assert tobs.counter("c") is tobs.NULL
    assert tobs.start_exporter(port=0) is None
    assert tobs.flight_dump("preempt") is None
    assert tobs.write_textfile() is None
    with tobs.span("s"):
        assert tobs.current_span_id() is None
    assert not (tmp_path / "run").exists()


def test_annotate_is_a_profiler_range(clean):
    import torch

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with tobs.annotate("serve_batch_range"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "serve_batch_range" in names


# -- exporter, crash bundles, the preemption hook --------------------------------

def test_http_scrape_and_textfile(clean, monkeypatch, tmp_path):
    monkeypatch.setenv("DMT_OBS_DIR", str(tmp_path / "run"))
    _calls_basic(tobs)
    _calls_hist(tobs)
    snap = tobs.snapshot()
    server = tobs.start_exporter(port=0)
    try:
        url = f"http://127.0.0.1:{server.port}"
        body = urllib.request.urlopen(f"{url}/metrics",
                                      timeout=10).read().decode()
        assert tobs.parse_openmetrics(body) == snap
        health = json.loads(urllib.request.urlopen(
            f"{url}/healthz", timeout=10).read().decode())
        assert health["status"] == "ok" and health["rank"] == 0
        assert health["trace_id"] == tobs.trace_id()
    finally:
        tobs.stop_exporter()
    path = tobs.write_textfile()
    with open(path) as f:
        assert tobs.parse_openmetrics(f.read()) == snap


def test_flight_bundle_roundtrip(clean, monkeypatch, tmp_path):
    monkeypatch.setenv("DMT_OBS_DIR", str(tmp_path / "run"))
    with tobs.span("serve_batch", kind="batch"):
        tobs.emit("job_event", status="running")
        path = tobs.flight_dump("preempt", exit_code=75, signum=15,
                                rank=9)
    assert path and tobs.verify_bundle(path)
    b = tobs.read_bundle(path)
    assert b["reason"] == "preempt" and b["exit_code"] == 75
    assert b["rank"] == 0                    # identity keys win
    assert b["span_path"] == "serve_batch"
    assert b["open_spans"][0]["name"] == "serve_batch"
    assert b["events"][-1]["kind"] == "job_event"
    assert b["config"]["serve_block_width"] == 6
    assert tobs.flight_dump("preempt") is None         # once per reason
    assert tobs.list_bundles() == [path]
    with open(path, "ab") as f:
        f.write(b" ")
    assert not tobs.verify_bundle(path)
    ctx = tobs.install_fatal_handlers()
    assert ctx and os.path.exists(
        os.path.join(os.path.dirname(ctx), "context.json"))


def test_preempt_latch_fires_the_flight_hook(clean, monkeypatch, tmp_path):
    """The first observation of the latch writes a ``preempt`` bundle (the
    signal handler itself stays I/O-free)."""
    monkeypatch.setenv("DMT_OBS_DIR", str(tmp_path / "run"))
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers install on the main thread only")
    preempt.reset()
    installed = signal.SIGTERM not in preempt._prev
    found = signal.getsignal(signal.SIGTERM)
    assert preempt.ensure_installed()
    # another package's latch (the JAX package's, installed by a JAX solve
    # in this process after the port's) may hold SIGTERM now: the signal
    # must reach the port's
    signal.signal(signal.SIGTERM, preempt._handler)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert preempt.requested() and preempt.signal_number() == \
            signal.SIGTERM
        bundles = tobs.list_bundles()
        assert len(bundles) == 1 and "preempt-" in bundles[0]
        assert tobs.read_bundle(bundles[0])["exit_code"] == \
            preempt.EXIT_PREEMPTED
    finally:
        preempt.reset()
        # leave the process's disposition, and the latch's record, as found
        signal.signal(signal.SIGTERM, found)
        if installed:
            preempt._prev.pop(signal.SIGTERM)
