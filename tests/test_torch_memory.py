"""The port's memory layer (``obs/memory.py``) against the JAX package's.

* the ledger semantics of the JAX ``tests/test_memory_obs.py`` cases, run
  on the port's module (track/tree/total/release, tensor nests, the
  disabled no-op);
* the ledger's paths for an ell engine, a streamed engine, a Lanczos and
  a block-Lanczos solve equal the JAX ledger's paths (instance numbers
  aside); the bytes are equal where the port's tensor has the JAX array's
  shape and dtype (the structure tables, the diagonal and the basis
  rows);
* ``remediation`` equals the JAX function on the same contexts;
* the watermark sampler soft-fails once without a card, and its cadence;
* OOM forensics: a ``torch.cuda.OutOfMemoryError`` in the build or an
  apply becomes ``OomError`` with the JAX report's keys and context, the
  failed frames' tensors released first; other errors and ``DMT_OBS=off``
  pass through untouched;
* the kernel analysis registry and sidecar; ``engine_init`` carries the
  JAX event's keys.
"""

import re

import numpy as np
import pytest
import torch

from distributed_matvec_tpu import obs as jax_obs
from distributed_matvec_tpu.obs import memory as JM
from distributed_matvec_tpu.parallel.distributed import \
    DistributedEngine as JaxEngine
from distributed_matvec_tpu.parallel.engine import LocalEngine as JaxLocal
from distributed_matvec_tpu.solve import lanczos as jax_lanczos
from distributed_matvec_tpu.solve import lanczos_block as jax_block
from distributed_matvec_tpu.utils.config import update_config as jax_update
from distributed_matvec_tpu_torch import (DistributedEngine, LocalEngine,
                                          lanczos, lanczos_block, obs)
from distributed_matvec_tpu_torch.obs import memory as M

from test_torch_solvers import Case


@pytest.fixture
def clean_obs():
    obs.reset_all()
    jax_obs.reset_all()
    yield
    obs.reset_all()
    jax_obs.reset_all()


@pytest.fixture(scope="module")
def case():
    return Case(10, 5, None, [], streamed=False)


def _norm(paths):
    return sorted(re.sub(r":\d+", ":N", p) for p in paths)


# ---------------------------------------------------------------------------
# ledger (JAX tests/test_memory_obs.py:51-101)


def test_ledger_track_tree_total_release(clean_obs):
    h = M.track("engine/local:0/structure/idx", 1000, device="device")
    M.track("engine/local:0/structure/coeff", 2000, handle=h)
    M.track("engine/local:0/diag", 500, handle=h)
    h2 = M.track("solver/lanczos:0/krylov_basis", 4000)
    assert M.ledger_total() == 7500
    assert M.ledger_total("engine/local:0/structure") == 3000
    assert M.ledger_total("engine") == 3500
    tree = M.ledger_tree()
    assert tree["children"]["engine"]["children"]["local:0"][
        "children"]["structure"]["bytes"] == 3000
    M.track("engine/local:0/structure/idx", 1500, handle=h)
    assert M.ledger_total("engine/local:0/structure") == 3500
    h2.set("solver/lanczos:0/krylov_basis", 8000)
    assert M.ledger_total("solver") == 8000
    h.release()
    assert M.ledger_total() == 8000
    h.release()
    h2.release()
    assert M.ledger_total() == 0
    M.track("a/b", 7)
    ev = M.emit_ledger("unit", n_states=3)
    assert ev["kind"] == "memory_ledger" and ev["total_bytes"] == 7
    assert ev["entries"]["a/b"]["bytes"] == 7 and ev["n_states"] == 3


def test_ledger_tree_equals_jax(clean_obs):
    """The same registrations give the same tree in both packages."""
    regs = [("engine/local:0/structure/idx", 1000, "device"),
            ("engine/local:0/diag", 500, "device"),
            ("plan/stream_plan:0/host", 3000, "host"),
            ("solver/lanczos:0/krylov_basis", 4000, "")]
    for mod in (M, JM):
        for path, b, dev in regs:
            mod.track(path, b, device=dev)
    assert M.ledger_tree() == JM.ledger_tree()
    assert M.ledger_total(device="host") == JM.ledger_total(device="host")


def test_ledger_tensor_nests(clean_obs):
    from distributed_matvec_tpu_torch.ops.kernels import device_tables
    from distributed_matvec_tpu_torch.models.basis import SpinBasis
    from distributed_matvec_tpu_torch.models.lattices import (
        chain_edges, heisenberg_from_edges)

    tree = {"a": torch.zeros(10, dtype=torch.float64),
            "b": (torch.zeros(4, dtype=torch.int32),
                  [torch.zeros(2, dtype=torch.float64)])}
    M.track_tree("x/t", tree)
    assert M.ledger_total("x") == 80 + 16 + 16
    op = heisenberg_from_edges(SpinBasis(6, 3), chain_edges(6))
    assert M.tensor_bytes(device_tables(op, "cpu")) > 0


def test_ledger_disabled_noop(clean_obs, monkeypatch):
    monkeypatch.setenv("DMT_OBS", "off")
    assert M.track("a/b", 100) is M.NULL_HANDLE
    assert M.track_tree("a/c", {}) is M.NULL_HANDLE
    assert M.ledger_total() == 0
    assert M.emit_ledger("unit") is None
    assert obs.events() == []


# ---------------------------------------------------------------------------
# the engines' and solvers' ledger paths against the JAX ledger


def test_ell_engine_ledger_equals_jax(clean_obs, case):
    eng = LocalEngine(case.op_t, device="cpu")
    jeng = JaxLocal(case.op_j)
    got = {p: e for p, e in M.ledger_entries().items()
           if p.startswith(f"engine/{eng._mem_instance}/")}
    want = {p: e for p, e in JM.ledger_entries().items()
            if p.startswith(f"engine/{jeng._mem_instance}/")}
    assert _norm(got) == _norm(want)
    byname = {re.sub(r":\d+", ":N", p): e["bytes"] for p, e in want.items()}
    for p, e in got.items():
        name = re.sub(r":\d+", ":N", p)
        if name.endswith(("operator_tables", "lookup")):
            # the port's own layouts: int64 term tables, and the lookup
            # pairs widened from u32 to int64 (the JAX [N, 2] u32 rows)
            continue
        assert e["bytes"] == byname[name], name
    ev = [e for e in obs.events("memory_ledger")][-1]
    jev = [e for e in jax_obs.events("memory_ledger")][-1]
    assert set(jev) - set(ev) <= {"query_capacity"}
    for k in ("mode", "n_states", "num_terms", "T0", "table_bytes",
              "n_padded", "batch_size"):
        assert ev[k] == jev[k], k
    init = obs.events("engine_init")[-1]
    jinit = jax_obs.events("engine_init")[-1]
    assert set(init) == set(jinit)
    assert init["mode"] == "ell" and init["engine"] == "local"


def test_streamed_engine_ledger_equals_jax(clean_obs, case):
    eng = DistributedEngine(case.op_t, mode="streamed",
                            stream_compress="lossless", batch_size=64,
                            device="cpu")
    jax_update(stream_compress="lossless")
    try:
        jeng = JaxEngine(case.op_j, n_devices=1, mode="streamed",
                         batch_size=64)
    finally:
        jax_update(stream_compress="off")
    got = [p for p in M.ledger_entries()
           if p.startswith(f"engine/{eng._mem_instance}/")
           or p.startswith("plan/")]
    want = [p for p in JM.ledger_entries()
            if p.startswith(f"engine/{jeng._mem_instance}/")
            or p.startswith("plan/")]
    assert _norm(got) == _norm(want)
    host = [e for p, e in M.ledger_entries().items()
            if p.startswith("plan/")][0]
    assert host["device"] == "host" and host["bytes"] == eng.plan_bytes
    # the build's staging entry was released with the build
    assert not any("staging" in p for p in M.ledger_entries())
    del eng
    import gc
    gc.collect()
    assert not any(p.startswith("plan/") for p in M.ledger_entries())


@pytest.mark.parametrize("kind", ["ell", "streamed"])
def test_applied_engine_is_not_held(clean_obs, case, kind):
    """An engine that applied, through its bound matvec and through a
    wrapped one under a solver's first-apply check, is freed on ``del``:
    nothing keeps it alive, and its ledger entries go with it."""
    import gc
    import weakref

    if kind == "ell":
        eng = LocalEngine(case.op_t, device="cpu")
        x = torch.ones(case.n, dtype=torch.float64)
    else:
        eng = DistributedEngine(case.op_t, mode="streamed",
                                stream_compress="lossless", batch_size=64,
                                device="cpu")
        x = eng.random_hashed(0)
    eng.matvec(x)
    if kind == "ell":
        lanczos(lambda v: eng.matvec(v), case.n, k=1, max_iters=8,
                device="cpu")
    else:
        lanczos(lambda v: eng.matvec(v), v0=eng.random_hashed(1), k=1,
                max_iters=8)
    inst = eng._mem_instance
    assert any(p.startswith(f"engine/{inst}/") for p in M.ledger_entries())
    ref = weakref.ref(eng)
    del eng
    gc.collect()
    assert ref() is None
    assert not any(p.startswith(f"engine/{inst}/")
                   for p in M.ledger_entries())


def test_solver_workspace_paths_equal_jax(clean_obs, case, monkeypatch):
    """The paths each solve registers (spied on ``track``) equal the JAX
    solvers'; the entries are released when the solves return."""
    seen = {"port": {}, "jax": {}}

    def spy(mod, key):
        orig = mod.track

        def track(path, nbytes, **kw):
            seen[key][path] = nbytes
            return orig(path, nbytes, **kw)
        monkeypatch.setattr(mod, "track", track)

    spy(M, "port")
    spy(JM, "jax")
    eng = LocalEngine(case.op_t, device="cpu")
    jeng = JaxLocal(case.op_j)
    n = case.n
    for lz, bl, mv, kw in ((lanczos, lanczos_block, eng.matvec,
                            {"device": "cpu"}),
                           (jax_lanczos, jax_block, jeng.matvec, {})):
        lz(mv, n, k=1, max_iters=32, tol=1e-10, seed=3, **kw)
        bl(mv, n, k=1, max_iters=8, seed=3, **kw)
    port = [p for p in seen["port"] if p.startswith("solver/")]
    jax = [p for p in seen["jax"] if p.startswith("solver/")]
    assert _norm(port) == _norm(jax)
    assert all(seen["port"][p] > 0 for p in port)
    assert M.ledger_total("solver") == 0


# ---------------------------------------------------------------------------
# remediation and OOM forensics


CONTEXTS = [dict(engine=e, mode=m, phase=ph, n_states=1000)
            for e in ("local", "distributed")
            for m in ("ell", "compact", "fused", "streamed", "hybrid")
            for ph in ("init", "apply")] + [{}]


@pytest.mark.parametrize("ctx", CONTEXTS)
def test_remediation_equals_jax(ctx):
    assert M.remediation(ctx) == JM.remediation(ctx)


def test_watermark_soft_fail_without_a_card(clean_obs):
    assert M.sample_watermark("unit") is None
    assert obs.events("memory_watermark") == []
    assert M.last_watermark() is None
    assert M.watermark_due(0) is False


def test_watermark_due_cadence(clean_obs, monkeypatch):
    from distributed_matvec_tpu_torch.utils.config import update_config

    monkeypatch.setattr(M, "_wm_unsupported", False)
    saved = update_config().memory_every
    update_config(memory_every=4)
    try:
        assert [i for i in range(9) if M.watermark_due(i)] == [0, 4, 8]
    finally:
        update_config(memory_every=saved)
    monkeypatch.setenv("DMT_OBS", "off")
    assert M.watermark_due(0) is False


def test_watermark_event_shape_with_fake_stats(clean_obs, monkeypatch):
    rows = [{"device": "cuda:0", "bytes_in_use": 100,
             "peak_bytes_in_use": 250, "bytes_reserved": 300,
             "bytes_free": 900, "bytes_limit": 1000}]
    monkeypatch.setattr(M, "_device_stats", lambda: rows)
    s = M.sample_watermark("unit", apply=3)
    assert (s["bytes_in_use"], s["peak_bytes"], s["bytes_free"],
            s["bytes_reserved"]) == (100, 250, 900, 300)
    ev = obs.events("memory_watermark")[-1]
    assert ev["tag"] == "unit" and ev["apply"] == 3
    assert obs.snapshot()["gauges"]["hbm_peak_bytes"] == 250


def _oom():
    return torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 11.09 GiB")


def test_oom_in_apply_report(clean_obs, case):
    eng = LocalEngine(case.op_t, device="cpu")
    x = torch.randn(case.n, dtype=torch.float64)

    def boom(_x, _check):
        raise _oom()

    eng._matvec_body = boom
    with pytest.raises(M.OomError) as exc_info:
        eng.matvec(x)
    err = exc_info.value
    assert isinstance(err.__cause__, torch.cuda.OutOfMemoryError)
    rep = err.report
    jrep = JM.build_memory_report(engine="local").to_dict()
    assert set(rep) == set(jrep)
    assert rep["context"] == {"engine": "local", "mode": "ell",
                              "phase": "apply", "n_states": case.n}
    assert rep["ledger_total_bytes"] == M.ledger_total() > 0
    assert rep["ledger"]["children"]["engine"]["bytes"] > 0
    assert rep["remediation"] == JM.remediation(rep["context"])
    assert "remediation" in str(err)
    ev = obs.events("memory_report")[-1]
    assert ev["level"] == "critical" and ev["context"]["engine"] == "local"
    assert obs.snapshot()["counters"]["oom_events"] == 1


def test_oom_in_build_names_a_tracked_ballast(clean_obs, case,
                                              monkeypatch):
    """An OOM raised in the structure build is ``phase=init`` with the
    low-memory-build lever; the ledger shows what else was resident."""
    ballast = torch.zeros(1000, dtype=torch.float64)
    h = M.track("ballast", M.tensor_bytes(ballast), device="device")
    monkeypatch.setattr(LocalEngine, "_build_ell",
                        lambda self: (_ for _ in ()).throw(_oom()))
    with pytest.raises(M.OomError) as exc_info:
        LocalEngine(case.op_t, device="cpu")
    rep = exc_info.value.report
    assert rep["context"]["phase"] == "init"
    assert rep["ledger"]["children"]["ballast"]["bytes"] == 8000
    assert any("ell_build_budget_gb" in r for r in rep["remediation"])
    h.release()


def test_oom_releases_failed_frames_first(clean_obs, case, monkeypatch):
    """The failed frame's tensors are freed before the report is built:
    a live traceback would keep them allocated."""
    import weakref

    held = []

    def build(self):
        big = torch.zeros(1 << 16, dtype=torch.float64)
        held.append(weakref.ref(big))
        raise _oom()

    seen = []
    orig = M.build_memory_report

    def report(**ctx):
        seen.append(held[0]() is None)
        return orig(**ctx)

    monkeypatch.setattr(LocalEngine, "_build_ell", build)
    monkeypatch.setattr(M, "build_memory_report", report)
    with pytest.raises(M.OomError):
        LocalEngine(case.op_t, device="cpu")
    assert seen == [True]


def test_distributed_oom_in_build_and_apply(clean_obs, case, monkeypatch):
    eng = DistributedEngine(case.op_t, n_devices=2, mode="ell",
                            batch_size=32, device="cpu")
    xh = eng.random_hashed(0)

    def boom(_x, _check):
        raise _oom()

    eng._matvec_body = boom
    with pytest.raises(M.OomError) as e1:
        eng.matvec(xh)
    assert e1.value.report["context"]["engine"] == "distributed"
    monkeypatch.setattr(DistributedEngine, "_build_stream_plan",
                        lambda self: (_ for _ in ()).throw(_oom()))
    with pytest.raises(M.OomError) as e2:
        DistributedEngine(case.op_t, mode="streamed", batch_size=32,
                          stream_compress="lossless", device="cpu")
    rep = e2.value.report
    assert rep["context"]["phase"] == "init"
    # a genuine OOM keeps the build's staging entry for the report
    assert any("staging" in p for p in M.ledger_entries())


def test_non_oom_errors_and_obs_off_pass_through(clean_obs, case,
                                                 monkeypatch):
    eng = LocalEngine(case.op_t, device="cpu")
    x = torch.randn(case.n, dtype=torch.float64)

    def bug(_x, _check):
        raise ValueError("plain bug, not memory")

    eng._matvec_body = bug
    with pytest.raises(ValueError, match="plain bug"):
        eng.matvec(x)
    assert obs.events("memory_report") == []
    monkeypatch.setenv("DMT_OBS", "off")

    def boom(_x, _check):
        raise _oom()

    eng._matvec_body = boom
    with pytest.raises(torch.cuda.OutOfMemoryError):
        eng.matvec(x)


def test_is_resource_exhausted_matching():
    assert M.is_resource_exhausted(_oom())
    assert M.is_resource_exhausted(RuntimeError("CUDA error: out of memory"))
    assert not M.is_resource_exhausted(ValueError("shape mismatch"))
    for exc in (RuntimeError("RESOURCE_EXHAUSTED: x"), MemoryError("Out of "
                                                                   "memory"),
                RuntimeError("INVALID_ARGUMENT: bad")):
        assert M.is_resource_exhausted(exc) == JM.is_resource_exhausted(exc)


def test_kernel_analysis_registry_and_sidecar(clean_obs, tmp_path,
                                              monkeypatch):
    monkeypatch.setenv("DMT_ARTIFACT_CACHE", "on")
    monkeypatch.setenv("DMT_ARTIFACT_DIR", str(tmp_path))
    attrs = {"num_regs": 40, "shared_size_bytes": 0,
             "local_size_bytes": 0, "const_size_bytes": 0,
             "max_threads_per_block": 256}
    ana = M.record_executable_analysis("fused_decode/u16/d1", attrs,
                                       program="fused_decode_kernel")
    assert ana["num_regs"] == 40
    assert M.executable_analyses()["fused_decode/u16/d1"] == ana
    assert obs.events("memory_analysis")[-1]["program"] == \
        "fused_decode_kernel"
    found = list(tmp_path.rglob("*.json"))
    assert len(found) == 1 and "kernel-analysis" in str(found[0])
    assert M.record_executable_analysis("k", None) is None
    monkeypatch.setenv("DMT_OBS", "off")
    assert M.record_executable_analysis("k2", attrs) is None
