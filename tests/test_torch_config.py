"""The port's runtime config (``utils/config.py``) against the JAX
package's: the same fields, the same ``DMT_*`` names and the same values
from the same environment; and the engines' unset constructor arguments,
which come from it where the JAX engines read it."""

import dataclasses

import numpy as np
import pytest

import distributed_matvec_tpu.parallel.distributed as JD
import distributed_matvec_tpu.parallel.engine as JE
import distributed_matvec_tpu.utils.config as jcfg
import distributed_matvec_tpu_torch.utils.config as tcfg
from distributed_matvec_tpu_torch import DistributedEngine, LocalEngine
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)
from distributed_matvec_tpu_torch.ops import plan_codec as PC

from test_operator import build_heisenberg

SYMS_10 = [([*range(1, 10), 0], 0), ([*reversed(range(10))], 0)]

#: environments the two packages must read alike: every field type, the
#: serve knobs, and values that differ from the defaults
ENVS = {
    "empty": {},
    "serve": {"DMT_SERVE_POOL_GB": "3.5", "DMT_SERVE_BLOCK_WIDTH": "4",
              "DMT_SERVE_ACCEPT_HORIZON_S": "12.25"},
    "engine": {"DMT_MATVEC_MODE": "streamed",
               "DMT_STREAM_COMPRESS": "lossless", "DMT_PIPELINE": "2",
               "DMT_HYBRID": "stream:0,2", "DMT_STREAM_KERNEL": "xla",
               "DMT_MATVEC_BATCH_SIZE": "4096",
               "DMT_ALL_TO_ALL_CAPACITY_FACTOR": "1.5",
               "DMT_REMOTE_BUFFER_SIZE": "9000"},
    "obs": {"DMT_OBS": "off", "DMT_OBS_DIR": "/x/run", "DMT_TRACE": "off",
            "DMT_JOB_ID": "job-7", "DMT_OBS_PORT": "9100",
            "DMT_FLIGHT_RING": "32"},
    "bools": {"DMT_LOG_DEBUG": "yes", "DMT_DISPLAY_TIMINGS": "0",
              "DMT_ALLOW_COMPLEX_ON_TPU": "on", "DMT_PREEMPT": "off"},
}


@pytest.fixture
def both_configs():
    """Fresh configs in both packages (restored afterwards)."""
    saved = (jcfg._config, tcfg._config)
    jcfg._config = tcfg._config = None
    yield
    jcfg._config, tcfg._config = saved


def test_fields_and_defaults_equal_jax():
    jf = [(f.name, f.type, f.default)
          for f in dataclasses.fields(jcfg.RuntimeConfig)]
    tf = [(f.name, f.type, f.default)
          for f in dataclasses.fields(tcfg.RuntimeConfig)]
    assert tf == jf


@pytest.mark.parametrize("env", sorted(ENVS))
def test_from_env_field_by_field(env, monkeypatch):
    for k in list(__import__("os").environ):
        if k.startswith("DMT_"):
            monkeypatch.delenv(k)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    want = dataclasses.asdict(jcfg._from_env(jcfg.RuntimeConfig()))
    got = dataclasses.asdict(tcfg._from_env(tcfg.RuntimeConfig()))
    assert got == want
    for k, v in got.items():
        assert type(v) is type(want[k]), k


def test_get_set_update(both_configs):
    cfg = tcfg.get_config()
    assert tcfg.get_config() is cfg
    assert tcfg.update_config(serve_block_width=3) is cfg
    assert cfg.serve_block_width == 3
    with pytest.raises(AttributeError, match="unknown config field"):
        tcfg.update_config(no_such_field=1)
    fresh = tcfg.RuntimeConfig(matvec_mode="fused")
    tcfg.set_config(fresh)
    assert tcfg.get_config() is fresh


# -- the engines' unset arguments ------------------------------------------------

@pytest.fixture(scope="module")
def chain10():
    op_j = build_heisenberg(10, 5, 1, SYMS_10)
    op_j.basis.build()
    return op_j, operator_from_reference(operator_arrays(op_j),
                                         device="cpu")


def _jax_tier(eng):
    return getattr(eng, "_compress", None)


@pytest.mark.parametrize("knobs", [
    {},
    {"matvec_mode": "streamed"},
    {"matvec_mode": "streamed", "stream_compress": "lossless"},
    {"matvec_mode": "fused"},
], ids=["defaults", "streamed", "streamed-lossless", "fused"])
def test_engine_defaults_resolve_as_jax(knobs, chain10, both_configs):
    """``DistributedEngine(op)`` and the JAX engine built with no
    arguments resolve the same mode and codec tier, from the defaults and
    from the same config."""
    op_j, op_t = chain10
    jcfg.update_config(**knobs)
    tcfg.update_config(**knobs)
    ej = JD.DistributedEngine(op_j, n_devices=1)
    et = DistributedEngine(op_t, device="cpu")
    assert et.mode == ej.mode == knobs.get("matvec_mode", "ell")
    if et.mode == "streamed":
        assert et.stream_compress == _jax_tier(ej) \
            == knobs.get("stream_compress", "off")
        assert et.batch_size == ej.batch_size
        xh = np.random.default_rng(0).random(op_t.basis.number_states)
        np.testing.assert_allclose(
            et.matvec_global(xh),
            np.asarray(ej.from_hashed(ej.matvec(ej.to_hashed(xh)))),
            rtol=1e-12, atol=1e-14)


def test_local_engine_defaults_resolve_as_jax(chain10, both_configs):
    op_j, op_t = chain10
    for mode in ("ell", "compact"):
        jcfg.update_config(matvec_mode=mode, matvec_batch_size=8)
        tcfg.update_config(matvec_mode=mode, matvec_batch_size=8)
        ej, et = JE.LocalEngine(op_j), LocalEngine(op_t, device="cpu")
        assert et.mode == ej.mode == mode
        assert et.batch_size == ej.batch_size == 8
    tcfg.update_config(ell_build_budget_gb=0.25)
    assert LocalEngine(op_t, device="cpu").build_budget_gb == 0.25


def test_engine_knobs_from_config(chain10, both_configs):
    """``pipeline``, ``hybrid``, ``matvec_batch_size`` and the bucket
    sizing come from the config when the constructor leaves them unset;
    an explicit argument wins.  The ``"auto"`` values resolve as the JAX
    engine resolves them under the same (CPU default) calibration."""
    op_j, op_t = chain10
    tcfg.update_config(pipeline="2", matvec_batch_size=32,
                       all_to_all_capacity_factor=1.5,
                       remote_buffer_size=9000)
    eng = DistributedEngine(op_t, mode="streamed", n_devices=2,
                            device="cpu")
    assert eng.pipeline_depth == 2 and eng.batch_size == 32
    assert eng.all_to_all_capacity_factor == 1.5
    assert eng.remote_buffer_size == 9000
    assert DistributedEngine(op_t, mode="streamed", pipeline_depth=0,
                             device="cpu").pipeline_depth == 0
    tcfg.update_config(hybrid="all-recompute")
    hyb = DistributedEngine(op_t, mode="hybrid", device="cpu")
    assert hyb.hybrid_stream_fraction == 0.0
    knobs = dict(hybrid="auto", pipeline="auto", matvec_batch_size=32,
                 all_to_all_capacity_factor=1.5, remote_buffer_size=9000)
    tcfg.update_config(**knobs)
    jcfg.update_config(**knobs)
    for mode in ("hybrid", "streamed"):
        eng = DistributedEngine(op_t, mode=mode, n_devices=2, device="cpu")
        jeng = JD.DistributedEngine(op_j, n_devices=2, mode=mode)
        assert eng.pipeline_depth == jeng.pipeline_depth
        if mode == "hybrid":
            np.testing.assert_array_equal(eng._hybrid_mask,
                                          jeng._hybrid_mask)


@pytest.mark.parametrize("knob,kernel", [("auto", "cuda"),
                                         ("pallas", "cuda"),
                                         ("xla", None)])
def test_stream_kernel_mapping(knob, kernel, chain10, both_configs):
    """``stream_kernel``: ``auto`` and ``pallas`` → the CUDA kernel
    wherever it is eligible (the JAX package's ``auto`` is its XLA
    decode: the one deliberate difference); ``xla`` would send eligible
    chunks through the plain version, so a streamed or hybrid engine
    raises under it.  The kernel path gives the torch path's apply."""
    _, op_t = chain10
    tcfg.update_config(stream_kernel=knob)
    if kernel is None:
        for mode, kw in (("streamed", {"stream_compress": "lossless"}),
                         ("streamed", {"stream_compress": "off"}),
                         ("hybrid", {"hybrid_split": "all-stream"})):
            with pytest.raises(NotImplementedError, match="stream_kernel"):
                DistributedEngine(op_t, mode=mode, device="cpu", **kw)
        # the unstreamed modes never read it
        assert DistributedEngine(op_t, mode="ell",
                                 device="cpu").stream_kernel is None
        return
    eng = DistributedEngine(op_t, mode="streamed",
                            stream_compress="lossless", device="cpu")
    assert eng.stream_kernel == kernel
    # an ineligible plan (the off tier) decodes in torch whatever the knob
    off = DistributedEngine(op_t, mode="streamed", stream_compress="off",
                            device="cpu")
    assert off.stream_kernel == "torch"
    x = np.random.default_rng(1).random(op_t.basis.number_states)
    np.testing.assert_allclose(eng.matvec_global(x), off.matvec_global(x),
                               rtol=1e-12, atol=1e-14)
    before = PC.fused_decode_gather_scatter.launches
    eng.matvec_global(x)
    # on CPU tensors the wrapper takes its plain version: no launch
    assert PC.fused_decode_gather_scatter.launches == before


def test_stream_kernel_rejects_unknown(chain10, both_configs):
    _, op_t = chain10
    tcfg.update_config(stream_kernel="triton")
    with pytest.raises(ValueError, match="stream_kernel"):
        DistributedEngine(op_t, mode="streamed", device="cpu")
    # the unstreamed modes never read it
    DistributedEngine(op_t, mode="ell", device="cpu")


def test_lanczos_reorth_from_config(chain10, both_configs):
    """``lanczos(reorth=None)`` takes the config's ``lanczos_reorth``."""
    from distributed_matvec_tpu_torch import lanczos

    _, op_t = chain10
    eng = LocalEngine(op_t, device="cpu")
    runs = {}
    for knob in ("selective", "full"):
        tcfg.update_config(lanczos_reorth=knob)
        runs[knob] = (lanczos(eng.matvec, n=eng.n_states, tol=1e-10,
                              device="cpu"),
                      lanczos(eng.matvec, n=eng.n_states, tol=1e-10,
                              reorth=knob, device="cpu"))
    for by_config, explicit in runs.values():
        assert by_config.full_sweeps == explicit.full_sweeps
        assert by_config.num_iters == explicit.num_iters
        np.testing.assert_array_equal(by_config.eigenvalues,
                                      explicit.eigenvalues)
    tcfg.update_config(lanczos_reorth="sideways")
    with pytest.raises(ValueError, match="reorth"):
        lanczos(eng.matvec, n=eng.n_states, device="cpu")


@pytest.mark.parametrize("field,value", [
    ("split_gather", "on"), ("term_loop", "scan"), ("complex_pair", "on"),
    ("allow_complex_on_tpu", True)])
def test_no_effect_fields_warn_once(both_configs, monkeypatch, field,
                                    value):
    """The fields the port ignores warn once when set off their default
    (one environment configures both packages, so they do not raise);
    the fields this slice gave effect to do not warn."""
    import distributed_matvec_tpu_torch.utils.logging as tlog

    warned = []
    monkeypatch.setattr(tlog, "log_warn", warned.append)
    monkeypatch.setattr(tcfg, "_warned", set())
    assert field in tcfg.NO_EFFECT
    tcfg.get_config()
    assert warned == []                       # defaults: silent
    tcfg.update_config(**{field: value})
    tcfg.update_config(**{field: value})
    assert len(warned) == 1 and field in warned[0]
    tcfg.update_config(health="strict", profile="sampled", fault="x",
                       heartbeat_s=1.0, display_timings=True)
    assert len(warned) == 1
    assert set(tcfg.NO_EFFECT) == {"split_gather", "term_loop",
                                   "complex_pair", "allow_complex_on_tpu"}


@pytest.mark.parametrize("via", ["update_config", "env"])
def test_artifact_max_gb_caps_default_sidecar(both_configs, monkeypatch,
                                              tmp_path, via):
    """``artifact_max_gb`` has an effect now: set without a warning, from
    the config or ``DMT_ARTIFACT_MAX_GB``, it stops a default-path
    structure sidecar larger than the cap (the next engine rebuilds), and
    a cap above the sidecar lets it through (the next engine restores)."""
    import distributed_matvec_tpu_torch.utils.logging as tlog

    warned = []
    monkeypatch.setattr(tlog, "log_warn", warned.append)
    monkeypatch.setenv("DMT_ARTIFACT_CACHE", "on")
    monkeypatch.setenv("DMT_ARTIFACT_DIR", str(tmp_path / "art"))

    def cap(gb):
        if via == "env":
            monkeypatch.setenv("DMT_ARTIFACT_MAX_GB", str(gb))
            tcfg._config = None
        else:
            tcfg.update_config(artifact_max_gb=gb)

    from distributed_matvec_tpu_torch.models.lattices import (
        heisenberg_chain)

    def engine():
        return LocalEngine(heisenberg_chain(10, symmetric=True), mode="ell",
                           device="cpu")

    cap(1e-9)
    assert tcfg.get_config().artifact_max_gb == 1e-9
    first = engine()
    assert not first.structure_restored and not engine().structure_restored
    assert first.ell_nbytes > 1e-9 * 1e9
    cap(1.0)
    assert not engine().structure_restored     # saved now
    assert engine().structure_restored
    assert warned == []
