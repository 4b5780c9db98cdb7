"""The engine's plan caches in the port — ``DistributedEngine(
structure_cache=)``, the stream-plan sidecars, the disk tier with its
per-chunk rebuild and the prefetcher — against the JAX package's engine, on
the CPU, from the same operators and seeded inputs.

Tolerances:
* the sidecars: for a real sector every dataset and attribute the JAX
  engine writes (the per-record CRC32s included) equal in dtype, shape and
  value to the port's on the same operator, mode, D and ``batch_size``;
  the fingerprints equal before the port's tag;
* restored engines (RAM tier, disk tier, shard-native, pipelined, rebuilt
  after a corrupt record): the host plan ``torch.equal`` to the built one
  and every apply bit-equal to the freshly built engine's (the same
  records, decoded and summed in the same order);
* the small names (``lookup_owners``, ``state_index_sorted``,
  ``HashedLayout.to/from_hashed_device``): bit-exact against the JAX
  functions.

Each case names the JAX test it counters (tests/test_engine_distributed.py,
test_engine_streamed.py, test_engine_hybrid.py, test_plan_codec.py,
test_faults.py, test_engine_pipelined.py, test_autotune.py).
"""

import glob
import os

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

import jax.numpy as jnp  # noqa: E402

from distributed_matvec_tpu.enumeration import native as jax_native  # noqa: E402
from distributed_matvec_tpu.enumeration import sharded as jax_sharded  # noqa: E402
from distributed_matvec_tpu.models import yaml_io as jax_yaml  # noqa: E402
from distributed_matvec_tpu.ops import bits as jax_bits  # noqa: E402
from distributed_matvec_tpu.parallel.distributed import \
    DistributedEngine as JaxEngine  # noqa: E402
from distributed_matvec_tpu.parallel.shuffle import \
    HashedLayout as JaxLayout  # noqa: E402
from distributed_matvec_tpu.utils.config import \
    update_config as jax_update_config  # noqa: E402
from distributed_matvec_tpu_torch import DistributedEngine, obs, tune  # noqa: E402
from distributed_matvec_tpu_torch.convert import (  # noqa: E402
    operator_arrays, operator_from_reference)
from distributed_matvec_tpu_torch.enumeration import native  # noqa: E402
from distributed_matvec_tpu_torch.models import yaml_io  # noqa: E402
from distributed_matvec_tpu_torch.ops import bits  # noqa: E402
from distributed_matvec_tpu_torch.ops import plan_codec as PC  # noqa: E402
from distributed_matvec_tpu_torch.parallel import plan_cache  # noqa: E402
from distributed_matvec_tpu_torch.parallel.shuffle import HashedLayout  # noqa: E402
from distributed_matvec_tpu_torch.utils import faults  # noqa: E402
from distributed_matvec_tpu_torch.utils.config import (  # noqa: E402
    get_config, update_config)

from chip_smoke import chain_config  # noqa: E402
from test_operator import build_heisenberg  # noqa: E402

SYMS = {n: [([*range(1, n), 0], 0)] for n in (8, 12, 16)}
RING_10_K1 = [([*range(1, 10), 0], 1)]
BATCH = 64


def _ops(n, hw=None, inv=1, syms=None):
    op_j = build_heisenberg(n, n // 2 if hw is None else hw, inv,
                            list(SYMS[n] if syms is None else syms))
    op_j.basis.build()
    return op_j, operator_from_reference(operator_arrays(op_j), device="cpu")


@pytest.fixture(scope="module")
def chain12():
    return _ops(12)


@pytest.fixture
def clean(monkeypatch):
    """Fresh fault registry and obs state; the RAM budget restored."""
    monkeypatch.delenv("DMT_FAULT", raising=False)
    faults.reset()
    obs.reset_all()
    old = get_config().stream_plan_ram_gb
    yield monkeypatch
    update_config(stream_plan_ram_gb=old)
    faults.reset()
    obs.reset_all()


@pytest.fixture
def artifacts(monkeypatch, tmp_path):
    """The artifact layer on, against a tmp root (both packages)."""
    monkeypatch.setenv("DMT_ARTIFACT_CACHE", "on")
    monkeypatch.setenv("DMT_ARTIFACT_DIR", str(tmp_path / "art"))
    return tmp_path / "art"


def _x(op, seed=3):
    x = np.random.default_rng(seed).random(op.basis.number_states) - 0.5
    if not op.effective_is_real:
        x = x + 1j * (np.random.default_rng(seed + 1).random(x.size) - 0.5)
    return x


def _engine(op, D, mode, cache=None, tier="lossless", **kw):
    return DistributedEngine(op, n_devices=D, mode=mode, batch_size=BATCH,
                             device="cpu", stream_compress=tier,
                             structure_cache=cache, **kw)


def _sidecars(root, kind):
    return sorted(glob.glob(os.path.join(str(root), "**", f"*.{kind}.h5"),
                            recursive=True))


def _h5(path):
    with h5py.File(path, "r") as f:
        g = f["engine_structure"]
        out = {("attr", k): g.attrs[k] for k in g.attrs}
        out.update({("data", k): g[k][...] for k in g})
    return out


def _corrupt(path, name, byte=0):
    """Flip one byte of a dataset in place (the dtype and shape kept)."""
    with h5py.File(path, "r+") as f:
        g = f["engine_structure"]
        a = g[name][...]
        a.reshape(-1).view(np.uint8)[byte] ^= 0xFF
        g[name][...] = a


# -- the ell/compact structure sidecars (test_engine_distributed.py) --------------


@pytest.mark.parametrize("mode", ["ell", "compact"])
def test_distributed_structure_cache(mode, chain12, tmp_path, clean):
    """The routing plan checkpoints and restores bit-identically, keyed per
    shard count: a D = 4 plan does not satisfy a D = 2 engine, whose miss
    is a ``plan_reshard`` (D 4 → 2) and whose own sidecar restores next."""
    _, op = chain12
    x = _x(op)
    cache = str(tmp_path / "c.h5")
    e1 = _engine(op, 4, mode, cache)
    assert not e1.structure_restored
    y1 = e1.matvec_global(x)
    e2 = _engine(op, 4, mode, cache)
    assert e2.structure_restored
    np.testing.assert_array_equal(y1, e2.matvec_global(x))
    for k, v in e1.structure_arrays().items():
        assert torch.equal(v, e2.structure_arrays()[k]), k
    assert e2.ell_split == e1.ell_split
    assert e2.query_capacity == e1.query_capacity
    c = obs.snapshot()["counters"]
    assert c["artifact_cache{event=hit,kind=structure}"] == 1
    assert c["artifact_cache{event=miss,kind=structure}"] == 1
    e3 = _engine(op, 2, mode, cache)
    assert not e3.structure_restored
    ev = obs.events("plan_reshard")
    assert len(ev) == 1 and ev[0]["d_from"] == [4] and ev[0]["d_to"] == 2
    y3 = e3.matvec_global(x)
    np.testing.assert_array_equal(y3, _engine(op, 2, mode).matvec_global(x))
    np.testing.assert_allclose(y3, y1, atol=1e-14, rtol=1e-12)
    e4 = _engine(op, 2, mode, cache)
    assert e4.structure_restored
    np.testing.assert_array_equal(e4.matvec_global(x), y3)


@pytest.mark.parametrize("mode", ["ell", "compact"])
def test_whole_array_structure_sidecar_restores(mode, tmp_path, clean):
    """A whole-array (v2) structure sidecar — one ``[D, …]`` dataset per
    table — restores in one process (JAX ``_load_structure_v2``)."""
    from distributed_matvec_tpu_torch.io.hdf5 import save_engine_structure

    _, op = _ops(16, inv=None, syms=())
    x = _x(op)
    e1 = _engine(op, 2, mode)
    arrays = e1.structure_arrays()
    names = {"norms_all": "n_all"}
    payload = {"T0": e1._ell_T0, "C": e1.query_capacity}
    if mode == "compact":
        payload["W"] = e1._c_W
    payload.update({names.get(k, k): v for k, v in arrays.items()
                    if k != "inv_n"})
    cache = str(tmp_path / "c")
    save_engine_structure(f"{cache}.dist2.structure.h5",
                          e1._structure_fingerprint(), mode, payload)
    e2 = _engine(op, 2, mode, cache)
    assert e2.structure_restored
    np.testing.assert_array_equal(e2.matvec_global(x), e1.matvec_global(x))
    for k, v in arrays.items():
        assert torch.equal(e2.structure_arrays()[k], v), k


CASES = [("ell", "off", 4), ("compact", "off", 4),
         ("streamed", "off", 2), ("streamed", "lossless", 4),
         ("streamed", "f32", 2), ("streamed", "bf16", 4),
         ("hybrid", "lossless", 4), ("streamed", "lossless", 1)]


@pytest.mark.parametrize("mode,tier,D", CASES,
                         ids=[f"{m}-{t}-D{D}" for m, t, D in CASES])
def test_sidecar_equals_jax(mode, tier, D, chain12, tmp_path):
    """Parity with the JAX package in one process: every dataset and
    attribute of the JAX engine's sidecar equals the port's (dtype, shape,
    value; the CRCs included), and the fingerprints agree before the
    port's tag."""
    op_j, op_t = chain12
    kw = {"hybrid_split": "stream:0,2,5"} if mode == "hybrid" else {}
    cj, ct = str(tmp_path / "j"), str(tmp_path / "t")
    jax_update_config(stream_compress=tier)
    try:
        e_j = JaxEngine(op_j, n_devices=D, mode=mode, batch_size=BATCH,
                        structure_cache=cj, **kw)
    finally:
        jax_update_config(stream_compress="off")
    e_t = _engine(op_t, D, mode, ct, tier=tier, **kw)
    assert e_t._fingerprint_hash().hexdigest() \
        == e_j._structure_fingerprint()
    assert e_t._structure_fingerprint() != e_j._structure_fingerprint()
    kind = "structure" if mode in ("ell", "compact") else "stream"
    want = _h5(cj + f".dist{D}.{kind}.h5")
    got = _h5(ct + f".dist{D}.{kind}.h5")
    for key, w in want.items():
        if key == ("attr", "fingerprint"):
            continue
        assert key in got, key
        g = np.asarray(got[key])
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (key, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=str(key))
    extra = {k for k in got if k not in want}
    if kind == "stream":
        # the port's fill counts and their checksums, beside JAX's records
        assert extra == {(t, f"{p}_{d}_{ci}") for d in range(D)
                         for ci in range(e_t.nchunks)
                         for t, p in (("data", "fill"), ("attr", "fill_crc"))}
    else:
        assert extra == {("attr", "S"), ("attr", "Tmax")}


# -- the stream sidecars (test_engine_streamed.py, test_plan_codec.py) --------------


def test_streamed_plan_cache_roundtrip(chain12, artifacts, clean):
    """The plan sidecar under the artifact cache: built once, restored by
    the next construction (the pinned host plan byte-equal, the apply
    bit-equal), readable from the disk tier when the RAM budget excludes
    it (also pipelined, through the prefetcher), and with the cache off
    pure RAM with no writes."""
    _, op = chain12
    x = _x(op)
    e1 = _engine(op, 4, "streamed")
    assert not e1.structure_restored
    y1 = e1.matvec_global(x)
    e2 = _engine(op, 4, "streamed")
    assert e2.structure_restored and e2._plan_disk is None
    assert torch.equal(e2._plan_host, e1._plan_host)
    assert e2._codec.spec == e1._codec.spec
    np.testing.assert_array_equal(y1, e2.matvec_global(x))
    assert e2.plan_bytes == e1.plan_bytes
    assert e2.plan_bytes_raw == e1.plan_bytes_raw

    update_config(stream_plan_ram_gb=0.0)
    e3 = _engine(op, 4, "streamed")
    assert e3.structure_restored
    assert e3._plan_host is None and e3._plan_disk
    assert obs.events("plan_stream")[-1]["tier"] == "disk"
    np.testing.assert_array_equal(y1, e3.matvec_global(x))
    for ci in range(e1.nchunks):
        for d in range(4):
            got, want = e3.plan_chunk(ci, d), e1.plan_chunk(ci, d)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    e3.pipeline_depth = 3
    np.testing.assert_array_equal(y1, e3.matvec_global(x))
    assert e3.last_pipeline["fetch_wait_ms"] >= 0.0
    update_config(stream_plan_ram_gb=8.0)

    clean.setenv("DMT_ARTIFACT_CACHE", "off")
    before = set(artifacts.rglob("*"))
    e4 = _engine(op, 4, "streamed")
    assert not e4.structure_restored
    assert e4._plan_host is not None and e4._plan_disk is None
    np.testing.assert_array_equal(y1, e4.matvec_global(x))
    assert set(artifacts.rglob("*")) == before


#: (n, hw, inv, syms, D, mode, tier, split, raw coefficients): every codec
#: tier, raw coefficients, a complex sector and hybrid splits
TIER_CASES = [
    (12, 6, 1, SYMS[12], 2, "streamed", "off", None, False),
    (12, 6, 1, SYMS[12], 4, "streamed", "lossless", None, False),
    (12, 6, 1, SYMS[12], 1, "streamed", "f32", None, False),
    (12, 6, 1, SYMS[12], 2, "streamed", "bf16", None, False),
    (12, 6, 1, SYMS[12], 2, "streamed", "f32", None, True),
    (10, 5, None, RING_10_K1, 2, "streamed", "lossless", None, False),
    (10, 5, None, RING_10_K1, 4, "streamed", "off", None, False),
    (12, 6, 1, SYMS[12], 4, "hybrid", "lossless", "stream:0,2,5", False),
    (12, 6, 1, SYMS[12], 2, "hybrid", "off", "all-recompute", False),
    (10, 5, None, RING_10_K1, 2, "hybrid", "lossless", "stream:0,1", False),
    (12, 6, 1, SYMS[12], 2, "hybrid", "lossless", "auto", False),
]


@pytest.mark.parametrize(
    "case", TIER_CASES,
    ids=[f"n{c[0]}-D{c[4]}-{c[5]}-{c[6]}{'-' + c[7] if c[7] else ''}"
         f"{'-raw' if c[8] else ''}{'-k1' if c[3] is RING_10_K1 else ''}"
         for c in TIER_CASES])
def test_tier_restores_bit_equal(case, tmp_path, clean):
    """Each codec tier, raw coefficient streams, a complex sector and
    hybrid splits restore from their sidecar into RAM (the host plan
    byte-equal) and onto the disk tier, each apply bit-equal to the built
    engine's; a changed tier or split misses (test_plan_codec.py:273,
    :290; test_engine_hybrid.py:251)."""
    n, hw, inv, syms, D, mode, tier, split, raw = case
    _, op = _ops(n, hw, inv, syms)
    x = _x(op)
    kw = {"hybrid_split": split} if split else {}
    cache = str(tmp_path / "c")
    dict_max = PC.DICT_MAX
    if raw:
        PC.DICT_MAX = 2            # the engine reads it at build time
    try:
        e1 = _engine(op, D, mode, cache, tier=tier, **kw)
    finally:
        PC.DICT_MAX = dict_max
    if raw:
        assert e1._codec.spec["coeff"] != "dict"
    y1 = e1.matvec_global(x)
    e2 = _engine(op, D, mode, cache, tier=tier, **kw)
    assert e2.structure_restored and torch.equal(e2._plan_host,
                                                 e1._plan_host)
    if mode == "hybrid":
        np.testing.assert_array_equal(e2._hybrid_mask, e1._hybrid_mask)
    np.testing.assert_array_equal(y1, e2.matvec_global(x))
    update_config(stream_plan_ram_gb=0.0)
    e3 = _engine(op, D, mode, cache, tier=tier, **kw)
    assert e3.structure_restored and e3._plan_host is None
    np.testing.assert_array_equal(y1, e3.matvec_global(x))
    update_config(stream_plan_ram_gb=8.0)
    other = {"off": "lossless"}.get(tier, "off")
    assert not _engine(op, D, mode, cache, tier=other,
                       **kw).structure_restored
    if mode == "hybrid" and split != "all-recompute":
        assert not _engine(op, D, mode, cache, tier=tier,
                           hybrid_split="all-recompute").structure_restored


# -- faults (test_faults.py) ---------------------------------------------------------


def test_corrupt_structure_checkpoint_rebuilds(tmp_path, clean):
    """An unreadable explicit structure sidecar is a miss (the engine builds
    and overwrites it), counted as corrupt — not an error."""
    _, op = _ops(8)
    cache = str(tmp_path / "plan.h5")
    with open(f"{cache}.dist2.structure.h5", "wb") as f:
        f.write(b"garbage" * 64)
    eng = _engine(op, 2, "ell", cache)
    assert not eng.structure_restored
    assert obs.snapshot()["counters"][
        "artifact_cache{event=corrupt,kind=structure}"] >= 1
    assert _engine(op, 2, "ell", cache).structure_restored


def _disk_pair(op, cache, D=2, mode="streamed", **kw):
    """A built engine and a disk-tier engine restored from its sidecar."""
    update_config(stream_plan_ram_gb=0.0)
    e1 = _engine(op, D, mode, cache, **kw)
    assert e1._plan_host is None, "the disk tier must be active"
    e2 = _engine(op, D, mode, cache, **kw)
    assert e2.structure_restored and e2._plan_host is None
    return e1, e2


@pytest.mark.parametrize("mode,name", [("streamed", "dest_0_0"),
                                       ("hybrid", "coeff_1_0")])
def test_stream_disk_tier_corrupt_chunk_rebuilds(mode, name, chain12,
                                                 tmp_path, clean):
    """A corrupt record on the disk tier counts as corrupt and its chunk is
    rebuilt from structure — for a hybrid plan re-encoded through the same
    term mask — byte-equal to the record the sidecar held, the apply
    bit-equal; the sidecar's second failure quarantines it and the whole
    plan returns to pinned RAM."""
    _, op = chain12
    x = _x(op)
    kw = {"hybrid_split": "stream:0,2,5"} if mode == "hybrid" else {}
    e1, e2 = _disk_pair(op, str(tmp_path / "c"), mode=mode, **kw)
    y_ref = e1.matvec_global(x)
    want = e1._plan_chunk_host(0).clone()
    path = e2._plan_disk[0]

    def corrupt():
        for e in (e1, e2):
            plan_cache.close_plan_files(e._plan_files)
        _corrupt(path, name)

    corrupt()
    np.testing.assert_array_equal(e2.matvec_global(x), y_ref)
    c = obs.snapshot()["counters"]
    assert c["artifact_cache{event=corrupt,kind=stream_plan}"] == 1
    assert obs.events("plan_chunk_rebuilt")[0]["chunk"] == 0
    assert torch.equal(e2._plan_repaired[0], want)
    assert os.path.exists(path)                # first failure: kept
    corrupt()                                  # undo the flip: the same
    corrupt()                                  # record fails again
    e2._plan_repaired.clear()
    np.testing.assert_array_equal(e2.matvec_global(x), y_ref)
    assert not os.path.exists(path)
    assert e2._plan_host is not None and e2._plan_disk is None
    assert torch.equal(e2._plan_host[0], want)
    assert obs.snapshot()["counters"][
        "artifact_cache{event=quarantine,kind=stream_plan}"] == 1


def test_stream_ram_restore_rejects_corrupt_sidecar(chain12, tmp_path,
                                                    clean):
    """A RAM restore verifies every record's checksums once: a corrupt
    sidecar (a record, or only its fill counts) is a miss and a fresh
    build, never a silently wrong plan."""
    _, op = chain12
    x = _x(op)
    cache = str(tmp_path / "c")
    e1 = _engine(op, 2, "streamed", cache)
    y_ref = e1.matvec_global(x)
    side = f"{cache}.dist2.stream.h5"
    for name in ("coeff_1_0", "fill_0_1"):
        _corrupt(side, name)
        e2 = _engine(op, 2, "streamed", cache)
        assert not e2.structure_restored, name
        np.testing.assert_array_equal(e2.matvec_global(x), y_ref)
        assert e2._store.exists(side)           # re-saved by the build
    assert obs.snapshot()["counters"][
        "artifact_cache{event=corrupt,kind=stream_plan}"] >= 2


def test_fault_site_plan_chunk_read_retries(chain12, tmp_path, clean):
    """A transient disk-tier read failure heals inside the apply (bounded
    retry), with the io_retry tally."""
    _, op = chain12
    x = _x(op)
    _, eng = _disk_pair(op, str(tmp_path / "c"))
    y_ref = eng.matvec_global(x)
    clean.setenv("DMT_FAULT", "plan_chunk_read:n=1")
    faults.reset()
    np.testing.assert_array_equal(eng.matvec_global(x), y_ref)
    assert faults.fired_count("plan_chunk_read") == 1
    assert obs.snapshot()["counters"][
        "io_retry{site=plan_chunk_read}"] >= 1
    assert not obs.events("plan_chunk_rebuilt")


def test_plan_upload_retries_on_the_disk_tier(chain12, tmp_path, clean):
    """``plan_upload`` wraps the disk fetch too: two injected failures heal
    through the retries, sequential and pipelined."""
    _, op = chain12
    x = _x(op)
    _, eng = _disk_pair(op, str(tmp_path / "c"))
    y_ref = eng.matvec_global(x)
    for depth in (0, 2):
        eng.pipeline_depth = depth
        clean.setenv("DMT_FAULT", "plan_upload:n=2")
        faults.reset()
        np.testing.assert_array_equal(eng.matvec_global(x), y_ref)
        assert faults.fired_count("plan_upload") == 2


# -- the prefetcher (test_engine_pipelined.py) -----------------------------------------


def test_prefetcher_error_propagates(chain12, tmp_path, clean, monkeypatch):
    """A worker's fetch failure surfaces on the apply thread as the
    original exception (the degrade path re-runs the fetch there), not a
    hang; the next clean apply is bit-equal."""
    _, op = chain12
    x = _x(op)
    _, pipe = _disk_pair(op, str(tmp_path / "c"), pipeline_depth=2)
    assert pipe.pipeline_depth == 2
    y_ref = pipe.matvec_global(x)

    def boom(ci, degrade=True):
        raise OSError(f"synthetic fetch failure on chunk {ci}")

    monkeypatch.setattr(pipe, "_fetch_plan_chunk", boom)
    with pytest.raises(OSError, match="synthetic fetch failure"):
        pipe.matvec_global(x)
    monkeypatch.undo()
    np.testing.assert_array_equal(pipe.matvec_global(x), y_ref)


def test_prefetcher_other_error_reraises(tmp_path, clean, monkeypatch):
    """A worker error that is not a read failure re-raises on the apply
    thread as it was raised."""
    _, op = _ops(12, inv=None, syms=())
    x = _x(op)
    _, pipe = _disk_pair(op, str(tmp_path / "c"), pipeline_depth=3)
    calls = []
    real = pipe._plan_chunk_host

    def flaky(ci, degrade=True):
        calls.append(ci)
        if ci == 2:
            raise ZeroDivisionError("worker bug")
        return real(ci, degrade)

    monkeypatch.setattr(pipe, "_plan_chunk_host", flaky)
    with pytest.raises(ZeroDivisionError, match="worker bug"):
        pipe.matvec_global(x)
    assert 2 in calls


def test_pipelined_disk_tier_corrupt_chunk_repairs_on_apply_thread(
        tmp_path, clean):
    """A corrupt mid-stream record under a pipelined apply: the worker only
    marks the failure, the rebuild runs on the apply thread, prefetching
    resumes for the chunks ahead, and the apply stays bit-equal."""
    _, op = _ops(12, inv=None, syms=())
    x = _x(op)
    e1, e2 = _disk_pair(op, str(tmp_path / "c"))
    y_ref = e1.matvec_global(x)
    e2.pipeline_depth = 3
    assert e2.nchunks > 3
    for e in (e1, e2):
        plan_cache.close_plan_files(e._plan_files)
    _corrupt(e2._plan_disk[0], "dest_0_1")
    np.testing.assert_array_equal(e2.matvec_global(x), y_ref)
    assert [e["chunk"] for e in obs.events("plan_chunk_rebuilt")] == [1]
    assert torch.equal(e2._plan_repaired[1], e1._plan_chunk_host(1))


# -- the tuner's persistence knobs (test_autotune.py) ---------------------------------


def test_tuned_disk_tier(chain12, tmp_path, clean, monkeypatch):
    """A RAM budget that cannot hold the plan forces the disk tier in the
    knob grid; a tuned ``plan_tier="disk"`` puts the plan on the disk tier
    (its sidecar at the given path), with the tuned prefetch workers, and
    the apply equals a hand-set engine's at the same knobs bit for bit.
    Without any sidecar the tuned tier keeps RAM."""
    _, op = chain12
    x = _x(op)
    stats = dict(_engine(op, 2, "streamed")._tune_stats(),
                 ram_budget_bytes=1.0, disk_available=True)
    assert all(c.plan_tier == "disk"
               for c in tune.knob_grid(stats, "streamed"))
    disk = tune.TunedConfig(batch_size=BATCH, pipeline_depth=2,
                            stream_compress="lossless",
                            prefetch_workers=4, plan_tier="disk")
    monkeypatch.setattr(tune, "load_tuned", lambda fp: disk)
    update_config(tune="static")
    try:
        eng = DistributedEngine(op, n_devices=2, mode="streamed",
                                device="cpu",
                                structure_cache=str(tmp_path / "c"))
        bare = DistributedEngine(op, n_devices=2, mode="streamed",
                                 device="cpu")
    finally:
        update_config(tune="off")
    assert eng._tune_plan_tier == "disk" and eng._tune_workers == 4
    assert eng._plan_host is None and eng._plan_disk
    assert bare._plan_host is not None and bare._plan_disk is None
    hand = _engine(op, 2, "streamed", pipeline_depth=2)
    assert eng.pipeline_depth == hand.pipeline_depth == 2
    y = hand.matvec_global(x)
    np.testing.assert_array_equal(eng.matvec_global(x), y)
    np.testing.assert_array_equal(bare.matvec_global(x), y)


def test_rekey_to_disk_tier_saves_and_demotes(chain12, artifacts, clean):
    """A re-tune that changes the plan tier re-keys at the next apply: the
    plan is saved to the default cache and read from its disk tier, the
    apply unchanged bit for bit; back to RAM restores it from there."""
    _, op = chain12
    x = _x(op)
    eng = _engine(op, 2, "streamed")
    y_ref = eng.matvec_global(x)
    for tier, restored in (("disk", True), ("ram", True)):
        eng._retune_pending = tune.TunedConfig(
            batch_size=BATCH, pipeline_depth=0,
            stream_compress="lossless", plan_tier=tier)
        np.testing.assert_array_equal(eng.matvec_global(x), y_ref)
        assert (eng._plan_host is None) == (tier == "disk")
        assert eng.structure_restored is restored
    assert _sidecars(artifacts, "stream")


# -- shard-native engines ----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ell", "compact", "streamed"])
def test_from_shards_structure_cache(mode, tmp_path, clean):
    """``from_shards(structure_cache=)``: a shard-native engine saves and
    restores its plan keyed by the manifest's fingerprint, with no global
    basis; the restored apply equals the built one bit for bit and the
    global-layout engine's within the matvec tolerance."""
    conf = chain_config(12)
    op_j = jax_yaml.operator_from_dict(
        conf["hamiltonian"], jax_yaml.basis_from_dict(conf["basis"]))
    op_j.basis.build()
    path = str(tmp_path / "s.h5")
    jax_sharded.enumerate_to_shards(12, 6, op_j.basis.group, 4, path)
    cache = str(tmp_path / "c")

    def shard_op():
        return yaml_io.operator_from_dict(
            conf["hamiltonian"], yaml_io.basis_from_dict(conf["basis"]))

    op_g = shard_op()
    op_g.basis.build()
    kw = dict(mode=mode, batch_size=BATCH, device="cpu",
              structure_cache=cache, stream_compress="lossless")
    op1 = shard_op()
    e1 = DistributedEngine.from_shards(op1, path, **kw)
    assert not e1.structure_restored and not op1.basis.is_built
    xh = e1.state_keyed_hashed(5)
    y1 = e1.matvec(xh)
    op2 = shard_op()
    e2 = DistributedEngine.from_shards(op2, path, **kw)
    assert e2.structure_restored and not op2.basis.is_built
    assert torch.equal(e2.matvec(xh), y1)
    glob_e = DistributedEngine(op_g, n_devices=4, mode=mode,
                               batch_size=BATCH, device="cpu",
                               stream_compress="lossless")
    torch.testing.assert_close(glob_e.matvec(glob_e.state_keyed_hashed(5)),
                               y1, atol=1e-14, rtol=1e-12)


# -- the in-memory store ------------------------------------------------------------------


def test_memory_store_matches_the_file_route(chain12, tmp_path, clean):
    """The module-private in-memory store holds what the file holds: the
    same attributes and datasets, the same restored records (RAM and disk
    tier) and applies; a corrupt record is rebuilt byte-equal, a second
    failure drops the entry and rebuilds the plan into RAM."""
    _, op = chain12
    x = _x(op)
    cache = str(tmp_path / "c")
    mem = plan_cache._MemorySidecarStore()
    f1 = _engine(op, 2, "streamed", cache)
    m1 = _engine(op, 2, "streamed", cache, _sidecar_store=mem)
    side = f"{cache}.dist2.stream.h5"
    assert mem.glob(cache + "*") == [side]
    want = _h5(side)
    g = mem.files[side]
    got = {("attr", k): v for k, v in g.attrs.items()}
    got.update({("data", k): v for k, v in g.data.items()})
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), w, err_msg=str(k))
    y = f1.matvec_global(x)
    np.testing.assert_array_equal(m1.matvec_global(x), y)
    m2 = _engine(op, 2, "streamed", cache, _sidecar_store=mem)
    assert m2.structure_restored and torch.equal(m2._plan_host,
                                                 f1._plan_host)
    update_config(stream_plan_ram_gb=0.0)
    m3 = _engine(op, 2, "streamed", cache, _sidecar_store=mem)
    assert m3.structure_restored and m3._plan_disk == {0: side, 1: side}
    np.testing.assert_array_equal(m3.matvec_global(x), y)
    g.data["coeff_1_1"].reshape(-1).view(np.uint8)[0] ^= 0xFF
    np.testing.assert_array_equal(m3.matvec_global(x), y)
    assert torch.equal(m3._plan_repaired[1], f1._plan_chunk_host(1))
    m3._plan_repaired.clear()
    np.testing.assert_array_equal(m3.matvec_global(x), y)
    assert side not in mem.files and m3._plan_host is not None
    assert torch.equal(m3._plan_host, f1._plan_host)
    # an explicit path and the memory store at a structure sidecar too
    e1 = _engine(op, 2, "compact", cache, _sidecar_store=mem)
    e2 = _engine(op, 2, "compact", cache, _sidecar_store=mem)
    assert not e1.structure_restored and e2.structure_restored
    np.testing.assert_array_equal(e2.matvec_global(x), e1.matvec_global(x))


# -- the small names ------------------------------------------------------------------------


def test_lookup_owners_matches_jax():
    """``enumeration.native.lookup_owners`` against the JAX binding, on
    padded per-shard prefixes, states in and out of the basis."""
    if not native.native_available() or not jax_native.native_available():
        pytest.skip("the C++ enumerator did not build")
    op_j, _ = _ops(12)
    reps = op_j.basis.representatives
    lay = JaxLayout(reps, 3)
    alphas = lay.to_hashed(reps, fill=np.uint64(0xFFFFFFFFFFFFFFFF))
    rng = np.random.default_rng(5)
    betas = np.concatenate([rng.choice(reps, 200),
                            rng.integers(0, 1 << 12, 100).astype(np.uint64)])
    got = native.lookup_owners(betas, alphas, lay.counts, n_threads=2)
    want = jax_native.lookup_owners(betas, alphas, lay.counts, n_threads=2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[2][:200].all()


def test_state_index_sorted_matches_jax():
    """``ops.bits.state_index_sorted`` on int64 bit patterns, with states
    above 2⁶³ (unsigned order), misses and both ends."""
    rng = np.random.default_rng(6)
    reps = np.unique(rng.integers(0, 2 ** 64 - 2, 300, dtype=np.uint64))
    qs = np.concatenate([rng.choice(reps, 50), rng.integers(
        0, 2 ** 64 - 1, 50, dtype=np.uint64),
        np.array([0, 2 ** 64 - 1], np.uint64)])
    idx, found = bits.state_index_sorted(torch.from_numpy(reps.view(np.int64)),
                                         torch.from_numpy(qs.view(np.int64)))
    j_idx, j_found = jax_bits.state_index_sorted(jnp.asarray(reps),
                                                 jnp.asarray(qs))
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(found.numpy(), np.asarray(j_found))


@pytest.mark.parametrize("cols", [None, 3])
def test_hashed_layout_device_matches_jax(cols):
    """``HashedLayout.to_hashed_device``/``from_hashed_device`` on tensors
    against the JAX device gathers (pads zero; [N] and [N, R])."""
    op_j, _ = _ops(12)
    reps = op_j.basis.representatives
    lay, lay_j = HashedLayout(reps, 4), JaxLayout(reps, 4)
    shape = (reps.size,) + ((cols,) if cols else ())
    x = np.random.default_rng(7).standard_normal(shape)
    h = lay.to_hashed_device(torch.from_numpy(x))
    h_j = np.asarray(lay_j.to_hashed_device(jnp.asarray(x)))
    np.testing.assert_array_equal(h.numpy(), h_j)
    np.testing.assert_array_equal(h.numpy(), lay.to_hashed(x))
    back = lay.from_hashed_device(h)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(lay_j.from_hashed_device(jnp.asarray(h_j))))
    np.testing.assert_array_equal(back.numpy(), x)


def test_restore_agreement_across_ranks():
    """JAX ``agree_restored`` on a stand-in rank engine: every rank must
    have restored; a rank that missed makes every rank rebuild, and a
    failed agreement rebuilds everywhere.  Without a group of more than
    one rank it is the identity."""
    from types import SimpleNamespace

    def fake(misses, fail=False):
        def agree(v, op="sum"):
            assert op == "max"
            if fail:
                raise RuntimeError("collective down")
            return [max(v, misses)]

        return SimpleNamespace(group=SimpleNamespace(world_size=2),
                               _agree=agree)

    f = DistributedEngine._agree_restored
    assert f(fake(0), True) is True
    assert f(fake(1), True) is False
    assert f(fake(0), False) is False
    assert f(fake(0, fail=True), True) is False
    assert f(SimpleNamespace(group=None), True) is True
    assert f(SimpleNamespace(group=SimpleNamespace(world_size=1)),
             False) is False
