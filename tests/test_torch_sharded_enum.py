"""The sharded enumeration, the shard-native engine, the sharded vector
files and the Resharder: the port (``enumeration/sharded.py``,
``DistributedEngine.from_shards``, ``io/sharded_io.py``,
``parallel/reshard.py``) against the JAX package in one process, on the
same operator (chain_12_symm to chain_16_symm, D ∈ {1, 2, 3, 4}).

Tolerances:
* files: every dataset and attribute equal, the fingerprint included;
  each package's ``load_shard`` reads the other's file;
* per-shard states and norms, streamed plan words, the state-keyed probe,
  a reshard: bit-exact (integer data, or data movement);
* matvec: atol 1e-14 / rtol 1e-12; eigenvalues: 1e-10 against JAX
  ``from_shards`` + ``lanczos``.
"""

import os

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from distributed_matvec_tpu.enumeration import sharded as jax_sharded
from distributed_matvec_tpu.io import sharded_io as jax_sio
from distributed_matvec_tpu.models import yaml_io as jax_yaml
from distributed_matvec_tpu.parallel import reshard as jax_reshard
from distributed_matvec_tpu.parallel.distributed import \
    DistributedEngine as JaxEngine
from distributed_matvec_tpu.solve import lanczos as jax_lanczos
from distributed_matvec_tpu_torch import DistributedEngine, lanczos
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)
from distributed_matvec_tpu_torch.enumeration import sharded
from distributed_matvec_tpu_torch.io import sharded_io as sio
from distributed_matvec_tpu_torch.models import yaml_io
from distributed_matvec_tpu_torch.models.observables import (
    bind_observables, expectations)
from distributed_matvec_tpu_torch.parallel import reshard

from chip_smoke import chain_config
from test_operator import build_heisenberg

ATOL, RTOL = 1e-14, 1e-12


def _ops(n):
    """chain_<n>_symm in both packages, from the same config dict; the
    port's basis unbuilt (a shard-native engine never builds it)."""
    d = chain_config(n)
    bj = jax_yaml.basis_from_dict(d["basis"])
    bt = yaml_io.basis_from_dict(d["basis"])
    return (jax_yaml.operator_from_dict(d["hamiltonian"], bj),
            yaml_io.operator_from_dict(d["hamiltonian"], bt))


def _tree(path):
    """Every dataset and attribute of an HDF5 file: {name: value}."""
    out = {}
    with h5py.File(path, "r") as f:
        for k, v in f.attrs.items():
            out[f"@{k}"] = np.asarray(v)

        def visit(name, obj):
            for k, v in obj.attrs.items():
                out[f"{name}@{k}"] = np.asarray(v)
            if isinstance(obj, h5py.Dataset):
                out[name] = obj[...]
        f.visititems(visit)
    return out


def _assert_same_file(a, b, skip=()):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        if k in skip:
            continue
        assert ta[k].dtype == tb[k].dtype, k
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


ENUM_CASES = [(n, D) for n in (12, 14, 16) for D in (1, 2, 3, 4)]


@pytest.mark.parametrize("n,D", ENUM_CASES,
                         ids=[f"chain{n}-D{D}" for n, D in ENUM_CASES])
def test_enumerate_to_shards_files_equal(tmp_path, n, D):
    op_j, op_t = _ops(n)
    g_j, g_t = op_j.basis.group, op_t.basis.group
    pj, pt = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    man_j = jax_sharded.enumerate_to_shards(n, n // 2, g_j, D, pj)
    man_t = sharded.enumerate_to_shards(n, n // 2, g_t, D, pt)
    assert man_t == man_j
    _assert_same_file(pj, pt)
    op_j.basis.build()
    reps = np.asarray(op_j.basis.representatives, np.uint64)
    assert man_t["total"] == reps.size
    owner = (jax_sharded.shard_index(reps, D) if D > 1
             else np.zeros(reps.size, np.int64))
    for d in range(D):
        for load in (sharded.load_shard, jax_sharded.load_shard):
            for path in (pj, pt):
                s, w = load(path, d)
                np.testing.assert_array_equal(s, reps[owner == d])
                np.testing.assert_array_equal(
                    w, np.asarray(op_j.basis.norms)[owner == d])
    # a second call restores, in either package, from either file
    again = sharded.enumerate_to_shards(n, n // 2, g_t, D, pj)
    assert again["restored"] and again["fingerprint"] == man_j["fingerprint"]
    assert jax_sharded.enumerate_to_shards(n, n // 2, g_j, D,
                                           pt)["restored"]


def test_enumerate_wrong_census_raises(tmp_path, monkeypatch):
    _, op_t = _ops(12)
    g = op_t.basis.group
    monkeypatch.setattr(type(g), "sector_dimension_census",
                        lambda self, hw: 12345)
    with pytest.raises(RuntimeError, match="census"):
        sharded.enumerate_to_shards(12, 6, g, 2, str(tmp_path / "s.h5"))
    assert not os.path.exists(tmp_path / "s.h5")
    with pytest.raises(RuntimeError, match="census"):
        sharded._enumerate_in_memory(12, 6, g, 2)
    for r in range(2):
        sharded.enumerate_to_shards(12, 6, g, 2, str(tmp_path / "p.h5"),
                                    rank=r, n_ranks=2)
    with pytest.raises(RuntimeError, match="census"):
        sharded.finalize_shard_parts(12, 6, g, 2, str(tmp_path / "p.h5"),
                                     n_ranks=2)


@pytest.mark.parametrize("D", [2, 3])
def test_enumerate_parts_and_finalize_equal(tmp_path, D):
    n = 14
    op_j, op_t = _ops(n)
    g_j, g_t = op_j.basis.group, op_t.basis.group
    pj, pt = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    for r in range(2):
        mj = jax_sharded.enumerate_to_shards(n, n // 2, g_j, D, pj, rank=r,
                                             n_ranks=2)
        mt = sharded.enumerate_to_shards(n, n // 2, g_t, D, pt, rank=r,
                                         n_ranks=2)
        assert mt == mj
        _assert_same_file(f"{pj}.part{r}", f"{pt}.part{r}")
    with pytest.raises(RuntimeError, match="part file"):
        sharded.finalize_shard_parts(n, n // 2, g_t, D, pt, n_ranks=3)
    fj = jax_sharded.finalize_shard_parts(n, n // 2, g_j, D, pj, n_ranks=2)
    ft = sharded.finalize_shard_parts(n, n // 2, g_t, D, pt, n_ranks=2)
    assert ft == fj
    _assert_same_file(pj, pt)
    whole = str(tmp_path / "whole.h5")
    sharded.enumerate_to_shards(n, n // 2, g_t, D, whole)
    for d in range(D):
        s0, w0 = sharded.load_shard(whole, d)
        for load, path in ((sharded.load_shard, pj),
                           (jax_sharded.load_shard, pt)):
            s, w = load(path, d)
            np.testing.assert_array_equal(s, s0)
            np.testing.assert_array_equal(w, w0)


RESHARD_CASES = [(4, 2), (2, 3), (3, 1), (1, 4)]


@pytest.mark.parametrize("D,Dp", RESHARD_CASES,
                         ids=[f"{a}to{b}" for a, b in RESHARD_CASES])
def test_reshard_shards_files_equal(tmp_path, D, Dp):
    n = 14
    op_j, op_t = _ops(n)
    src = str(tmp_path / "src.h5")
    jax_sharded.enumerate_to_shards(n, n // 2, op_j.basis.group, D, src)
    for group in (None, "group"):
        pj = str(tmp_path / f"j{group}.h5")
        pt = str(tmp_path / f"t{group}.h5")
        mj = jax_sharded.reshard_shards(
            src, pj, Dp, group=op_j.basis.group if group else None)
        mt = sharded.reshard_shards(
            src, pt, Dp, group=op_t.basis.group if group else None)
        assert mt == mj
        _assert_same_file(pj, pt)
    # with the group, the fingerprint is a direct enumeration's
    direct = str(tmp_path / "direct.h5")
    sharded.enumerate_to_shards(n, n // 2, op_t.basis.group, Dp, direct)
    _assert_same_file(direct, str(tmp_path / "tgroup.h5"))
    # a group of another sector is refused
    _, op_other = _ops(12)
    with pytest.raises(ValueError, match="does not match"):
        sharded.reshard_shards(src, str(tmp_path / "x.h5"), Dp,
                               group=op_other.basis.group)


@pytest.mark.parametrize("D", [1, 3, 4])
def test_memory_sink_equals_file(tmp_path, D):
    n = 16
    _, op_t = _ops(n)
    g = op_t.basis.group
    path = str(tmp_path / "s.h5")
    man = sharded.enumerate_to_shards(n, n // 2, g, D, path)
    sink, timings = sharded._enumerate_in_memory(n, n // 2, g, D)
    assert {k: sink.manifest[k] for k in ("counts", "total",
                                          "fingerprint")} == \
        {k: man[k] for k in ("counts", "total", "fingerprint")}
    assert sink.manifest["n_shards"] == D
    assert timings["route_s"] >= 0 and timings["enumerate_s"] >= 0
    for d in range(D):
        for a, b in zip(sink.load(d), sharded.load_shard(path, d)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    assert "_MemorySink" not in sharded.__all__


FROM_CASES = [(m, D) for m in ("streamed", "ell", "compact", "fused")
              for D in (1, 3, 4)]


@pytest.fixture(scope="module")
def shard_files(tmp_path_factory):
    """chain_14_symm's JAX shard files at D = 1, 3, 4, with the operators
    and the JAX from_shards + lanczos E0 at each D."""
    n = 14
    d = tmp_path_factory.mktemp("shards")
    op_j, op_t = _ops(n)
    out = {"op_t": op_t, "op_j": op_j, "paths": {}, "e0": {}}
    for D in (1, 3, 4):
        p = str(d / f"s{D}.h5")
        jax_sharded.enumerate_to_shards(n, n // 2, op_j.basis.group, D, p)
        out["paths"][D] = p
        _, op_jd = _ops(n)
        je = JaxEngine.from_shards(op_jd, p, n_devices=D, mode="ell")
        out["e0"][D] = float(jax_lanczos(
            je.matvec, v0=je.random_hashed(seed=42), k=1,
            tol=1e-12).eigenvalues[0])
    op_g = _ops(n)[1]
    op_g.basis.build()
    out["op_global"] = op_g
    return out


def _kw(mode):
    return dict(stream_compress="lossless") if mode == "streamed" else {}


@pytest.mark.parametrize("mode,D", FROM_CASES,
                         ids=[f"{m}-D{D}" for m, D in FROM_CASES])
def test_from_shards_matches_global_engine(shard_files, mode, D):
    """``from_shards`` on the JAX package's file against the port's
    global-layout engine: per-shard states, the streamed plan's words,
    the apply, and E0 against JAX ``from_shards`` + ``lanczos``."""
    path = shard_files["paths"][D]
    _, op_t = _ops(14)
    eng = DistributedEngine.from_shards(op_t, path, mode=mode,
                                        batch_size=64, device="cpu",
                                        **_kw(mode))
    assert not op_t.basis.is_built and eng.layout is None
    assert eng.n_devices == D and eng.basis_restored is False
    ref = DistributedEngine(shard_files["op_global"], n_devices=D,
                            mode=mode, batch_size=64, device="cpu",
                            **_kw(mode))
    assert eng.shard_size == ref.shard_size
    np.testing.assert_array_equal(eng.counts, ref.counts)
    assert torch.equal(eng._alphas, ref._alphas)
    assert torch.equal(eng._norms, ref._norms)
    if mode == "streamed":
        assert eng.nchunks == ref.nchunks
        assert np.array_equal(np.asarray(eng._plan_host),
                              np.asarray(ref._plan_host))
        assert torch.equal(eng._cdict, ref._cdict)
    x = eng.random_hashed(5)
    torch.testing.assert_close(eng.matvec(x), ref.matvec(x), atol=ATOL,
                               rtol=RTOL)
    res = lanczos(eng.matvec, v0=eng.random_hashed(seed=42), k=1,
                  tol=1e-12)
    assert abs(res.eigenvalues[0] - shard_files["e0"][D]) < 1e-10
    # the block-order layout is materialized only on request
    xb = np.random.default_rng(1).standard_normal(eng.n_states)
    np.testing.assert_array_equal(eng.from_hashed(eng.to_hashed(xb)), xb)
    assert eng.layout is not None


def test_from_shards_refusals(shard_files, tmp_path):
    _, op_t = _ops(14)
    path = shard_files["paths"][3]
    with pytest.raises(ValueError, match="3 shards, engine has 2"):
        DistributedEngine.from_shards(op_t, path, n_devices=2,
                                      device="cpu")
    with pytest.raises(ValueError, match="no shard manifest"):
        DistributedEngine.from_shards(op_t, str(tmp_path / "none.h5"),
                                      device="cpu")
    # structure_cache is taken (fused keeps no plan to cache; an ell
    # engine restores its routing plan shard-native)
    cache = str(tmp_path / "c")
    eng = DistributedEngine.from_shards(op_t, path, device="cpu",
                                        structure_cache=cache)
    assert eng.mode == "fused" and not eng.structure_restored
    built = DistributedEngine.from_shards(op_t, path, mode="ell",
                                          device="cpu",
                                          structure_cache=cache)
    assert not built.structure_restored
    again = DistributedEngine.from_shards(op_t, path, mode="ell",
                                          device="cpu",
                                          structure_cache=cache)
    assert again.structure_restored and not op_t.basis.is_built
    x = again.state_keyed_hashed(3)
    assert torch.equal(again.matvec(x), built.matvec(x))


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_state_keyed_hashed_bit_equal(shard_files, D):
    """The probe equals JAX's bit for bit, on a global and on a
    shard-native engine, and is the same global vector at every D."""
    op_g = shard_files["op_global"]
    ops_j = _ops(14)[0]
    ops_j.basis.build()
    je = JaxEngine(ops_j, n_devices=D, mode="fused")
    te = DistributedEngine(op_g, n_devices=D, mode="fused", device="cpu")
    want = np.asarray(je.state_keyed_hashed(7))
    np.testing.assert_array_equal(te.state_keyed_hashed(7).numpy(), want)
    if D in shard_files["paths"]:
        se = DistributedEngine.from_shards(_ops(14)[1],
                                           shard_files["paths"][D],
                                           device="cpu")
        np.testing.assert_array_equal(se.state_keyed_hashed(7).numpy(),
                                      want)
    one = DistributedEngine(op_g, n_devices=1, mode="fused", device="cpu")
    np.testing.assert_array_equal(
        te.from_hashed(te.state_keyed_hashed(3)),
        one.from_hashed(one.state_keyed_hashed(3)))


def test_hashed_vector_files_equal(tmp_path):
    """``save_hashed_vectors`` writes the JAX file (vectors, counts and
    ``ckpt_meta``), each package reads the other's, and the reader
    refuses a file of another generation."""
    op_j, op_t = _ops(12)
    op_t.basis.build()
    D = 3
    eng = DistributedEngine(op_t, n_devices=D, mode="fused", device="cpu")
    x = eng.state_keyed_hashed(1)
    blk = torch.stack([x, 2 * x], dim=-1)
    meta = {"m": 4, "total_iters": 16, "fingerprint": "fp",
            "alph": np.arange(4.0)}
    pj, pt = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    for save, path in ((jax_sio.save_hashed_vectors, pj),
                       (sio.save_hashed_vectors, pt)):
        save(path, {"v": x.numpy(), "b": blk.numpy()}, eng.counts,
             meta=meta)
        save(path, {"w": x.numpy()}, eng.counts)       # carried over
    _assert_same_file(pj, pt)
    for path in (pj, pt):
        for d in range(D):
            for load in (sio.load_hashed_shard, jax_sio.load_hashed_shard):
                np.testing.assert_array_equal(
                    load(path, d, "b"), blk[d, : eng.counts[d]].numpy())
        got = sio.load_hashed_meta(path, expected_fingerprint="fp")
        assert int(got["m"]) == 4 and int(got["total_iters"]) == 16
        assert sio.load_hashed_meta(path, expected_fingerprint="no") is None
        np.testing.assert_array_equal(sio.hashed_vector_counts(path),
                                      eng.counts)
    # a tensor, a dict of host pieces and an array write the same file
    pd = str(tmp_path / "dict.h5")
    sio.save_hashed_vector(pd, {d: x[d] for d in range(D)}, eng.counts)
    pa = str(tmp_path / "arr.h5")
    sio.save_hashed_vector(pa, x, eng.counts)
    _assert_same_file(pd, pa)
    # per-rank files of two generations: the reader takes only the
    # selected generation's, and a shard that only a stale file holds is
    # missing
    base = str(tmp_path / "ck.h5")
    new = {"m": 2, "total_iters": 32, "fingerprint": "fp"}
    old = {"m": 5, "total_iters": 16, "fingerprint": "fp"}
    sio.save_hashed_vectors(base + ".r0", {"k": {0: x[0]}}, eng.counts,
                            meta=new)
    sio.save_hashed_vectors(base + ".r1", {"k": {1: x[1], 2: x[2]}},
                            eng.counts, meta=old)
    with sio.hashed_shard_reader(base, expected_fingerprint="fp",
                                 match_meta=new) as fetch:
        np.testing.assert_array_equal(fetch(0, "k"),
                                      x[0, : eng.counts[0]].numpy())
        with pytest.raises(KeyError, match="generation"):
            fetch(1, "k")


def test_stream_block_to_shards_equal(tmp_path):
    op_j, op_t = _ops(12)
    op_t.basis.build()
    reps = np.asarray(op_t.basis.representatives, np.uint64)
    xb = np.random.default_rng(3).standard_normal((2, reps.size))
    src = str(tmp_path / "golden.h5")
    with h5py.File(src, "w") as f:
        f["representatives"] = reps
        f["x"] = xb
    pj, pt = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    cj = jax_sio.stream_block_to_shards(src, pj, 3, chunk=50)
    ct = sio.stream_block_to_shards(src, pt, 3, chunk=50)
    np.testing.assert_array_equal(cj, ct)
    _assert_same_file(pj, pt)
    eng = DistributedEngine(op_t, n_devices=3, mode="fused", device="cpu")
    xh = eng.to_hashed(xb.T).numpy()
    for d in range(3):
        np.testing.assert_array_equal(sio.load_hashed_shard(pt, d),
                                      xh[d, : eng.counts[d]])


SECTORS = {"real": (12, 6, 1, [([*range(1, 12), 0], 0)]),
           "complex": (12, 6, None, [([*range(1, 12), 0], 1)])}
RS_CASES = [(s, D, Dp) for s in SECTORS for D, Dp in
            ((4, 1), (1, 4), (3, 2), (2, 3), (4, 4))]


@pytest.mark.parametrize("sector,D,Dp", RS_CASES,
                         ids=[f"{s}-{a}to{b}" for s, a, b in RS_CASES])
def test_resharder_is_the_layout_permutation(sector, D, Dp):
    op_j = build_heisenberg(*SECTORS[sector])
    op_j.basis.build()
    op_t = operator_from_reference(operator_arrays(op_j), device="cpu")
    src = DistributedEngine(op_t, n_devices=D, mode="fused", device="cpu")
    dst = DistributedEngine(op_t, n_devices=Dp, mode="fused", device="cpu")
    n = op_t.basis.number_states
    rng = np.random.default_rng(D * 10 + Dp)
    xb = rng.standard_normal((n, 3))
    if sector == "complex":
        xb = xb + 1j * rng.standard_normal((n, 3))
    xh = src.to_hashed(xb).numpy()
    plan = reshard.Resharder(dst, D, src.counts, tail=(3,))
    rows = plan.reshard_rows(lambda i, s: (i + 1) * xh[s, : src.counts[s]],
                             2, dtype=xh.dtype)
    for i, row in enumerate(rows):
        assert torch.equal(row, dst.to_hashed((i + 1) * xb))
    assert plan.src_shards_for(0) == [s for s in range(D) if s % Dp == 0]


def test_partition_fingerprint_and_refusals():
    assert reshard.partition_fingerprint() == \
        jax_reshard.partition_fingerprint()
    op_j = build_heisenberg(*SECTORS["real"])
    op_j.basis.build()
    op_t = operator_from_reference(operator_arrays(op_j), device="cpu")
    dst = DistributedEngine(op_t, n_devices=2, mode="fused", device="cpu")
    src = DistributedEngine(op_t, n_devices=3, mode="fused", device="cpu")
    bad = np.asarray(src.counts).copy()
    bad[0] += 1
    bad[1] -= 1
    with pytest.raises(reshard.PartitionMismatch, match="disagree"):
        reshard.Resharder(dst, 3, bad)
    with pytest.raises(reshard.PartitionMismatch):
        reshard.Resharder(dst, 0, [])
    st = reshard.topology_stanza(dst)
    jst = jax_reshard.topology_stanza(JaxEngine(op_j, n_devices=2,
                                                mode="fused"))
    assert sorted(st) == sorted(jst)
    for k in st:
        np.testing.assert_array_equal(st[k], jst[k])
    assert reshard.topology_stanza(None) == {}
    assert not reshard.hashed_ckpt_engine(lambda v: v)


def test_bind_observables_from_shards(shard_files):
    """``bind_observables(shards_path=)`` builds the observables from the
    same file, on the solve engine's device and D: the same expectation
    values as a global binding."""
    path = shard_files["paths"][3]
    _, op_t = _ops(14)
    eng = DistributedEngine.from_shards(op_t, path, device="cpu")
    obs_ops = [_ops(14)[1], _ops(14)[1]]
    psi = eng.state_keyed_hashed(2)
    psi = psi / torch.linalg.vector_norm(psi)
    bound = bind_observables(obs_ops, eng, shards_path=path)
    assert all(b.engine.n_devices == 3 and b.engine.layout is None
               for b in bound)
    ref = DistributedEngine(shard_files["op_global"], n_devices=3,
                            mode="fused", device="cpu")
    want = expectations([shard_files["op_global"]], ref, psi)[0][1]
    got = expectations(obs_ops, eng, psi, shards_path=path)
    assert all(abs(v - want) <= 1e-12 * abs(want) for _, v in got)


def test_from_shards_needs_a_card_unless_asked(tmp_path, monkeypatch):
    """``from_shards`` runs on the card like every entry point: without one
    it raises unless given ``device="cpu"``."""
    _, op_t = _ops(12)
    path = str(tmp_path / "s.h5")
    sharded.enumerate_to_shards(12, 6, op_t.basis.group, 2, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedEngine.from_shards(op_t, path)
    assert DistributedEngine.from_shards(op_t, path,
                                         device="cpu").device.type == "cpu"
