"""The port's HDF5 I/O (``io/hdf5.py``), YAML loader (``models/yaml_io.py``)
and the HDF5 half of its artifact cache (``utils/artifacts.py``) against
the JAX package's, on the CPU.

* Every ``io/hdf5.py`` writer's file equals the JAX writer's for the same
  input, dataset by dataset (names, dtypes, shapes, bytes), and each
  package's reader reads the other's file bit-equal: representatives are
  u64 on disk whether they come as the host basis's u64 array or as the
  port's int64 bit patterns on a tensor, and the port reads them back as
  int64 bits.
* ``make_or_restore_representatives``: build, save, restore, and a file
  of either package restored by the other.
* ``make_or_restore_basis`` under a tmp artifact dir: ``basis_fingerprint``
  equal to JAX's, a JAX-cached basis restored by a port engine, and the
  ``artifact_read``/``artifact_save`` faults degrading as in JAX.
* ``LocalEngine``'s structure cache in ``ell`` and ``compact``: a restored
  engine's apply bit-equal to a built one's, the ``artifact_max_gb`` cap
  honoured on default paths only, the ``ckpt_write``/``ckpt_rename``
  faults loud on explicit paths and soft on default ones.
* ``load_config_from_yaml`` on inline YAML gives the JAX ``Config``'s
  matvec to 1e-14; the chain config ``chip_smoke.py`` writes loads to the
  dict it builds, whose operator is ``heisenberg_chain(n, symmetric=True)``.
* With ``yaml`` or ``h5py`` hidden: the JAX messages, and the package and
  the CLIs still import.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")
yaml = pytest.importorskip("yaml")

import distributed_matvec_tpu.io.hdf5 as jio
import distributed_matvec_tpu.utils.artifacts as jart
from distributed_matvec_tpu.models import basis as jbasis
from distributed_matvec_tpu.models.yaml_io import (
    load_config_from_yaml as jax_load_yaml)
from distributed_matvec_tpu.utils import faults as jax_faults
from distributed_matvec_tpu.utils.config import get_config as jax_get_config
from distributed_matvec_tpu_torch import LocalEngine, obs
from distributed_matvec_tpu_torch import io as tio_pkg
from distributed_matvec_tpu_torch.io import hdf5 as tio
from distributed_matvec_tpu_torch.models import basis as tbasis
from distributed_matvec_tpu_torch.models.lattices import heisenberg_chain
from distributed_matvec_tpu_torch.models.yaml_io import (
    Config, basis_from_dict, load_config_from_yaml, operator_from_dict)
from distributed_matvec_tpu_torch.utils import artifacts as tart
from distributed_matvec_tpu_torch.utils import faults
from distributed_matvec_tpu_torch.utils.config import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

#: the N=10 ring of tests/test_io.py, and the same ring in its k = 0
#: translation sector with spin inversion and two observables
RING10_YAML = """
basis: {number_spins: 10, hamming_weight: 5}
hamiltonian:
  name: H
  terms:
    - {expression: "σˣ₀ σˣ₁", sites: &l [[0,1],[1,2],[2,3],[3,4],[4,5],[5,6],[6,7],[7,8],[8,9],[9,0]]}
    - {expression: "σʸ₀ σʸ₁", sites: *l}
    - {expression: "σᶻ₀ σᶻ₁", sites: *l}
"""
RING10_SYMM_YAML = """
basis:
  number_spins: 10
  hamming_weight: 5
  spin_inversion: 1
  symmetries:
    - {permutation: [1,2,3,4,5,6,7,8,9,0], sector: 0}
    - {permutation: [9,8,7,6,5,4,3,2,1,0], sector: 0}
hamiltonian:
  name: H
  terms:
    - {expression: "σˣ₀ σˣ₁", sites: &l [[0,1],[1,2],[2,3],[3,4],[4,5],[5,6],[6,7],[7,8],[8,9],[9,0]]}
    - {expression: "σʸ₀ σʸ₁", sites: *l}
    - {expression: "σᶻ₀ σᶻ₁", sites: *l}
observables:
  - name: zz
    terms:
      - {expression: "σᶻ₀ σᶻ₁", sites: *l}
  - name: nnn
    terms:
      - {expression: "σˣ₀ σˣ₁ + σʸ₀ σʸ₁ + σᶻ₀ σᶻ₁", sites: [[0,2],[1,3],[2,4],[3,5],[4,6],[5,7],[6,8],[7,9],[8,0],[9,1]]}
"""


def _dump(path):
    """Every dataset and attribute of an HDF5 file: name → (dtype, shape,
    bytes) for datasets, name@attr → value for attributes."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                a = obj[...]
                out[name] = (a.dtype.str, a.shape, np.asarray(a).tobytes())
            for k, v in obj.attrs.items():
                out[f"{name}@{k}"] = (v.decode() if isinstance(v, bytes)
                                      else np.asarray(v).tolist())
        f.visititems(visit)
    return out


@pytest.fixture
def clean(monkeypatch):
    """Fresh fault registries, obs state and corruption tallies; the
    configs' ``fault`` field pinned empty (a config first built while a
    test had ``DMT_FAULT`` set would keep that test's faults armed)."""
    monkeypatch.delenv("DMT_FAULT", raising=False)
    for cfg in (get_config(), jax_get_config()):
        monkeypatch.setattr(cfg, "fault", "")
    for mod in (faults, jax_faults):
        mod.reset()
    obs.reset_all()
    tart._read_failures.clear()
    jart._read_failures.clear()
    yield monkeypatch
    for mod in (faults, jax_faults):
        mod.reset()
    obs.reset_all()


def _arm(monkeypatch, spec):
    monkeypatch.setenv("DMT_FAULT", spec)
    faults.reset()
    jax_faults.reset()


@pytest.fixture
def artifacts_on(tmp_path, monkeypatch):
    root = str(tmp_path / "artifacts")
    monkeypatch.setenv("DMT_ARTIFACT_CACHE", "on")
    monkeypatch.setenv("DMT_ARTIFACT_DIR", root)
    return root


# -- the writers and readers ---------------------------------------------------

_RNG = np.random.default_rng(7)
#: states with bit 63 set: negative as int64 bit patterns
_REPS = np.concatenate([np.arange(5, dtype=np.uint64) * np.uint64(3),
                        np.array([2**63 + 5, 2**64 - 2], np.uint64)])
_NORMS = _RNG.random(_REPS.size)
_W = np.array([-21.5, -20.1])
_V = _RNG.standard_normal((2, 7))
_VC = _V + 1j * _RNG.standard_normal((2, 7))
_RES = np.array([1e-12, 3e-11])
_X = _RNG.standard_normal(7)
_Y = _RNG.standard_normal((2, 7))
_PAYLOAD = {"T0": 3, "W": 2.0, "idx": np.arange(12, dtype=np.int32)
            .reshape(3, 4), "coeff": _RNG.standard_normal((3, 4)),
            "skipped": None}


def _bits(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


#: writer name → (port call, JAX call), each taking the file path; the port
#: side gets tensors (int64 bit patterns for states) where a caller would
#: hand it device results
WRITERS = {
    "basis": (lambda p: tio.save_basis(p, _bits(_REPS),
                                       torch.from_numpy(_NORMS)),
              lambda p: jio.save_basis(p, _REPS, _NORMS)),
    "basis_u64": (lambda p: tio.save_basis(p, _REPS, _NORMS),
                  lambda p: jio.save_basis(p, _REPS, _NORMS)),
    "eigen": (lambda p: tio.save_eigen(p, torch.from_numpy(_W),
                                       torch.from_numpy(_V),
                                       torch.from_numpy(_RES)),
              lambda p: jio.save_eigen(p, _W, _V, _RES)),
    "eigen_complex": (lambda p: tio.save_eigen(p, _W, torch.from_numpy(_VC),
                                               _RES),
                      lambda p: jio.save_eigen(p, _W, _VC, _RES)),
    "eigen_values_only": (lambda p: tio.save_eigen(p, _W),
                          lambda p: jio.save_eigen(p, _W)),
    "observables": (lambda p: tio.save_observables(
                        p, [("zz", 0.25), ("zz", -1.5), ("nnn", 3.0)]),
                    lambda p: jio.save_observables(
                        p, [("zz", 0.25), ("zz", -1.5), ("nnn", 3.0)])),
    "golden": (lambda p: tio.save_golden(p, _bits(_REPS),
                                         torch.from_numpy(_X),
                                         torch.from_numpy(_Y)),
               lambda p: jio.save_golden(p, _REPS, _X, _Y)),
    "engine_structure": (lambda p: tio.save_engine_structure(
                             p, "fp1", "compact",
                             {k: (torch.from_numpy(v)
                                  if isinstance(v, np.ndarray) else v)
                              for k, v in _PAYLOAD.items()}),
                         lambda p: jio.save_engine_structure(
                             p, "fp1", "compact", _PAYLOAD)),
}


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_writer_files_equal_jax(tmp_path, name):
    """The port's file holds the JAX file's datasets, dtypes, shapes and
    bytes, and its attributes."""
    ours, theirs = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
    WRITERS[name][0](ours)
    WRITERS[name][1](theirs)
    assert _dump(ours) == _dump(theirs)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_basis_read_across(tmp_path, writer):
    path = str(tmp_path / "b.h5")
    WRITERS["basis"][0 if writer == "port" else 1](path)
    reps_t, norms_t = tio.load_basis(path)
    reps_j, norms_j = jio.load_basis(path)
    assert reps_t.dtype == np.int64 and reps_j.dtype == np.uint64
    np.testing.assert_array_equal(reps_t.view(np.uint64), _REPS)
    np.testing.assert_array_equal(reps_j, _REPS)
    np.testing.assert_array_equal(norms_t, norms_j)
    assert norms_t.dtype == norms_j.dtype == np.float64
    assert tio.load_basis(str(tmp_path / "none.h5")) is None


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("name", ["eigen", "eigen_complex",
                                  "eigen_values_only"])
def test_eigen_read_across(tmp_path, writer, name):
    path = str(tmp_path / "e.h5")
    WRITERS[name][0 if writer == "port" else 1](path)
    got, want = tio.load_eigen(path), jio.load_eigen(path)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    vecs = _VC if name == "eigen_complex" else _V
    if got[1] is not None:
        np.testing.assert_array_equal(got[1], vecs)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_golden_read_across(tmp_path, writer):
    path = str(tmp_path / "g.h5")
    WRITERS["golden"][0 if writer == "port" else 1](path)
    reps_t, x_t, y_t = tio.load_golden(path)
    reps_j, x_j, y_j = jio.load_golden(path)
    np.testing.assert_array_equal(reps_t.view(np.uint64), reps_j)
    assert reps_t.dtype == np.int64
    for g, w in ((x_t, x_j), (y_t, y_j)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert x_t.shape == (1, 7) and y_t.shape == (2, 7)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_engine_structure_read_across(tmp_path, writer):
    path = str(tmp_path / "s.h5")
    WRITERS["engine_structure"][0 if writer == "port" else 1](path)
    got = tio.load_engine_structure(path, "fp1")
    want = jio.load_engine_structure(path, "fp1")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    assert "skipped" not in got and str(got["mode"]) == "compact"
    # a stale fingerprint is a miss, not an error, in both
    assert tio.load_engine_structure(path, "fp2") is None
    assert jio.load_engine_structure(path, "fp2") is None
    assert tio.load_engine_structure(str(tmp_path / "no.h5"), "fp1") is None


def test_io_package_exports_the_jax_names():
    import distributed_matvec_tpu.io as jio_pkg

    names = [n for n in dir(jio_pkg) if not n.startswith("_")
             and callable(getattr(jio_pkg, n))]
    assert names and all(callable(getattr(tio_pkg, n)) for n in names)
    assert sorted(tio.__all__) == sorted(jio.__all__)


# -- representative checkpoints ---------------------------------------------------

def _symm_basis(mod, n=12):
    return mod.SpinBasis(n, n // 2, 1, [([*range(1, n), 0], 0)])


def test_representatives_checkpoint_round_trip(tmp_path):
    path = str(tmp_path / "out.h5")
    b = _symm_basis(tbasis)
    assert tio.make_or_restore_representatives(b, path) is False
    reps, norms = b.representatives.copy(), b.norms.copy()
    b2 = _symm_basis(tbasis)
    assert tio.make_or_restore_representatives(b2, path) is True
    np.testing.assert_array_equal(b2.representatives, reps)
    np.testing.assert_array_equal(b2.norms, norms)
    assert b2.representatives.dtype == np.uint64
    b3 = tbasis.SpinBasis(8, 4)
    assert tio.make_or_restore_representatives(b3, None) is False
    assert b3.is_built


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_representatives_restored_across(tmp_path, writer):
    """A file of either package restores the other's basis to the same
    representatives and norms."""
    path = str(tmp_path / "out.h5")
    src_mod, src_io, dst_mod, dst_io = (
        (tbasis, tio, jbasis, jio) if writer == "port"
        else (jbasis, jio, tbasis, tio))
    src = _symm_basis(src_mod)
    assert src_io.make_or_restore_representatives(src, path) is False
    dst = _symm_basis(dst_mod)
    assert dst_io.make_or_restore_representatives(dst, path) is True
    np.testing.assert_array_equal(dst.representatives, src.representatives)
    np.testing.assert_array_equal(dst.norms, src.norms)


def test_corrupt_checkpoint_is_quarantined_and_rebuilt(tmp_path, clean):
    """A garbage output file: the read fails (retried), the basis is
    rebuilt, the file is moved into .quarantine/ and written fresh — as
    in JAX."""
    outcomes = {}
    for name, mod, io_mod in (("port", tbasis, tio), ("jax", jbasis, jio)):
        path = str(tmp_path / f"{name}.h5")
        with open(path, "wb") as f:
            f.write(b"not an hdf5 file")
        b = _symm_basis(mod)
        restored = io_mod.make_or_restore_representatives(b, path)
        q = os.listdir(tmp_path / ".quarantine") \
            if os.path.isdir(tmp_path / ".quarantine") else []
        outcomes[name] = (restored, f"{name}.h5" in q,
                          io_mod.load_basis(path)[0].size)
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"] == (False, True, _symm_basis(tbasis).build()
                                .number_states)


# -- the basis artifact ------------------------------------------------------------

FINGERPRINT_BASES = {
    "spin": lambda m: m.SpinBasis(10, 5),
    "symm": lambda m: m.SpinBasis(12, 6, 1, [([*range(1, 12), 0], 0),
                                             ([*reversed(range(12))], 0)]),
    "momentum": lambda m: m.SpinBasis(8, 4, None, [([*range(1, 8), 0], 1)]),
    "spinless": lambda m: m.SpinlessFermionBasis(6, 3),
    "spinful": lambda m: m.SpinfulFermionBasis(4, 2, 1),
}


@pytest.mark.parametrize("name", sorted(FINGERPRINT_BASES))
def test_basis_fingerprint_equals_jax(name):
    make = FINGERPRINT_BASES[name]
    assert tart.basis_fingerprint(make(tbasis)) == \
        jart.basis_fingerprint(make(jbasis))


def test_jax_cached_basis_restored_by_port_engine(artifacts_on, rng):
    """The JAX cache entry for a basis restores the port engine's basis
    (one shared key), and the engine's apply matches a fresh one."""
    jb = FINGERPRINT_BASES["symm"](jbasis)
    assert jart.make_or_restore_basis(jb) is False       # JAX fills it
    op = heisenberg_chain(12, symmetric=True)
    eng = LocalEngine(op, device="cpu")
    assert eng.basis_restored
    np.testing.assert_array_equal(op.basis.representatives,
                                  jb.representatives)
    fresh = heisenberg_chain(12, symmetric=True)
    fresh.basis.build()
    ref = LocalEngine(fresh, device="cpu")
    x = torch.from_numpy(rng.random(ref.n_states))
    assert torch.equal(eng.matvec(x), ref.matvec(x))
    [init] = [e for e in obs.events("engine_init") if e["basis_restored"]]
    assert init["engine"] == "local"


def test_port_cached_basis_restored_by_jax(artifacts_on):
    tb = FINGERPRINT_BASES["symm"](tbasis)
    assert tart.make_or_restore_basis(tb) is False
    jb = FINGERPRINT_BASES["symm"](jbasis)
    assert jart.make_or_restore_basis(jb) is True
    np.testing.assert_array_equal(jb.representatives, tb.representatives)
    np.testing.assert_array_equal(jb.norms, tb.norms)


def test_distributed_engine_restores_basis(artifacts_on):
    from distributed_matvec_tpu_torch import DistributedEngine

    DistributedEngine(heisenberg_chain(12, symmetric=True), n_devices=2,
                      device="cpu")
    eng = DistributedEngine(heisenberg_chain(12, symmetric=True),
                            n_devices=2, device="cpu")
    assert eng.basis_restored


def test_basis_artifact_off_or_built_does_nothing(tmp_path, monkeypatch):
    """Layer off (the suite default): exactly basis.build(); a built basis
    is left alone."""
    b = FINGERPRINT_BASES["spin"](tbasis)
    assert tart.make_or_restore_basis(b) is False and b.is_built
    assert tart.make_or_restore_basis(b) is False
    assert tart.default_structure_cache("ab" * 32) is None
    # an explicit path works with the layer off
    path = str(tmp_path / "b.h5")
    assert tart.make_or_restore_basis(FINGERPRINT_BASES["spin"](tbasis),
                                      path) is False
    assert tart.make_or_restore_basis(FINGERPRINT_BASES["spin"](tbasis),
                                      path) is True


#: fault spec → what both packages do on a warm cache: whether the basis
#: is restored, and the artifact_cache corrupt count
READ_FAULTS = {"artifact_read:n=1": (True, 0),
               "artifact_read:n=100": (False, 1)}


@pytest.mark.parametrize("spec", sorted(READ_FAULTS))
def test_artifact_read_fault_degrades_as_jax(artifacts_on, clean, spec):
    """One transient read failure heals through the retries; a persistent
    one rebuilds and feeds the corruption tally — in both packages."""
    clean.setattr(get_config(), "io_retry_base_s", 0.0)
    from distributed_matvec_tpu.utils.config import get_config as jcfg
    clean.setattr(jcfg(), "io_retry_base_s", 0.0)
    assert tart.make_or_restore_basis(FINGERPRINT_BASES["symm"](tbasis)) \
        is False
    _arm(clean, spec)
    tb = FINGERPRINT_BASES["symm"](tbasis)
    jb = FINGERPRINT_BASES["symm"](jbasis)
    got = tart.make_or_restore_basis(tb)
    want = jart.make_or_restore_basis(jb)
    restored, corrupt = READ_FAULTS[spec]
    assert got == want == restored
    assert tb.is_built and jb.is_built
    np.testing.assert_array_equal(tb.representatives, jb.representatives)
    n_corrupt = sum(1 for e in obs.events("artifact_cache")
                    if e.get("event") == "corrupt")
    assert n_corrupt == corrupt


def test_artifact_save_fault_is_soft_as_jax(artifacts_on, clean):
    """A failed save leaves no file and a built basis; the next process
    rebuilds (a miss) — in both packages."""
    _arm(clean, "artifact_save:n=2")
    tb = FINGERPRINT_BASES["symm"](tbasis)
    jb = FINGERPRINT_BASES["symm"](jbasis)
    assert tart.make_or_restore_basis(tb) is False
    assert jart.make_or_restore_basis(jb) is False
    assert tb.is_built and jb.is_built
    assert faults.fired_count("artifact_save") == 1
    path = tart.artifact_path("basis", tart.basis_fingerprint(tb), ".h5")
    assert not os.path.exists(path)
    assert not [p for p in os.listdir(os.path.dirname(path))
                if p.endswith(".tmp")]


# -- the LocalEngine structure cache -------------------------------------------------

def _op(mode):
    return heisenberg_chain(12, symmetric=mode == "compact") \
        if mode == "compact" else heisenberg_chain(12, hamming_weight=6)


@pytest.mark.parametrize("mode", ["ell", "compact"])
@pytest.mark.parametrize("where", ["default", "explicit"])
def test_structure_cache_restores_bit_equal(artifacts_on, tmp_path, rng,
                                            mode, where):
    """A restored engine (fresh basis object, restored representatives and
    structure, no structure build) applies bit-equal to the built one, one
    and three columns."""
    path = None if where == "default" else str(tmp_path / "engine")
    e1 = LocalEngine(_op(mode), mode=mode, device="cpu",
                     batch_size=96, structure_cache=path)
    assert not e1.structure_restored
    e2 = LocalEngine(_op(mode), mode=mode, device="cpu",
                     batch_size=96, structure_cache=path)
    assert e2.structure_restored and e2.basis_restored
    assert e2.timer.scope_total("build_structure") == 0
    assert e2.ell_split == e1.ell_split
    for k, v in e1.structure_arrays().items():
        assert torch.equal(e2.structure_arrays()[k], v), k
    for cols in ((), (3,)):
        x = torch.from_numpy(rng.standard_normal((e1.n_states,) + cols))
        assert torch.equal(e2.matvec(x), e1.matvec(x))
    if where == "explicit":
        assert os.path.exists(path + ".structure.h5")
    hits = [e for e in obs.events("engine_init") if e["structure_restored"]]
    assert hits


def test_structure_cache_keys_apart_from_jax(artifacts_on):
    """The two packages' sidecars for one engine have different keys: the
    JAX engine does not restore a sidecar the port wrote."""
    from distributed_matvec_tpu.parallel.engine import LocalEngine as JLE

    from test_operator import build_heisenberg

    LocalEngine(heisenberg_chain(10, hamming_weight=5), mode="ell",
                device="cpu")
    assert not JLE(build_heisenberg(10, 5), mode="ell").structure_restored


def test_structure_cache_off_without_layer(tmp_path):
    """The suite's default (layer off): no sidecar, no restore."""
    e = LocalEngine(_op("ell"), mode="ell", device="cpu")
    assert not e.structure_restored and not e.basis_restored
    assert tart.default_structure_cache(e._structure_fingerprint()) is None


@pytest.mark.parametrize("mode", ["ell", "compact"])
def test_size_cap_stops_default_sidecar(artifacts_on, tmp_path, clean,
                                        mode):
    """Past ``artifact_max_gb`` a default-path sidecar is not written (an
    ``evict`` event, the next engine rebuilds); an explicit path is never
    capped."""
    clean.setattr(get_config(), "artifact_max_gb", 1e-9)
    LocalEngine(_op(mode), mode=mode, device="cpu")
    e2 = LocalEngine(_op(mode), mode=mode, device="cpu")
    assert not e2.structure_restored
    assert not [p for _, _, fs in os.walk(artifacts_on) for p in fs
                if p.endswith(".structure.h5")]
    assert obs.snapshot()["counters"]["artifact_cache"
                                      "{event=evict,kind=structure}"] == 2
    path = str(tmp_path / "explicit")
    LocalEngine(_op(mode), mode=mode, device="cpu", structure_cache=path)
    assert LocalEngine(_op(mode), mode=mode, device="cpu",
                       structure_cache=path).structure_restored


@pytest.mark.parametrize("site", ["ckpt_write", "ckpt_rename"])
def test_structure_save_faults(artifacts_on, tmp_path, clean, site):
    """A save fault: an explicit path raises (loud, no file, no temp file
    left); a default path warns and the engine is built all the same."""
    _arm(clean, f"{site}:n=1")
    path = str(tmp_path / "explicit")
    with pytest.raises(OSError, match="fault-injection"):
        LocalEngine(_op("ell"), mode="ell", device="cpu",
                    structure_cache=path)
    assert not [p for p in os.listdir(tmp_path)
                if "explicit" in p or p.endswith(".tmp")]
    _arm(clean, f"{site}:n=1")
    e = LocalEngine(_op("ell"), mode="ell", device="cpu")
    assert not e.structure_restored and faults.fired_count(site) == 1
    # nothing was cached: the next engine builds and saves
    e2 = LocalEngine(_op("ell"), mode="ell", device="cpu")
    assert not e2.structure_restored
    assert LocalEngine(_op("ell"), mode="ell",
                       device="cpu").structure_restored


def test_structure_read_fault_rebuilds(artifacts_on, clean):
    clean.setattr(get_config(), "io_retry_base_s", 0.0)
    LocalEngine(_op("ell"), mode="ell", device="cpu")
    _arm(clean, "artifact_read:n=100")
    clean.setenv("DMT_ARTIFACT_CACHE", "on")
    e = LocalEngine(_op("ell"), mode="ell", device="cpu")
    assert not e.structure_restored
    assert any(ev.get("artifact_kind") == "structure"
               for ev in obs.events("artifact_cache"))


# -- the YAML loader -----------------------------------------------------------------

@pytest.mark.parametrize("text", [RING10_YAML, RING10_SYMM_YAML],
                         ids=["ring10", "ring10_symm"])
def test_yaml_config_matvec_matches_jax(tmp_path, rng, text):
    path = str(tmp_path / "m.yaml")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    got = load_config_from_yaml(path)
    want = jax_load_yaml(path)
    assert isinstance(got, Config)
    assert got.basis._json_dict() == want.basis._json_dict()
    assert [o.name for o in got.observables] == \
        [o.name for o in want.observables]
    got.basis.build()
    want.basis.build()
    np.testing.assert_array_equal(got.basis.representatives,
                                  want.basis.representatives)
    x = rng.standard_normal(got.basis.number_states)
    for g, w in zip([got.hamiltonian, *got.observables],
                    [want.hamiltonian, *want.observables]):
        want_y = w.matvec_host(x)
        np.testing.assert_allclose(g.matvec_host(x), want_y, rtol=0,
                                   atol=1e-14)
        # the engine sums in its own order: the port's matvec bar
        np.testing.assert_allclose(
            LocalEngine(g, device="cpu").matvec(x).numpy(), want_y,
            rtol=1e-12, atol=1e-14)
    only = load_config_from_yaml(path, hamiltonian=False, observables=False)
    assert only.hamiltonian is None and only.observables == []


def test_yaml_without_basis_raises(tmp_path):
    path = str(tmp_path / "m.yaml")
    with open(path, "w") as f:
        f.write("hamiltonian: {terms: []}\n")
    with pytest.raises(ValueError, match="no 'basis' section"):
        load_config_from_yaml(path)


@pytest.mark.parametrize("n", [12, 32])
def test_chip_smoke_chain_config(tmp_path, rng, n):
    """The config ``chip_smoke.py`` writes for its apps leg: the YAML text
    loads to the dict it builds, and that dict's operator is
    ``heisenberg_chain(n, symmetric=True)`` (basis definition and term
    tables equal; at n = 12 the matvec too)."""
    text = chip_smoke.chain_yaml(n)
    assert yaml.safe_load(text) == chip_smoke.chain_config(n)
    path = str(tmp_path / "c.yaml")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    cfg = load_config_from_yaml(path)
    d = chip_smoke.chain_config(n)
    basis = basis_from_dict(d["basis"])
    from_dict = operator_from_dict(d["hamiltonian"], basis)
    want = heisenberg_chain(n, symmetric=True)
    for op in (cfg.hamiltonian, from_dict):
        assert op.basis._json_dict() == want.basis._json_dict()
        for t in ("diag_table", "off_diag_table"):
            g, w = getattr(op, t), getattr(want, t)
            for a in ("v", "s", "m", "r") + (("x",) if t[0] == "o" else ()):
                np.testing.assert_array_equal(getattr(g, a), getattr(w, a))
    if n == 12:
        cfg.basis.build()
        want.basis.build()
        x = rng.standard_normal(want.basis.number_states)
        assert torch.equal(LocalEngine(cfg.hamiltonian, device="cpu")
                           .matvec(x),
                           LocalEngine(want, device="cpu").matvec(x))


# -- without yaml or h5py ---------------------------------------------------------------

def test_missing_h5py_gives_jax_message(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(RuntimeError) as got:
        tio.save_basis(str(tmp_path / "b.h5"), _REPS)
    with pytest.raises(RuntimeError) as want:
        jio.save_basis(str(tmp_path / "b.h5"), _REPS)
    assert str(got.value) == str(want.value)
    assert "h5py is required" in str(got.value)
    # the cache degrades to a plain build, with no file and no directory
    monkeypatch.setenv("DMT_ARTIFACT_CACHE", "on")
    monkeypatch.setenv("DMT_ARTIFACT_DIR", str(tmp_path / "art"))
    b = tbasis.SpinBasis(8, 4)
    assert tart.make_or_restore_basis(b) is False and b.is_built
    assert not os.path.exists(tmp_path / "art")
    e = LocalEngine(heisenberg_chain(8, hamming_weight=4), device="cpu")
    assert not e.structure_restored and not os.path.exists(tmp_path / "art")


def test_missing_yaml_gives_import_error(tmp_path, monkeypatch):
    """Without yaml the loader raises the ImportError the JAX module's own
    import raises; the dict builders still work."""
    path = str(tmp_path / "m.yaml")
    with open(path, "w") as f:
        f.write(RING10_YAML)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="yaml"):
        load_config_from_yaml(path)
    d = chip_smoke.chain_config(8)
    b = basis_from_dict(d["basis"])
    assert operator_from_dict(d["hamiltonian"], b).basis is b


def test_package_and_clis_import_without_yaml_and_h5py():
    code = ("import sys\n"
            "sys.modules['yaml'] = None\n"
            "sys.modules['h5py'] = None\n"
            "import distributed_matvec_tpu_torch\n"
            "import distributed_matvec_tpu_torch.apps.diagonalize\n"
            "import distributed_matvec_tpu_torch.apps.dynamics\n"
            "import distributed_matvec_tpu_torch.io\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
