"""The solvers' checkpoints and resume: the port's ``lanczos``, ``lobpcg``,
KPM and ``krylov_evolve`` with ``checkpoint_path``, and the CLIs'
``--shards``, ``--solver-checkpoint`` and ``dynamics --checkpoint``,
against the JAX package in one process, on chain_12_symm and
chain_14_symm, at D ∈ {1, 2, 3, 4}.

A solve is interrupted by a preemption at a block boundary (the latch is
set at the second safe point) and resumed — on the same D, or on another
through the Resharder.  Bars:

* Lanczos: the resumed E0 within 1e-10 of the uninterrupted solve's, in
  the same number of iterations; the JAX solver's E0 on the same operator
  within 1e-10;
* LOBPCG: on the same D the resumed solve equals the uninterrupted one
  (its eigenvalues bit for bit); on another D within 1e-10;
* KPM: the moments bit-equal on the same D, within 1e-12 on another;
* evolve: ``psi`` and the trajectory bit-equal on the same D, within
  1e-12 on another;
* files: the datasets and attributes of the JAX package's checkpoint,
  its metadata equal, its Krylov rows within 1e-9 (the two packages'
  recurrences round differently); a checkpoint written by either
  package resumes in the other.
"""

import importlib
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")
pytest.importorskip("yaml")

from distributed_matvec_tpu.enumeration import sharded as jax_sharded
from distributed_matvec_tpu.models import yaml_io as jax_yaml
from distributed_matvec_tpu.parallel.distributed import \
    DistributedEngine as JaxEngine
from distributed_matvec_tpu.solve import kpm_moments as jax_kpm
from distributed_matvec_tpu.solve import krylov_evolve as jax_evolve
from distributed_matvec_tpu.solve import lanczos as jax_lanczos
from distributed_matvec_tpu.solve import lobpcg as jax_lobpcg
from distributed_matvec_tpu_torch import obs
from distributed_matvec_tpu_torch.io.hdf5 import (load_engine_structure,
                                                  save_engine_structure)
from distributed_matvec_tpu_torch.models import yaml_io
from distributed_matvec_tpu_torch.parallel.distributed import \
    DistributedEngine
from distributed_matvec_tpu_torch.solve import (kpm_moments, krylov_evolve,
                                                lanczos, lobpcg)
from distributed_matvec_tpu_torch.utils import faults, preempt

from chip_smoke import chain_config, chain_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the module (``solve.lanczos`` the name is the function)
lz = importlib.import_module("distributed_matvec_tpu_torch.solve.lanczos")


def _ops(n):
    """chain_<n>_symm in both packages from one config dict, both built."""
    d = chain_config(n)
    bj = jax_yaml.basis_from_dict(d["basis"])
    bt = yaml_io.basis_from_dict(d["basis"])
    bj.build()
    bt.build()
    return (jax_yaml.operator_from_dict(d["hamiltonian"], bj),
            yaml_io.operator_from_dict(d["hamiltonian"], bt))


@pytest.fixture(scope="module")
def chain14():
    return _ops(14)


def _eng(op, D, mode="ell"):
    return DistributedEngine(op, n_devices=D, mode=mode, device="cpu")


@pytest.fixture
def preempt_at(monkeypatch):
    """``preempt_at(k)``: the port's latch reads set at the k-th safe point
    from now (0: never)."""
    box = {"k": 0, "n": 0}

    def agreed(group):
        box["n"] += 1
        return box["n"] == box["k"]

    monkeypatch.setattr(preempt, "agreed", agreed)

    def arm(k):
        box.update(k=k, n=0)
    return arm


def _interrupt(solve, arm):
    """Run ``solve`` with the latch set at the second safe point; it must
    stop with ``Preempted`` naming its checkpoint."""
    arm(2)
    with pytest.raises(preempt.Preempted) as e:
        solve()
    arm(0)
    assert e.value.checkpoint_path
    return e.value


LANCZOS_CASES = [(2, 2), (4, 2), (1, 3), (3, 1), (4, 4)]


@pytest.mark.parametrize("D,Dp", LANCZOS_CASES,
                         ids=[f"{a}to{b}" for a, b in LANCZOS_CASES])
def test_lanczos_resume(chain14, tmp_path, preempt_at, D, Dp):
    op_j, op_t = chain14
    ck = str(tmp_path / "ck.h5")
    src, dst = _eng(op_t, D), _eng(op_t, Dp)
    kw = dict(k=1, tol=1e-12, check_every=8)
    full = lanczos(src.matvec, v0=src.random_hashed(42), **kw)
    e = _interrupt(lambda: lanczos(src.matvec, v0=src.random_hashed(42),
                                   checkpoint_path=ck, checkpoint_every=100,
                                   **kw), preempt_at)
    assert e.solver == "lanczos" and e.iters == 16 and os.path.exists(ck)
    res = lanczos(dst.matvec, v0=dst.random_hashed(42), checkpoint_path=ck,
                  **kw)
    assert res.resumed_from == 16
    assert abs(res.eigenvalues[0] - full.eigenvalues[0]) < 1e-10
    assert res.num_iters == full.num_iters
    if D != Dp:
        kinds = [ev.get("status") for ev in obs.events("solver_checkpoint")]
        assert "resharded" in kinds
    je = JaxEngine(op_j, n_devices=Dp, mode="ell")
    want = jax_lanczos(je.matvec, v0=je.random_hashed(seed=42), k=1,
                       tol=1e-12).eigenvalues[0]
    assert abs(res.eigenvalues[0] - want) < 1e-10


def _ckpt_tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        g = f["engine_structure"]
        for k, v in g.attrs.items():
            out["@" + k] = np.asarray(v)
        for k in g:
            out[k] = g[k][...]
    return out


@pytest.mark.parametrize("D", [1, 3])
def test_lanczos_checkpoint_file_equals_jax(chain14, tmp_path, D):
    """Both packages checkpoint the same 32-step solve: the same datasets
    and attributes, the metadata (key, topology stanza, counters) equal,
    the rows and the recurrence within 1e-9.  Each package resumes from
    the other's file to the same E0."""
    op_j, op_t = chain14
    te, je = _eng(op_t, D), JaxEngine(op_j, n_devices=D, mode="ell")
    pj, pt = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    kw = dict(k=1, tol=1e-300, max_iters=32, check_every=16,
              checkpoint_every=1, reorth="full")
    jax_lanczos(je.matvec, v0=je.random_hashed(seed=42), checkpoint_path=pj,
                **kw)
    lanczos(te.matvec, v0=te.random_hashed(42), checkpoint_path=pt, **kw)
    tj, tt = _ckpt_tree(pj), _ckpt_tree(pt)
    assert sorted(tj) == sorted(tt)
    for k in tj:
        assert tj[k].dtype == tt[k].dtype and tj[k].shape == tt[k].shape, k
        if tj[k].dtype.kind in "fc":
            np.testing.assert_allclose(tt[k], tj[k], rtol=0, atol=1e-9,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(tt[k], tj[k], err_msg=k)
    want = jax_lanczos(je.matvec, v0=je.random_hashed(seed=42), k=1,
                       tol=1e-12).eigenvalues[0]
    res = lanczos(te.matvec, v0=te.random_hashed(42), k=1, tol=1e-12,
                  checkpoint_path=pj)
    assert res.resumed_from == 32 and abs(res.eigenvalues[0] - want) < 1e-10
    back = jax_lanczos(je.matvec, v0=je.random_hashed(seed=42), k=1,
                       tol=1e-12, checkpoint_path=pt)
    assert back.resumed_from == 32
    assert abs(back.eigenvalues[0] - want) < 1e-10


def test_lanczos_v1_checkpoint_restores(chain14, tmp_path):
    """A fixed-D checkpoint (the shape-keyed v1 key, no topology stanza)
    restores on its D, and is not found on another."""
    _, op_t = chain14
    eng = _eng(op_t, 3)
    ck, v1 = str(tmp_path / "ck.h5"), str(tmp_path / "v1.h5")
    lanczos(eng.matvec, v0=eng.random_hashed(42), k=1, tol=1e-300,
            max_iters=16, check_every=16, checkpoint_path=ck,
            checkpoint_every=1)
    key = lz._operator_key(eng)
    got = load_engine_structure(ck, f"hashed()|<f8|{key}|lanczos-v3")
    assert int(got["topology_d"]) == 3
    payload = {k: got[k] for k in ("alph", "bet", "lock_theta",
                                   "lock_sigma", "m", "total_iters", "V")}
    shape = (3, eng.shard_size)
    save_engine_structure(v1, f"{shape}|<f8|{key}|lanczos-v2", "lanczos",
                          payload)
    full = lanczos(eng.matvec, v0=eng.random_hashed(42), k=1, tol=1e-12)
    res = lanczos(eng.matvec, v0=eng.random_hashed(42), k=1, tol=1e-12,
                  checkpoint_path=v1)
    assert res.resumed_from == 16
    assert abs(res.eigenvalues[0] - full.eigenvalues[0]) < 1e-10
    other = _eng(op_t, 2)
    assert lanczos(other.matvec, v0=other.random_hashed(42), k=1,
                   tol=1e-12, checkpoint_path=v1).resumed_from == 0


def test_reshard_fault_and_foreign_partition_start_fresh(chain14, tmp_path,
                                                         monkeypatch):
    """The ``ckpt_reshard`` fault and a checkpoint of another partition
    degrade to a fresh solve, never to a half-resharded basis."""
    _, op_t = chain14
    src, dst = _eng(op_t, 4), _eng(op_t, 2)
    ck = str(tmp_path / "ck.h5")
    kw = dict(k=1, tol=1e-12)
    lanczos(src.matvec, v0=src.random_hashed(42), tol=1e-300, max_iters=16,
            check_every=16, checkpoint_path=ck, checkpoint_every=1)
    full = lanczos(dst.matvec, v0=dst.random_hashed(42), **kw)
    monkeypatch.setenv("DMT_FAULT", "ckpt_reshard:n=1")
    faults.reset()
    try:
        res = lanczos(dst.matvec, v0=dst.random_hashed(42),
                      checkpoint_path=ck, **kw)
    finally:
        monkeypatch.delenv("DMT_FAULT")
        faults.reset()
    assert res.resumed_from == 0
    assert abs(res.eigenvalues[0] - full.eigenvalues[0]) < 1e-10
    assert obs.events("solver_checkpoint")[-1]["status"] == "reshard_failed"
    with h5py.File(ck, "a") as f:
        f["engine_structure"].attrs["partition_fp"] = "xorshift:0"
    res = lanczos(dst.matvec, v0=dst.random_hashed(42), checkpoint_path=ck,
                  **kw)
    assert res.resumed_from == 0
    assert obs.events("solver_checkpoint")[-1]["status"] == \
        "refused_partition"


LOBPCG_CASES = [(3, 3), (4, 2), (1, 3)]


@pytest.mark.parametrize("D,Dp", LOBPCG_CASES,
                         ids=[f"{a}to{b}" for a, b in LOBPCG_CASES])
def test_lobpcg_resume(chain14, tmp_path, preempt_at, D, Dp):
    op_j, op_t = chain14
    n = op_t.basis.number_states
    src, dst = _eng(op_t, D), _eng(op_t, Dp)
    ck = str(tmp_path / "ck.h5")
    kw = dict(k=2, tol=1e-12, checkpoint_every=4)
    full = lobpcg(dst.matvec, n, checkpoint_path=str(tmp_path / "u.h5"),
                  **kw) if D == Dp else None
    e = _interrupt(lambda: lobpcg(src.matvec, n, checkpoint_path=ck, **kw),
                   preempt_at)
    assert e.solver == "lobpcg" and e.iters == 8
    w, V, it = lobpcg(dst.matvec, n, checkpoint_path=ck, **kw)
    assert obs.events("solver_resume")[-1]["iters"] == 8
    if full is not None:
        np.testing.assert_array_equal(w, full[0])
        assert it == full[2]
    want = jax_lobpcg(JaxEngine(op_j, n_devices=Dp, mode="ell").matvec, n,
                      k=2, tol=1e-12)[0]
    np.testing.assert_allclose(w, want, rtol=0, atol=1e-10)


KPM_CASES = [(2, 2), (4, 1), (1, 3)]


@pytest.mark.parametrize("D,Dp", KPM_CASES,
                         ids=[f"{a}to{b}" for a, b in KPM_CASES])
def test_kpm_resume(chain14, tmp_path, preempt_at, D, Dp):
    op_j, op_t = chain14
    src, dst = _eng(op_t, D), _eng(op_t, Dp)
    ck = str(tmp_path / "ck.h5")
    kw = dict(n_moments=40, n_vectors=2, seed=3, bounds=(-30.0, 16.0),
              checkpoint_every=4)
    # the same start block at both D (a block-order draw, hashed)
    blk = src.from_hashed(src.random_hashed(3, cols=2))
    full = kpm_moments(dst.matvec, V0=dst.to_hashed(blk),
                       **{k: v for k, v in kw.items()
                          if k != "checkpoint_every"})
    _interrupt(lambda: kpm_moments(src.matvec, V0=src.to_hashed(blk),
                                   checkpoint_path=ck, **kw), preempt_at)
    res = kpm_moments(dst.matvec, V0=dst.to_hashed(blk), checkpoint_path=ck,
                      **kw)
    assert res.resumed_from == 2
    if D == Dp:
        np.testing.assert_array_equal(res.moments, full.moments)
    else:
        np.testing.assert_allclose(res.moments, full.moments, rtol=0,
                                   atol=1e-12)
    je = JaxEngine(op_j, n_devices=D, mode="ell")
    want = jax_kpm(je.matvec, V0=je.to_hashed(blk),
                   **{k: v for k, v in kw.items() if k != "checkpoint_every"})
    np.testing.assert_allclose(res.moments, np.asarray(want.moments),
                               rtol=0, atol=1e-10)


EVOLVE_CASES = [(3, 3), (2, 4), (4, 1)]


@pytest.mark.parametrize("D,Dp", EVOLVE_CASES,
                         ids=[f"{a}to{b}" for a, b in EVOLVE_CASES])
def test_evolve_resume(chain14, tmp_path, preempt_at, D, Dp):
    op_j, op_t = chain14
    src, dst = _eng(op_t, D), _eng(op_t, Dp)
    ck = str(tmp_path / "ck.h5")
    kw = dict(t_final=1.0, tol=1e-10, krylov_dim=12, seed=5,
              checkpoint_every=1)
    psi_b = src.from_hashed(src.random_hashed(5))
    full = krylov_evolve(dst.matvec, psi0=dst.to_hashed(psi_b),
                         **{k: v for k, v in kw.items()
                            if k != "checkpoint_every"})
    _interrupt(lambda: krylov_evolve(src.matvec, psi0=src.to_hashed(psi_b),
                                     checkpoint_path=ck, **kw), preempt_at)
    res = krylov_evolve(dst.matvec, psi0=dst.to_hashed(psi_b),
                        checkpoint_path=ck, **kw)
    assert res.resumed_from == 1 and res.num_steps == full.num_steps
    if D == Dp:
        assert torch.equal(res.psi, full.psi)
        np.testing.assert_array_equal(res.times, full.times)
    else:
        torch.testing.assert_close(res.psi, full.psi, rtol=0, atol=1e-12)
        np.testing.assert_allclose(res.times, full.times, rtol=0,
                                   atol=1e-12)
    je = JaxEngine(op_j, n_devices=Dp, mode="ell")
    want = jax_evolve(je.matvec, psi0=je.to_hashed(psi_b),
                      **{k: v for k, v in kw.items()
                         if k != "checkpoint_every"})
    np.testing.assert_allclose(dst.from_hashed(res.psi),
                               je.from_hashed(want.psi), rtol=0, atol=1e-10)


# -- the command lines ---------------------------------------------------------

PORT_DIAG = [sys.executable, "-m",
             "distributed_matvec_tpu_torch.apps.diagonalize"]
PORT_DYN = [sys.executable, "-m", "distributed_matvec_tpu_torch.apps.dynamics"]
JAX_DIAG = [sys.executable, os.path.join(ROOT, "apps", "diagonalize.py")]
JAX_DYN = [sys.executable, os.path.join(ROOT, "apps", "dynamics.py")]


def _start(cmd, **extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("DMT_OBS_DIR", "DMT_FAULT", "DMT_JOB_ID")}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="true",
               PYTHONUNBUFFERED="1", **extra)
    return subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(p, timeout=300):
    out, err = p.communicate(timeout=timeout)
    return p.returncode, out, err


def _read(path, name):
    with h5py.File(path, "r") as f:
        return f[name][...]


def _vector_layout(path):
    with h5py.File(path, "r") as f:
        g = f["vector_shards"]
        return {f"{v}/{d}": (g[v][d].shape, g[v][d].dtype.str)
                for v in g for d in g[v]}


def test_cli_shards_against_jax_app(tmp_path):
    """``diagonalize --shards`` on a JAX-written shard file (D = 3): the
    two apps' files hold the same eigenvalues within 1e-10 and the same
    ``vector_shards`` layout, with eigenvectors that agree per shard up
    to a sign; ``--observables`` runs on the shard-native engines."""
    ypath = str(tmp_path / "m.yaml")
    with open(ypath, "w", encoding="utf-8") as f:
        f.write(chain_yaml(14))
    d = chain_config(14)
    b = jax_yaml.basis_from_dict(d["basis"])
    shards = str(tmp_path / "s.h5")
    jax_sharded.enumerate_to_shards(14, 7, b.group, 3, shards)
    outs = {who: str(tmp_path / f"{who}.h5") for who in ("jax", "port")}
    procs = [_start(JAX_DIAG + [ypath, "-o", outs["jax"], "--shards",
                                shards, "-k", "2", "--devices", "3"]),
             _start(PORT_DIAG + [ypath, "-o", outs["port"], "--shards",
                                 shards, "-k", "2", "--device", "cpu"])]
    for p in procs:
        rc, so, se = _finish(p)
        assert rc == 0, so + se[-3000:]
        assert "shard-native from" in so
    np.testing.assert_allclose(_read(outs["port"], "hamiltonian/eigenvalues"),
                               _read(outs["jax"], "hamiltonian/eigenvalues"),
                               rtol=0, atol=1e-10)
    assert _vector_layout(outs["port"]) == _vector_layout(outs["jax"])
    with h5py.File(outs["port"], "r") as f:
        assert "basis" not in f and "eigenvectors" not in f["hamiltonian"]
    vt = np.concatenate([_read(outs["port"], f"vector_shards/eigenvector_0/{d}")
                         for d in range(3)])
    vj = np.concatenate([_read(outs["jax"], f"vector_shards/eigenvector_0/{d}")
                         for d in range(3)])
    assert abs(np.vdot(vj, vt)) >= 1 - 1e-10


def _sigterm_when(p, path, timeout=180):
    """SIGTERM ``p`` once ``path`` exists; returns (rc, stdout, stderr)."""
    deadline = time.time() + timeout
    while not os.path.exists(path) and p.poll() is None \
            and time.time() < deadline:
        time.sleep(0.05)
    assert os.path.exists(path), _finish(p)
    p.send_signal(signal.SIGTERM)
    return _finish(p, timeout=120)


@pytest.mark.parametrize("devs", [("4", "4"), ("4", "2")],
                         ids=["same_D", "4to2"])
def test_cli_solver_checkpoint_sigterm_resume(tmp_path, devs):
    """``diagonalize --solver-checkpoint``: SIGTERM once the checkpoint
    exists → exit 75; the relaunch (on the same --devices, or another)
    resumes from it to the JAX app's E0 within 1e-10."""
    ypath = str(tmp_path / "m.yaml")
    with open(ypath, "w", encoding="utf-8") as f:
        f.write(chain_yaml(16))
    ck, out = str(tmp_path / "ck.h5"), str(tmp_path / "out.h5")
    jout = str(tmp_path / "jax.h5")
    jp = _start(JAX_DIAG + [ypath, "-o", jout, "--tol", "1e-12"])
    base = [ypath, "-o", out, "--tol", "1e-12", "--device", "cpu",
            "--solver-checkpoint", ck, "--checkpoint-every", "1",
            "--no-eigenvectors"]
    p = _start(PORT_DIAG + base + ["--devices", devs[0]],
               DMT_FAULT="solver_block:delay=400:n=100000")
    rc, so, se = _sigterm_when(p, ck)
    assert rc == 75 and "preempted" in se, se[-2000:]
    rc, so, se = _finish(_start(PORT_DIAG + base + ["--devices", devs[1]]))
    assert rc == 0, se[-2000:]
    assert "solver: resumed from" in so, so
    rc, jso, jse = _finish(jp)
    assert rc == 0, jse[-2000:]
    np.testing.assert_allclose(_read(out, "hamiltonian/eigenvalues"),
                               _read(jout, "hamiltonian/eigenvalues"),
                               rtol=0, atol=1e-10)


def test_cli_dynamics_checkpoint_against_jax(tmp_path):
    """``dynamics --checkpoint`` (evolve): SIGTERM once the checkpoint
    exists → 75; the relaunch resumes and writes the trajectory of an
    uninterrupted run bit for bit, and the JAX app's start and end (time
    and energy) within 1e-10."""
    ypath = str(tmp_path / "m.yaml")
    with open(ypath, "w", encoding="utf-8") as f:
        f.write(chain_yaml(14))
    args = ["--solver", "evolve", "--t-final", "2", "--krylov-dim", "12",
            "--checkpoint-every", "1"]
    ck = str(tmp_path / "ck.h5")
    outs = {k: str(tmp_path / f"{k}.h5") for k in ("port", "ref", "jax")}
    ref = _start(PORT_DYN + [ypath, "-o", outs["ref"], "--device", "cpu",
                             *args[:-2]])
    jp = _start(JAX_DYN + [ypath, "-o", outs["jax"], *args[:-2]])
    run = PORT_DYN + [ypath, "-o", outs["port"], "--device", "cpu",
                      "--checkpoint", ck, *args]
    rc, so, se = _sigterm_when(
        _start(run, DMT_FAULT="solver_block:delay=300:n=100000"), ck)
    assert rc == 75, se[-2000:]
    rc, so, se = _finish(_start(run))
    assert rc == 0 and "solver: resumed from" in so, so + se[-2000:]
    for p in (ref, jp):
        rc, _, se = _finish(p)
        assert rc == 0, se[-2000:]
    for name in ("evolve/times", "evolve/energies"):
        np.testing.assert_array_equal(_read(outs["port"], name),
                                      _read(outs["ref"], name))
    # the adaptive step sequence is decided at the tolerance's edge, where
    # the two packages' rounding may accept a different step: the ends of
    # the trajectory are held, not every step
    for name in ("evolve/times", "evolve/energies"):
        a, b = _read(outs["port"], name), _read(outs["jax"], name)
        np.testing.assert_allclose(a[[0, -1]], b[[0, -1]], rtol=0,
                                   atol=1e-10)
