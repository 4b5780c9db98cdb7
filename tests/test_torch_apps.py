"""The port's command lines (``apps/diagonalize.py``, ``apps/dynamics.py``)
against the JAX package's apps on the same YAML, on the CPU.

Each CLI runs in its own process (the port's with ``--device cpu``); the
JAX app runs once per configuration, all of them started together by a
module-scoped fixture.  The files must hold the same datasets with the
same dtypes and shapes, the same basis bits, eigenvalues within 1e-10,
eigenvectors with ``|⟨v_jax|v_port⟩| ≥ 1 − 1e-10`` and observables and
dynamics outputs within 1e-10.  Then: the rerun restores its basis from
the file; two gloo ranks write the one-process file; ``--submit`` without
a spool exits 2; ``--shards`` and the solver checkpoints run;
SIGTERM exits 75; ``--submit`` is drained by the port's service.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
pytest.importorskip("yaml")

from distributed_matvec_tpu_torch.apps import diagonalize, dynamics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the 10-ring's k = 0 sector (translation, reflection, spin inversion)
#: with two observables that commute with the group
RING_YAML = """
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

#: the plain 10-ring (252 states: a Krylov bracket of 20 steps is stable
#: to the last digits) with the same observables, for the dynamics apps and
#: the service
PLAIN_YAML = RING_YAML.replace("""  spin_inversion: 1
  symmetries:
    - {permutation: [1,2,3,4,5,6,7,8,9,0], sector: 0}
    - {permutation: [9,8,7,6,5,4,3,2,1,0], sector: 0}
""", "")


def _ring16_yaml():
    """The plain 16-ring (12 870 states): a solve long enough to signal."""
    sites = [[i, (i + 1) % 16] for i in range(16)]
    terms = "\n".join(f'    - {{expression: "σ{a}₀ σ{a}₁", sites: {sites}}}'
                      for a in "ˣʸᶻ")
    return ("basis: {number_spins: 16, hamming_weight: 8}\n"
            f"hamiltonian:\n  terms:\n{terms}\n")


#: diagonalize runs by name → the arguments both apps get
DIAG = {"ell_k2_observables": ["-k", "2", "--observables"],
        "streamed": ["--mode", "streamed"],
        "devices4": ["--devices", "4"],
        "block_k2": ["--block", "-k", "2"]}
#: dynamics runs by name → the arguments both apps get
DYN = {"kpm": ["--solver", "kpm", "--moments", "32", "--vectors", "2",
               "--bounds-iters", "20"],
       "evolve": ["--solver", "evolve", "--t-final", "0.5",
                  "--observables"]}

PORT_DIAG = [sys.executable, "-m",
             "distributed_matvec_tpu_torch.apps.diagonalize"]
PORT_DYN = [sys.executable, "-m", "distributed_matvec_tpu_torch.apps.dynamics"]
JAX_DIAG = [sys.executable, os.path.join(ROOT, "apps", "diagonalize.py")]
JAX_DYN = [sys.executable, os.path.join(ROOT, "apps", "dynamics.py")]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("DMT_OBS_DIR", "DMT_FAULT", "DMT_JOB_ID")}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="true",
               PYTHONUNBUFFERED="1", **extra)
    return env


def _start(cmd, **env):
    return subprocess.Popen(cmd, cwd=ROOT, env=_env(**env), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(p, timeout=240):
    out, err = p.communicate(timeout=timeout)
    return p.returncode, out, err


#: app processes the fixture keeps running at once (the suite's other
#: workers share the machine)
PARALLEL = 3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every configuration through both packages' apps, PARALLEL at a
    time; name → {"jax"|"port": (rc, stdout, stderr, path)}."""
    d = tmp_path_factory.mktemp("apps")
    ypath, plain = str(d / "ring.yaml"), str(d / "plain.yaml")
    for path, text in ((ypath, RING_YAML), (plain, PLAIN_YAML)):
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
    todo = []
    for table, cmds, model, ext in ((DIAG, (JAX_DIAG, PORT_DIAG), ypath,
                                     ".h5"),
                                    (DYN, (JAX_DYN, PORT_DYN), plain,
                                     ".dyn.h5")):
        for name, extra in table.items():
            for who, cmd in zip(("jax", "port"), cmds):
                out = str(d / f"{who}_{name}{ext}")
                dev = ["--device", "cpu"] if who == "port" else []
                todo.append((name, who, cmd + [model, "-o", out, *extra,
                                               *dev], out))
    res, running = {}, []
    while todo or running:
        while todo and len(running) < PARALLEL:
            name, who, argv, out = todo.pop(0)
            running.append((name, who, _start(argv), out))
        name, who, p, out = running.pop(0)
        res.setdefault(name, {})[who] = (*_finish(p), out)
    for name, by in res.items():
        for who, (rc, so, se, _) in by.items():
            assert rc == 0, f"{who} {name}: rc {rc}\n{so}\n{se[-3000:]}"
    res["_yaml"], res["_plain"], res["_dir"] = ypath, plain, str(d)
    return res


def _layout(path):
    """name → (dtype, shape) of every dataset."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, (o.dtype.str, o.shape))
                     if isinstance(o, h5py.Dataset) else None)
    return out


def _read(path, name):
    with h5py.File(path, "r") as f:
        return f[name][...]


def _assert_same_solution(got_path, want_path, observables=False):
    assert _layout(got_path) == _layout(want_path)
    for name in ("basis/representatives", "basis/norms"):
        np.testing.assert_array_equal(_read(got_path, name),
                                      _read(want_path, name))
    w_t = _read(got_path, "hamiltonian/eigenvalues")
    w_j = _read(want_path, "hamiltonian/eigenvalues")
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=1e-10)
    v_t = _read(got_path, "hamiltonian/eigenvectors")
    v_j = _read(want_path, "hamiltonian/eigenvectors")
    for i in range(v_j.shape[0]):
        assert abs(np.vdot(v_j[i], v_t[i])) >= 1 - 1e-10, i
    if observables:
        with h5py.File(want_path, "r") as f:
            names = sorted(f["observables"])
        assert names == ["nnn", "zz"]
        for n in names:
            np.testing.assert_allclose(_read(got_path, f"observables/{n}"),
                                       _read(want_path, f"observables/{n}"),
                                       rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", sorted(DIAG))
def test_diagonalize_matches_jax(runs, name):
    _assert_same_solution(runs[name]["port"][3], runs[name]["jax"][3],
                          observables="observables" in name)
    rc, out, _, path = runs[name]["port"]
    assert "checkpointed to" in out and "E[0] =" in out


@pytest.mark.parametrize("name", sorted(DYN))
def test_dynamics_matches_jax(runs, name):
    got, want = runs[name]["port"][3], runs[name]["jax"][3]
    assert _layout(got) == _layout(want)
    group = DYN[name][1]
    with h5py.File(want, "r") as f:
        keys = sorted(f[group])
    if name == "evolve":
        assert {"obs_zz", "obs_nnn", "obs_zz_t"} <= set(keys)
    for k in keys:
        np.testing.assert_allclose(_read(got, f"{group}/{k}"),
                                   _read(want, f"{group}/{k}"),
                                   rtol=0, atol=1e-10, err_msg=k)
    assert f"wrote /{group}" in runs[name]["port"][1]


def test_rerun_restores_the_basis(runs):
    """The same argv again restores the representatives from its file and
    finds the same eigenpairs."""
    path = runs["ell_k2_observables"]["port"][3]
    before = _read(path, "hamiltonian/eigenvalues")
    rc, out, err = _finish(_start(PORT_DIAG + [
        runs["_yaml"], "-o", path, *DIAG["ell_k2_observables"],
        "--device", "cpu"]))
    assert rc == 0, err
    assert f"restored from {path}" in out
    np.testing.assert_array_equal(_read(path, "hamiltonian/eigenvalues"),
                                  before)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_write_the_one_process_file(runs):
    """``--num-processes 2``: one hash shard per rank over gloo; rank 0's
    file holds the one-process run's solution."""
    out = os.path.join(runs["_dir"], "ranks.h5")
    port = _free_port()
    procs = [_start(PORT_DIAG + [
        runs["_yaml"], "-o", out, "-k", "2", "--device", "cpu",
        "--coordinator", f"localhost:{port}", "--num-processes", "2",
        "--process-id", str(r)]) for r in range(2)]
    results = [_finish(p, timeout=180) for p in procs]
    for r, (rc, so, se) in enumerate(results):
        assert rc == 0, f"rank {r}: {so}\n{se[-3000:]}"
    assert "E[0] =" in results[0][1] and "E[0] =" in results[1][1]
    want = runs["ell_k2_observables"]["jax"][3]
    got_layout = _layout(out)
    assert got_layout == {k: v for k, v in _layout(want).items()
                          if not k.startswith("observables")}
    for name in ("basis/representatives", "basis/norms"):
        np.testing.assert_array_equal(_read(out, name), _read(want, name))
    np.testing.assert_allclose(_read(out, "hamiltonian/eigenvalues"),
                               _read(want, "hamiltonian/eigenvalues"),
                               rtol=0, atol=1e-10)
    v_t = _read(out, "hamiltonian/eigenvectors")
    v_j = _read(want, "hamiltonian/eigenvectors")
    for i in range(2):
        assert abs(np.vdot(v_j[i], v_t[i])) >= 1 - 1e-10


@pytest.mark.parametrize("argv,needle", [
    (["--submit"], "--serve-dir")])
def test_diagonalize_refusals_exit_2(tmp_path, capsys, argv, needle):
    assert diagonalize.main([str(tmp_path / "m.yaml"), "--device", "cpu",
                             *argv]) == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and needle in err[0]
    assert not os.listdir(tmp_path)


def _lowest(ypath: str) -> float:
    """E0 of the YAML model's sector, from the port's one-device engine."""
    from distributed_matvec_tpu_torch.models.yaml_io import (
        load_config_from_yaml)
    from distributed_matvec_tpu_torch.parallel.engine import LocalEngine
    from distributed_matvec_tpu_torch.solve import lanczos

    cfg = load_config_from_yaml(ypath)
    eng = LocalEngine(cfg.hamiltonian, device="cpu")
    return float(lanczos(eng.matvec, n=cfg.basis.number_states, tol=1e-12,
                         device="cpu").eigenvalues[0])


@pytest.mark.parametrize("argv", [
    ["--shards", "s.h5"],
    ["--solver-checkpoint", "ck.h5"],
    ["--solver-checkpoint", "ck.h5", "--block", "--mode", "streamed"]],
    ids=["shards", "solver_checkpoint", "checkpoint_block_streamed"])
def test_diagonalize_shard_and_checkpoint_flags(tmp_path, capsys, argv):
    """The flags that exited 2 until the sharded enumeration and the
    solvers' checkpoints were ported now solve: ``--shards`` from a shard
    file (eigenvectors per shard under ``vector_shards``), and
    ``--solver-checkpoint`` for Lanczos and for LOBPCG on a streamed engine
    (a rerun resumes from the file).  tests/test_torch_checkpoint.py holds
    the files against the JAX apps'."""
    from distributed_matvec_tpu_torch.enumeration.sharded import (
        enumerate_to_shards)
    from distributed_matvec_tpu_torch.io.sharded_io import load_hashed_shard
    from distributed_matvec_tpu_torch.models.yaml_io import (
        load_config_from_yaml)

    ypath, out = str(tmp_path / "m.yaml"), str(tmp_path / "out.h5")
    with open(ypath, "w", encoding="utf-8") as f:
        # the 10-ring sector's Krylov space closes within one block, too
        # soon for a checkpoint: the checkpointed solves run the 16-ring
        f.write(RING_YAML if "--shards" in argv else _ring16_yaml())
    argv = [str(tmp_path / a) if a.endswith(".h5") else a for a in argv]
    if "--solver-checkpoint" in argv:
        argv += ["--checkpoint-every", "1"]
    if "--shards" in argv:
        b = load_config_from_yaml(ypath).basis
        enumerate_to_shards(b.number_spins, b.hamming_weight, b.group, 2,
                            argv[1])
    e0 = _lowest(ypath)
    run = [ypath, "-o", out, "--device", "cpu", "--tol", "1e-12", *argv]
    assert diagonalize.main(run) == 0
    np.testing.assert_allclose(_read(out, "hamiltonian/eigenvalues")[0],
                               e0, rtol=0, atol=1e-8)
    if "--shards" in argv:
        rows = [load_hashed_shard(out, d, "eigenvector_0") for d in (0, 1)]
        assert sum(r.size for r in rows) == 13          # the sector's N
        assert "basis" not in h5py.File(out, "r")
    else:
        assert os.path.exists(argv[1])
        capsys.readouterr()
        assert diagonalize.main(run) == 0
        np.testing.assert_allclose(
            _read(out, "hamiltonian/eigenvalues")[0], e0, rtol=0,
            atol=1e-8)


def test_dynamics_checkpoint_exits_2(tmp_path, capsys):
    """``dynamics --checkpoint`` exited 2 until the solvers' checkpoints
    were ported; now the trajectory is checkpointed, and a rerun with the
    same argv resumes it and writes the same trajectory."""
    ypath, out = str(tmp_path / "m.yaml"), str(tmp_path / "d.h5")
    with open(ypath, "w", encoding="utf-8") as f:
        f.write(PLAIN_YAML)
    run = [ypath, "-o", out, "--solver", "evolve", "--t-final", "0.5",
           "--checkpoint", str(tmp_path / "c.h5"), "--checkpoint-every",
           "1", "--device", "cpu"]
    assert dynamics.main(run) == 0
    times = _read(out, "evolve/times")
    assert "resumed" not in capsys.readouterr().out
    assert dynamics.main(run) == 0
    assert "solver: resumed from" in capsys.readouterr().out
    np.testing.assert_array_equal(_read(out, "evolve/times"), times)


@pytest.mark.parametrize("cmd", [PORT_DIAG, PORT_DYN],
                         ids=["diagonalize", "dynamics"])
def test_config_without_hamiltonian_exits_2(tmp_path, cmd):
    ypath = str(tmp_path / "m.yaml")
    with open(ypath, "w") as f:
        f.write("basis: {number_spins: 8, hamming_weight: 4}\n")
    rc, out, err = _finish(_start(cmd + [ypath, "--device", "cpu"]))
    assert rc == 2 and "no hamiltonian" in err, err


def test_sigterm_exits_75(runs, tmp_path):
    """SIGTERM once the basis is built: the solve stops at its next safe
    point, the app exits 75 and writes no eigenpairs."""
    ypath, out = str(tmp_path / "ring16.yaml"), str(tmp_path / "pre.h5")
    with open(ypath, "w", encoding="utf-8") as f:
        f.write(_ring16_yaml())
    p = _start(PORT_DIAG + [ypath, "-o", out, "--device", "cpu",
                            "--tol", "1e-300", "--max-iters", "100000"],
               DMT_FAULT="solver_block:delay=300:n=100000")
    try:
        deadline = time.time() + 120
        line = ""
        while "basis:" not in line and time.time() < deadline:
            line = p.stdout.readline()
            if not line and p.poll() is not None:
                break
        assert "basis:" in line, p.stderr.read()
        time.sleep(0.5)
        p.send_signal(signal.SIGTERM)
        rc, _, err = _finish(p, timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
    assert rc == 75 and "preempted" in err, err
    assert "hamiltonian/eigenvalues" not in _layout(out)


def test_submit_drained_by_port_service(runs, tmp_path):
    """``--submit`` spools a yaml job spec; the port's service builds its
    engine through the YAML loader and finds the E0 of the same model
    submitted as an inline spec."""
    from distributed_matvec_tpu_torch.serve import (JobSpec, SolveService,
                                                    submit_to_spool)

    spool = str(tmp_path / "spool")
    assert diagonalize.main([runs["_plain"], "--submit", "--serve-dir",
                             spool, "--job-id", "yaml-job"]) == 0
    inline = JobSpec(job_id="inline-job",
                     basis={"number_spins": 10, "hamming_weight": 5})
    submit_to_spool(spool, inline)
    assert SolveService(spool, device="cpu").run(drain=True) == 0
    recs = {}
    for job in ("yaml-job", "inline-job"):
        with open(os.path.join(spool, "done", f"{job}.json")) as f:
            recs[job] = json.load(f)
        assert recs[job]["status"] == "done", recs[job]
    assert abs(recs["yaml-job"]["eigenvalues"][0]
               - recs["inline-job"]["eigenvalues"][0]) < 1e-10


@pytest.mark.parametrize("app", [diagonalize, dynamics],
                         ids=["diagonalize", "dynamics"])
def test_clis_refuse_cpu_without_request(runs, monkeypatch, app):
    """Without a card the CLIs raise at once unless ``--device cpu`` is
    given; nothing falls back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main([runs["_plain"], "-o", os.devnull])
