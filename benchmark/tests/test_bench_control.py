"""The check has to find wrong what is wrong: the control (the reference
in float32 in the program's place) and the faults the cells can have, each
planted under a whole run of the harness on the CPU at chain_16_symm.  At
D = 1 there is no exchange between chips to leave out."""

import types

import pytest
import torch


def unchanged(eng):
    """A step that returns its state unchanged."""
    eng.matvec = types.MethodType(lambda self, x: x.clone(), eng)


def half(eng):
    """Half of the batch left out (the rows past the middle of the state
    axis), the rest scaled to make up the mean."""
    inner = eng.matvec

    def matvec(self, x):
        y = inner(x)
        axis = 1 if y.dim() == 3 or (y.dim() == 2 and y.shape[0] == 1) else 0
        n = y.shape[axis] // 2
        y = y.clone()
        y.narrow(axis, n, y.shape[axis] - n).zero_()
        return 2 * y
    eng.matvec = types.MethodType(matvec, eng)


def altered(eng):
    """One answer altered where it is produced: a single element of every
    output moved by one part in 10⁶ of the output's largest."""
    inner = eng.matvec

    def matvec(self, x):
        y = inner(x).clone()
        flat = y.view(-1)
        flat[0] += 1e-6 * float(flat.abs().max())
        return y
    eng.matvec = types.MethodType(matvec, eng)


@pytest.mark.parametrize("engine", ["ell", "streamed"])
@pytest.mark.parametrize("traffic", ["e0", "matvec4"])
@pytest.mark.parametrize("fault", [unchanged, half, altered],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(small_bench, engine, traffic, fault):
    r = small_bench(engine, traffic, engine_hook=fault)
    assert not r["correct"], r["checks"]
    assert any(v["value"] > v["limit"] for v in r["checks"].values())


@pytest.mark.parametrize("traffic", ["e0", "matvec4"])
def test_control_is_not_correct(small_bench, traffic):
    """The reference in float32 in the program's place fails a limit."""
    r = small_bench("ell", traffic, control=True)
    assert not r["correct"], r["checks"]


def test_answer_altered_in_the_solver(small_bench, monkeypatch):
    """A solve's eigenvalue altered where the solver returns it."""
    import distributed_matvec_tpu_torch.solve as solve

    real = solve.lanczos

    def lanczos(*a, **kw):
        res = real(*a, **kw)
        res.eigenvalues = res.eigenvalues * (1 + 1e-7)
        return res
    monkeypatch.setattr(solve, "lanczos", lanczos)
    r = small_bench("ell", "e0")
    assert not r["correct"] and r["failed"] >= 1


def test_judge_finds_a_dropped_state():
    """A basis with one state dropped (the program's engines refuse to
    build on it; the check finds it without them)."""
    import checks
    from conftest import small_config

    import harness

    cfg = small_config("ell")
    op = harness.call(cfg["program"]["operator"])
    op.basis.build()
    reps, norms = op.basis.representatives, op.basis.norms
    numbers, _ = checks.judge(cfg, "apply", reps[1:], norms[1:], {}, None,
                              1, torch.device("cpu"))
    assert numbers["basis_count"]["value"] == 1
    assert numbers["basis_bad"]["value"] > 0


def test_wrong_norm_is_not_correct(small_bench):
    """A basis with one norm off."""
    import numpy as np

    import harness
    real = harness.call

    def call(spec, *a, **kw):
        out = real(spec, *a, **kw)
        if spec["call"] == "heisenberg_chain":
            basis = out.basis
            build = basis.build

            def broken(*ba, **bkw):
                build(*ba, **bkw)
                reps = np.array(basis.representatives)
                norms = np.array(basis.norms)
                norms[3] *= 1 + 1e-9
                basis.unchecked_set_representatives(reps, norms)
            basis.build = broken
        return out
    harness.call = call
    try:
        r = small_bench("ell", "matvec4")
    finally:
        harness.call = real
    assert not r["correct"]
    assert r["checks"]["basis_bad"]["value"] > 0
