"""How ``correct`` is decided: the program's outputs against the plain
reference (``reference/``), each number beside the limit its configuration
states.

Numbers compared:

* ``basis_count``: |program's states − the reference's Burnside count|,
  and |that count − the configuration's ``facts.n_states``|, the larger;
* ``basis_bad``: program states out of order, not their orbit's
  representative, with norm 0 or a norm off the reference's, and flips
  whose representative the program's basis lacks;
* ``nnz``: |the reference's distinct off-diagonal elements −
  ``facts.nnz_offdiag``|;
* ``kind: "solve"``: ``e0_gap``, the largest relative gap between a
  solve's lowest eigenvalue and the reference's, over every solve of the
  window; ``e0_residual``, the largest ``‖Hψ − θψ‖ / (|θ|·‖ψ‖)`` under the
  reference's H over the kept eigenpairs;
* ``kind: "apply"``: ``apply_err``, the largest ``max|Y − H·X| /
  max|H·X|`` over the kept calls.

Exact counts have the limit 0.
"""

from __future__ import annotations

import json
import sys
import time
import warnings

import loops
from reference.spin_hamiltonian import SpinModel

#: the precision below float64, in which the control computes
CONTROL_DTYPE = "float32"


def build_reference(cfg: dict, reps, norms, device):
    with warnings.catch_warnings():
        # torch marks its sparse layouts as beta
        warnings.simplefilter("ignore", UserWarning)
        model = SpinModel(cfg["model"], device)
        return model, model.build(reps, norms)


class ControlEngine:
    """The reference in the program's place, computing in the precision
    below the configuration's (float32 for float64): the control that the
    check has to find wrong.  It takes and returns vectors in basis order,
    as ``LocalEngine`` does."""

    def __init__(self, cfg: dict, reps, norms, device, H=None):
        import torch

        self.H = H if H is not None else build_reference(
            cfg, reps, norms, device)[1]
        self.n_states = self.H.n
        self.dtype = getattr(torch, CONTROL_DTYPE)

    def matvec(self, x):
        return self.H.apply(x, self.dtype)


def judge(cfg: dict, kind: str, reps, norms, outputs: dict, solves,
          seed: int, device, reference=None):
    """(numbers, wrong answers): each number compared, as ``{"value",
    "limit"}``, and how many solves read past their limit.  ``reference``
    is a ``(model, operator)`` pair already built from ``reps``."""
    import torch

    limits = cfg["limits"]
    facts = cfg["facts"]
    t0 = time.perf_counter()
    model, H = reference or build_reference(cfg, reps, norms, device)
    census = model.census()
    info = {"census": census, "nnz": H.nnz}
    values = {
        "basis_count": max(abs(len(reps) - census),
                           abs(census - int(facts["n_states"]))),
        "basis_bad": H.bad + H.missing,
        "nnz": abs(H.nnz - int(facts["nnz_offdiag"])),
    }
    wrong = 0
    if kind == "solve":
        e0, info["e0_iters"] = H.lowest_eigenvalue(loops.mix(seed, 4))
        info["e0"] = e0
        gaps = [abs(s["e0"] - e0) / abs(e0) for s in solves or ()]
        values["e0_gap"] = max(gaps) if gaps else float("inf")
        wrong = sum(g > limits["e0_gap"] for g in gaps)
        res = []
        for theta, vec in outputs.values():
            v = torch.as_tensor(vec, dtype=torch.float64).reshape(-1).to(
                device)
            r = H.apply(v) - theta * v
            res.append(float(torch.linalg.vector_norm(r))
                       / (abs(theta) * float(torch.linalg.vector_norm(v))))
        values["e0_residual"] = max(res) if res else float("inf")
    elif kind == "apply":
        errs = []
        for x, y in outputs.values():
            X = torch.as_tensor(x, dtype=torch.float64).to(device)
            ref = H.apply(X)
            Y = torch.as_tensor(y, dtype=torch.float64).to(device)
            errs.append(float((Y - ref).abs().max() / ref.abs().max()))
        values["apply_err"] = max(errs) if errs else float("inf")
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    info["seconds"] = time.perf_counter() - t0
    print("reference " + json.dumps(info), file=sys.stderr)
    return {k: {"value": float(v), "limit": float(limits[k])}
            for k, v in values.items()}, int(wrong)


def report(numbers: dict, out=sys.stderr) -> None:
    """Each number beside its limit, one line each."""
    for k, v in numbers.items():
        ok = "ok" if v["value"] <= v["limit"] else "FAIL"
        print(f"check {k} {v['value']!r} limit {v['limit']!r} {ok}",
              file=out)
