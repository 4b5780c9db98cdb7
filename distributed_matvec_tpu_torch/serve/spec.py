# Ported from distributed_matvec_tpu/serve/spec.py.
"""Job specs — the unit of work the solve service schedules.

A :class:`JobSpec` is a config-like description of ONE diagonalize
request: the model (either an inline ``basis`` + ``edges`` pair for the
Heisenberg family, or a ``yaml`` config path for anything
``load_config_from_yaml`` handles), the solver targets (``k``, ``tol``,
``max_iters``), and the engine shape (``mode``, ``n_devices``).  Specs
are plain JSON (the spool-file format ``apps/diagonalize.py --submit``
writes and the service reads), and every spec carries a ``job_id`` — the
namespacing key all of its telemetry is stamped with.

The spec is the JAX package's, field for field: a spool written by either
package is read by the other, and :meth:`JobSpec.engine_key`,
:meth:`JobSpec.column_seed`, :meth:`JobSpec.pricing`, the JSON and
:func:`estimate_dimension` give the same values in both.  A ``yaml`` spec's
engine is built from the file through the port's YAML loader
(``serve/pool.build_operator``).

The scheduling key is :meth:`JobSpec.engine_key`: a content hash of
every field that determines the ENGINE a job needs (model + mode +
device count — not the solver targets).  Two specs with equal keys can
share one warm engine from the pool and batch through
``lanczos_block``'s multi-RHS path; the key is a pure function of the
spec, so grouping never has to build a basis first.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from dataclasses import dataclass
from typing import Optional

__all__ = ["JobSpec", "estimate_dimension"]


@dataclass
class JobSpec:
    """One diagonalize request.  ``basis``/``edges`` describe an inline
    Heisenberg model (``edges=None`` = periodic chain over
    ``number_spins`` sites); ``yaml`` points at a config file instead.
    Exactly one of the two model sources must be present."""

    job_id: str
    # -- model (one of) ----------------------------------------------------
    basis: Optional[dict] = None       # SpinBasis kwargs
    edges: Optional[list] = None       # [[i, j], ...]; None = chain
    yaml: Optional[str] = None         # config path (diagonalize --submit)
    # -- solver targets ----------------------------------------------------
    #: solver kind: ``eigs`` (lowest-k eigenpairs, the batched
    #: lanczos_block path), ``kpm`` (Chebyshev/KPM spectral density) or
    #: ``evolve`` (Krylov exp(-iHt) time evolution).
    #: Dynamics jobs share the SAME warm engines (grouped by engine_key
    #: like everything else) but run one job per batch: their state is a
    #: trajectory, not a column of a shared block.
    solver: str = "eigs"
    k: int = 1
    tol: float = 1e-10
    max_iters: int = 400
    seed: Optional[int] = None         # start-column seed; None = from job_id
    # -- dynamics targets (solver="kpm" / "evolve") ------------------------
    n_moments: int = 256               # kpm: Chebyshev moment count
    n_vectors: int = 4                 # kpm: stochastic-trace columns
    t_final: float = 1.0               # evolve: trajectory length
    krylov_dim: int = 24               # evolve: per-step Krylov dimension
    # -- engine shape ------------------------------------------------------
    mode: str = "ell"
    n_devices: int = 0                 # 0/1 = LocalEngine (unless streamed)
    # -- admission hints ---------------------------------------------------
    n_states: Optional[int] = None     # exact dimension when the caller
    #   knows it; None = admission prices the un-reduced upper bound
    deadline_s: Optional[float] = None  # reject when the priced
    #   queue-wait + solve time exceeds this
    submit_ts: float = 0.0             # stamped by the queue at submission

    def __post_init__(self):
        if not self.job_id:
            raise ValueError("JobSpec needs a job_id")
        if (self.yaml is None) == (self.basis is None):
            raise ValueError(
                "JobSpec needs exactly one model source: inline "
                "basis(+edges) or a yaml config path")
        if self.solver not in ("eigs", "kpm", "evolve"):
            raise ValueError(
                f"unknown solver kind {self.solver!r} "
                "(use eigs | kpm | evolve)")
        if self.solver == "kpm":
            if int(self.n_moments) < 2:
                raise ValueError("kpm jobs need n_moments >= 2")
            if int(self.n_vectors) < 1:
                raise ValueError("kpm jobs need n_vectors >= 1")
        if self.solver == "evolve":
            if not float(self.t_final) > 0.0:
                raise ValueError("evolve jobs need t_final > 0")
            if int(self.krylov_dim) < 2:
                raise ValueError("evolve jobs need krylov_dim >= 2")

    # -- scheduling --------------------------------------------------------

    def engine_key(self) -> str:
        """Content hash of the fields that determine the ENGINE this job
        runs on (model + mode + mesh size).  Solver targets (k, tol,
        iteration budget, seed) are deliberately excluded: jobs that
        differ only there still share one warm engine and batch.

        A yaml model is keyed by the FILE'S CONTENT, not its path — an
        edited model must never hit the pool's warm engine for the old
        Hamiltonian.  The content is hashed once per spec instance (cached),
        so one spec's grouping decisions stay consistent even if the
        file changes while the job is queued."""
        cached = self.__dict__.get("_engine_key")
        if cached is not None:
            return cached
        if self.yaml is not None:
            try:
                with open(self.yaml, "rb") as f:
                    yaml_id = hashlib.sha256(f.read()).hexdigest()
            except OSError:
                # unreadable at keying time: fall back to the path (the
                # job will fail loudly at build time anyway)
                yaml_id = "path:" + os.path.abspath(self.yaml)
        else:
            yaml_id = None
        ident = {
            "basis": dict(sorted(self.basis.items())) if self.basis else None,
            "edges": sorted(map(tuple, self.edges))
            if self.edges is not None else None,
            "yaml": yaml_id,
            "mode": self.mode,
            "n_devices": int(self.n_devices),
        }
        h = hashlib.sha256(
            json.dumps(ident, sort_keys=True, default=list).encode())
        self.__dict__["_engine_key"] = h.hexdigest()[:16]
        return self.__dict__["_engine_key"]

    def column_seed(self) -> int:
        """The deterministic seed of this job's start column: explicit
        ``seed`` wins, else a stable hash of the job_id — so a job's
        column data depends only on the job itself, never on scheduler
        timing, so a rerun of the same queue solves the same columns."""
        if self.seed is not None:
            return int(self.seed)
        return int.from_bytes(
            hashlib.sha256(self.job_id.encode()).digest()[:4], "big")

    # -- admission pricing inputs -----------------------------------------

    def pricing(self) -> dict:
        """The mapping ``serve/capacity.price_job`` consumes: dimension
        (exact when carried, else the un-reduced upper bound), term
        count, mode, devices, solver budget.  Pure spec arithmetic — no
        basis build."""
        n = self.n_states
        num_terms = None
        group_order = 1
        if self.basis is not None:
            ns = int(self.basis.get("number_spins", 0))
            if n is None:
                n = estimate_dimension(self.basis)
            # Heisenberg off-diagonal terms: one σ⁺σ⁻ + σ⁻σ⁺ pair per
            # edge (the chain default has one edge per site)
            num_terms = 2 * (len(self.edges) if self.edges is not None
                             else ns)
            # |G| estimate for the hybrid recompute pricing: the
            # product of the generator orders — exact for the
            # standard chain sectors (translation · reversal ·
            # inversion), an upper bound in general, which is the
            # CONSERVATIVE direction (overpriced recompute biases the
            # split toward streaming)
            for perm, _sector in self.basis.get("symmetries") or ():
                seen, order = set(), 1
                for start in range(len(perm)):
                    if start in seen:
                        continue
                    clen, j = 0, start
                    while j not in seen:
                        seen.add(j)
                        j = perm[j]
                        clen += 1
                    order = order * clen // math.gcd(order, clen)
                group_order *= max(order, 1)
            if self.basis.get("spin_inversion"):
                group_order *= 2
        return {"n_states": n, "num_terms": num_terms,
                "mode": self.mode, "n_devices": max(int(self.n_devices), 1),
                "pair": False, "k": int(self.k),
                "max_iters": int(self.max_iters),
                "group_order": int(group_order),
                # dynamics pricing inputs (price_job converts moment /
                # trajectory budgets into matvec-column counts at the
                # same calibrated est ms/apply eigensolves price at)
                "solver": self.solver,
                "n_moments": int(self.n_moments),
                "n_vectors": int(self.n_vectors),
                "t_final": float(self.t_final),
                "krylov_dim": int(self.krylov_dim)}

    # -- JSON --------------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "JobSpec":
        data = json.loads(text)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in names})


def estimate_dimension(basis_args: dict) -> int:
    """Upper bound on a SpinBasis dimension without building it: the
    Hamming-sector binomial (or 2^n), NOT reduced by symmetries — a
    conservative admission estimate (a job admitted against the bound
    certainly fits its reduced basis; the measured calibration wins once
    an engine exists)."""
    n = int(basis_args.get("number_spins", 0))
    hw = basis_args.get("hamming_weight")
    dim = math.comb(n, int(hw)) if hw is not None else 2 ** n
    if basis_args.get("spin_inversion"):
        dim = max(dim // 2, 1)
    return int(dim)
