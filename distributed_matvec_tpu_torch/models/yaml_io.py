# Ported from distributed_matvec_tpu/models/yaml_io.py (yaml imported inside load_config_from_yaml only).
"""YAML config loading — schema-compatible with the reference's ``data/*.yaml``.

Reference behavior: ``loadConfigFromYaml(file, hamiltonian, observables)``
(``ForeignTypes.chpl:261-288``) parses a YAML file with a ``basis`` section,
a ``hamiltonian`` section (list of ``{expression, sites}`` terms), and
optional ``observables``.

``yaml`` is imported by :func:`load_config_from_yaml` alone, so the package
and the dict builders (:func:`basis_from_dict`, :func:`operator_from_dict`)
work where it is not installed; there the loader raises the
``ModuleNotFoundError`` the JAX package's import raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .basis import SpinBasis, SpinfulFermionBasis, SpinlessFermionBasis
from .operator import Operator

__all__ = ["Config", "load_config_from_yaml", "basis_from_dict",
           "operator_from_dict"]


@dataclass
class Config:
    basis: SpinBasis
    hamiltonian: Optional[Operator] = None
    observables: List[Operator] = field(default_factory=list)


def basis_from_dict(d: dict) -> SpinBasis:
    """Build a basis from a config dict; dispatches on ``particle``
    (``spin``/``spin-1/2`` default | ``spinless_fermion`` |
    ``spinful_fermion``, hyphen or underscore) like the reference's basis
    JSON (FFI.chpl:85-88; the shipped data/*.yaml write ``spin-1/2``)."""
    particle = d.get("particle", "spin").replace("-", "_")
    if particle == "spinless_fermion":
        return SpinlessFermionBasis(d["number_sites"],
                                    d.get("number_particles"))
    if particle == "spinful_fermion":
        return SpinfulFermionBasis(d["number_sites"], d.get("number_up"),
                                   d.get("number_down"))
    if particle not in ("spin", "spin_1/2"):
        raise ValueError(f"unknown particle type {particle!r}")
    return SpinBasis(
        number_spins=d["number_spins"],
        hamming_weight=d.get("hamming_weight"),
        spin_inversion=d.get("spin_inversion"),
        symmetries=[
            (s["permutation"], s.get("sector", 0))
            for s in d.get("symmetries", []) or []
        ],
    )


def operator_from_dict(d: dict, basis: SpinBasis) -> Operator:
    exprs = [(t["expression"], t["sites"]) for t in d["terms"]]
    return Operator.from_expressions(basis, exprs, name=d.get("name", ""))


def load_config_from_yaml(
    path: str, hamiltonian: bool = True, observables: bool = True
) -> Config:
    import yaml

    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    if "basis" not in raw:
        raise ValueError(f"no 'basis' section in {path!r}")  # ForeignTypes.chpl:264-265
    basis = basis_from_dict(raw["basis"])
    cfg = Config(basis=basis)
    if hamiltonian and "hamiltonian" in raw:
        cfg.hamiltonian = operator_from_dict(raw["hamiltonian"], basis)
    if observables:
        for obs in raw.get("observables", []) or []:
            cfg.observables.append(operator_from_dict(obs, basis))
    return cfg
