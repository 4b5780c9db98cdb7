# Copied from distributed_matvec_tpu/models/basis.py
"""Basis objects: spin-1/2 (and fermionic) Hilbert-space sectors.

Re-design of the reference's ``Basis`` record
(``reference src/ForeignTypes.chpl:8-152``), which wraps an opaque
``ls_hs_basis`` pointer.  Here the basis is a plain Python object holding the
sector definition plus, after :meth:`SpinBasis.build`, the sorted
representative array, per-representative norms, and the hash-shard assignment
(``localeIdxOf`` analog) used to lay data out over the engine's shards.

Cross-process/cross-host copies travel as JSON — same role as the reference's
JSON re-serialization on cross-locale copies (ForeignTypes.chpl:35-53).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..enumeration import enumerate_representatives as _enumerate
from ..enumeration import host as _enum
from .symmetry import SymmetryGroup

__all__ = ["SpinBasis", "SpinlessFermionBasis", "SpinfulFermionBasis"]


class SpinBasis:
    """A (possibly symmetry-projected) sector of an N-spin Hilbert space.

    Parameters mirror the YAML schema (``data/*.yaml``):
      number_spins, hamming_weight (None = unconstrained), spin_inversion
      (None/±1), symmetries = [(permutation, sector), ...].
    """

    particle_type = "spin"

    def __init__(
        self,
        number_spins: int,
        hamming_weight: Optional[int] = None,
        spin_inversion: Optional[int] = None,
        symmetries: Sequence[Tuple[Sequence[int], int]] = (),
    ):
        if not (1 <= number_spins <= 64):
            raise ValueError("number_spins must be in [1, 64]")
        if spin_inversion in (0,):
            spin_inversion = None
        if spin_inversion is not None and spin_inversion not in (1, -1):
            raise ValueError("spin_inversion must be ±1")
        if (
            spin_inversion is not None
            and hamming_weight is not None
            and 2 * hamming_weight != number_spins
        ):
            raise ValueError(
                "spin_inversion requires hamming_weight == number_spins/2"
            )
        self.number_spins = int(number_spins)
        self.hamming_weight = None if hamming_weight is None else int(hamming_weight)
        self.spin_inversion = spin_inversion
        self.symmetries = [(tuple(int(x) for x in p), int(s)) for p, s in symmetries]
        self.group = SymmetryGroup.build(
            number_spins, self.symmetries, spin_inversion
        )
        # Filled by build():
        self._representatives: Optional[np.ndarray] = None
        self._norms: Optional[np.ndarray] = None

    # -- predicates (reference API parity, ForeignTypes.chpl:79-109) --------

    @property
    def number_sites(self) -> int:
        return self.number_spins

    @property
    def number_bits(self) -> int:
        return self.number_spins

    @property
    def number_words(self) -> int:
        return 1  # ≤64 sites; the reference halts on >1 word too (BatchedOperator.chpl:224)

    @property
    def is_hamming_weight_fixed(self) -> bool:
        return self.hamming_weight is not None

    @property
    def has_spin_inversion_symmetry(self) -> bool:
        return self.spin_inversion is not None

    @property
    def has_permutation_symmetries(self) -> bool:
        return any(tuple(p) != tuple(range(len(p))) for p, _ in self.symmetries)

    @property
    def requires_projection(self) -> bool:
        return self.has_permutation_symmetries or self.has_spin_inversion_symmetry

    @property
    def is_state_index_identity(self) -> bool:
        return not self.requires_projection and self.hamming_weight is None

    @property
    def is_built(self) -> bool:
        return self._representatives is not None

    def min_state_estimate(self) -> int:
        """Smallest candidate state (``ls_hs_min_state_estimate``, FFI.chpl)."""
        if self.hamming_weight is None:
            return 0
        return (1 << self.hamming_weight) - 1

    def max_state_estimate(self) -> int:
        if self.hamming_weight is None:
            return (1 << self.number_spins) - 1
        k = self.hamming_weight
        return ((1 << k) - 1) << (self.number_spins - k)

    # -- build / representatives -------------------------------------------

    def build(self, force: bool = False) -> "SpinBasis":
        """Enumerate representatives (+ norms).  Reference: ``basis.build()``
        → ``ls_chpl_enumerate_representatives`` (StatesEnumeration.chpl:588-603)."""
        if self._representatives is None or force:
            states, norms = _enumerate(
                self.number_spins, self.hamming_weight, self.group
            )
            self._representatives = states
            self._norms = norms
        return self

    def unchecked_set_representatives(self, states: np.ndarray, norms=None) -> None:
        """Adopt an externally produced representative array (checkpoint
        restore path — ForeignTypes.chpl:74-77, Diagonalize.chpl:227-235)."""
        self._representatives = np.asarray(states, dtype=np.uint64)
        if norms is not None:
            self._norms = np.asarray(norms, dtype=np.float64)
        elif self.requires_projection:
            _, _, self._norms = self.group.state_info(self._representatives)
        else:
            self._norms = np.ones(self._representatives.size)

    @property
    def representatives(self) -> np.ndarray:
        if self._representatives is None:
            raise RuntimeError("basis is not built")  # ForeignTypes.chpl:113-114
        return self._representatives

    @property
    def norms(self) -> np.ndarray:
        if self._norms is None:
            raise RuntimeError("basis is not built")
        return self._norms

    @property
    def number_states(self) -> int:
        return int(self.representatives.size)

    # -- lookups ------------------------------------------------------------

    def state_index(self, states: np.ndarray) -> np.ndarray:
        """Index of each state in the sorted representative list; −1 when
        absent (host analog of ``ls_hs_state_index``, FFI.chpl:173-175)."""
        reps = self.representatives
        states = np.asarray(states, dtype=np.uint64)
        idx = np.searchsorted(reps, states)
        idx = np.clip(idx, 0, reps.size - 1)
        ok = reps[idx] == states
        return np.where(ok, idx, -1).astype(np.int64)

    def state_info(self, states: np.ndarray):
        return self.group.state_info(states)

    def shard_index(self, states: np.ndarray, n_shards: int) -> np.ndarray:
        return _enum.shard_index(states, n_shards)

    # -- serialization (cross-host copy semantics) --------------------------

    def to_json(self) -> str:
        return json.dumps(self._json_dict())

    def _json_dict(self) -> dict:
        return {
            "particle": self.particle_type,
            "number_spins": self.number_spins,
            "hamming_weight": self.hamming_weight,
            "spin_inversion": self.spin_inversion,
            "symmetries": [
                {"permutation": list(p), "sector": s} for p, s in self.symmetries
            ],
        }

    @staticmethod
    def from_json(text: str) -> "SpinBasis":
        """Reconstruct the exact basis (incl. fermionic subclasses) — the
        cross-locale copy contract of ForeignTypes.chpl:35-53."""
        d = json.loads(text)
        particle = d.get("particle", "spin")
        if particle == "spinless_fermion":
            return SpinlessFermionBasis(d["number_spins"], d.get("hamming_weight"))
        if particle == "spinful_fermion":
            return SpinfulFermionBasis(
                d["number_spins"] // 2, d.get("number_up"), d.get("number_down")
            )
        return SpinBasis(
            d["number_spins"],
            d.get("hamming_weight"),
            d.get("spin_inversion"),
            [(s["permutation"], s["sector"]) for s in d.get("symmetries", [])],
        )

    def __repr__(self) -> str:
        built = f", states={self.number_states}" if self.is_built else ""
        return (
            f"SpinBasis(n={self.number_spins}, hw={self.hamming_weight}, "
            f"inv={self.spin_inversion}, |G|={len(self.group)}{built})"
        )


class SpinlessFermionBasis(SpinBasis):
    """Spinless fermions on N sites; bit i = occupation of site i.

    Fermionic statistics enter through Jordan-Wigner sign masks in the term
    compiler (see ``expression._fermion_atoms``); the basis-state machinery
    (enumeration, hashing, sharding) is identical to the spin case — as in the
    reference, where particle type only changes kernel dispatch
    (FFI.chpl:85-88, StatesEnumeration.chpl:225-255).
    """

    particle_type = "spinless_fermion"

    def __init__(self, number_sites: int, number_particles: Optional[int] = None):
        super().__init__(number_sites, hamming_weight=number_particles)
        self.number_particles = number_particles


class SpinfulFermionBasis(SpinBasis):
    """Spinful fermions: 2N bits, low N = spin-↓? No — low N bits hold the ↑
    sector, high N bits the ↓ sector, matching the reference's product
    enumeration (StatesEnumeration.chpl:225-255)."""

    particle_type = "spinful_fermion"

    def __init__(
        self,
        number_sites: int,
        number_up: Optional[int] = None,
        number_down: Optional[int] = None,
    ):
        super().__init__(2 * number_sites)
        self.physical_sites = number_sites
        self.number_up = number_up
        self.number_down = number_down

    def _json_dict(self) -> dict:
        d = super()._json_dict()
        d["number_up"] = self.number_up
        d["number_down"] = self.number_down
        return d

    def build(self, force: bool = False) -> "SpinfulFermionBasis":
        if self._representatives is None or force:
            n = self.physical_sites
            up = (
                _enum.all_states(n, self.number_up)
                if self.number_up is not None
                else _enum.all_states(n, None)
            )
            down = (
                _enum.all_states(n, self.number_down)
                if self.number_down is not None
                else _enum.all_states(n, None)
            )
            # cartesian product, ascending: state = (down << n) | up
            states = (down[:, None] << np.uint64(n)) | up[None, :]
            self._representatives = states.reshape(-1)
            self._norms = np.ones(self._representatives.size)
        return self
