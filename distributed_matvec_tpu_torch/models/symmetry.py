# Copied from distributed_matvec_tpu/models/symmetry.py
"""Lattice symmetry groups: permutations, characters, orbits, norms.

The reference delegates this machinery to ``liblattice_symmetries_haskell``
(black-box contracts at ``reference src/FFI.chpl:177-184``:
``ls_hs_is_representative`` and ``ls_hs_state_info``).  We re-derive it:

A basis sector is defined by a set of generator permutations ``p`` with integer
``sector`` labels (YAML schema, e.g. ``data/heisenberg_chain_24_symm.yaml``) and
an optional global spin-inversion ``±1``.  The abelian(ish) group ``G`` is the
closure of the generators (times the Z₂ inversion), each element ``g`` carrying
a character ``χ(g) ∈ ℂ`` with ``χ(gen) = exp(−2πi·sector/period)``.

For each basis state ``α``:
  * representative  rep(α) = min over the orbit {g·α}
  * norm            n(α) = sqrt( (1/|G|) · Σ_{g: g·α=α} Re χ(g) )   (orbit-invariant)
  * character       the χ(g) of (the first) g with g·α = rep(α)

``α`` belongs to the basis iff ``rep(α) == α`` and ``n(α) > 0`` — exactly the
acceptance test in the reference's enumeration loop
(``reference src/StatesEnumeration.chpl:186-188``).

The matvec rescale ``c ← c·χ·n(β)/n(α)`` (``reference src/BatchedOperator.chpl:198-203``)
follows from ⟨rep(β)~|H|α~⟩ with |α~⟩ = P|α⟩/‖P|α⟩‖, P = (1/|G|)Σ χ*(g)·g.

Permutations are applied to 64-bit states through a *shift/mask network*: bits
are grouped by travel distance so that ``g·α = OR_d shift(α ∧ mask_d, d)`` —
two masks for a translation, O(#distinct distances) in general.  The same
tables drive the host (NumPy) and device (JAX) implementations.
"""

from __future__ import annotations

import cmath
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Permutation",
    "ShiftMaskNetwork",
    "SymmetryGroup",
    "trivial_group",
]

_CHAR_TOL = 1e-12


@dataclass(frozen=True)
class Permutation:
    """A site permutation.  Action on states: bit at site ``i`` moves to ``perm[i]``."""

    perm: Tuple[int, ...]

    def __post_init__(self):
        n = len(self.perm)
        if sorted(self.perm) != list(range(n)):
            raise ValueError(f"not a permutation: {self.perm}")

    @staticmethod
    def identity(n: int) -> "Permutation":
        return Permutation(tuple(range(n)))

    def __len__(self) -> int:
        return len(self.perm)

    def __mul__(self, other: "Permutation") -> "Permutation":
        """(self∘other): apply ``other`` first, then ``self``."""
        return Permutation(tuple(self.perm[other.perm[i]] for i in range(len(other))))

    def period(self) -> int:
        ident = Permutation.identity(len(self))
        cur, p = self, 1
        while cur != ident:
            cur = cur * self
            p += 1
            if p > 64 * len(self.perm):
                raise RuntimeError("runaway period computation")
        return p

    def apply_int(self, alpha: int) -> int:
        out = 0
        for i, pi in enumerate(self.perm):
            out |= ((alpha >> i) & 1) << pi
        return out


@dataclass(frozen=True)
class ShiftMaskNetwork:
    """Shift/mask decomposition of a bit permutation.

    ``apply(α) = OR over k of ((α ∧ masks[k]) << shifts[k])`` where negative
    shifts mean right shifts.  For a translation by t on an N-site ring this is
    exactly two (mask, shift) pairs — the rotate-left decomposition.
    """

    n_bits: int
    shifts: Tuple[int, ...]
    masks: Tuple[int, ...]

    @staticmethod
    def from_permutation(p: Permutation) -> "ShiftMaskNetwork":
        by_shift: Dict[int, int] = {}
        for i, pi in enumerate(p.perm):
            d = pi - i
            by_shift[d] = by_shift.get(d, 0) | (1 << i)
        shifts = tuple(sorted(by_shift))
        masks = tuple(by_shift[d] for d in shifts)
        return ShiftMaskNetwork(len(p), shifts, masks)

    def apply_numpy(self, states: np.ndarray) -> np.ndarray:
        """Vectorized application to an array of uint64 states."""
        out = np.zeros_like(states)
        for d, m in zip(self.shifts, self.masks):
            part = states & np.uint64(m)
            if d >= 0:
                out |= part << np.uint64(d)
            else:
                out |= part >> np.uint64(-d)
        return out


@dataclass
class SymmetryGroup:
    """Closure of permutation generators (+ optional spin inversion) with characters.

    ``perms``: [G] Permutation; ``characters``: complex [G]; ``flip``: bool [G]
    marking elements that additionally apply global spin inversion
    (``α ↦ α ⊕ ((1<<n_sites)−1)``).  Element 0 is the identity.
    """

    n_sites: int
    perms: List[Permutation]
    characters: np.ndarray  # complex128 [G]
    flip: np.ndarray  # bool [G]
    networks: List[ShiftMaskNetwork] = field(default_factory=list)

    def __post_init__(self):
        if not self.networks:
            self.networks = [ShiftMaskNetwork.from_permutation(p) for p in self.perms]

    # -- construction -------------------------------------------------------

    @staticmethod
    def build(
        n_sites: int,
        generators: Sequence[Tuple[Sequence[int], int]] = (),
        spin_inversion: Optional[int] = None,
    ) -> "SymmetryGroup":
        """Close the group generated by ``(permutation, sector)`` pairs.

        Character convention: ``χ(gen) = exp(−2πi·sector/period)``; characters
        multiply along products.  Raises if the sectors are inconsistent (the
        same group element reached with two different characters).
        """
        ident = Permutation.identity(n_sites)
        elements: Dict[Tuple[int, ...], complex] = {ident.perm: 1.0 + 0.0j}
        frontier = [ident]
        gens: List[Tuple[Permutation, complex]] = []
        for perm, sector in generators:
            p = Permutation(tuple(perm))
            if len(p) != n_sites:
                raise ValueError(
                    f"permutation length {len(p)} != number of sites {n_sites}"
                )
            w = p.period()
            chi = cmath.exp(-2j * cmath.pi * (sector % w) / w)
            gens.append((p, chi))
        while frontier:
            nxt: List[Permutation] = []
            for e in frontier:
                ce = elements[e.perm]
                for p, chi in gens:
                    q = p * e
                    cq = ce * chi
                    if q.perm in elements:
                        if abs(elements[q.perm] - cq) > 1e-9:
                            raise ValueError(
                                "inconsistent symmetry sectors: group element "
                                f"{q.perm} reached with characters "
                                f"{elements[q.perm]} and {cq}"
                            )
                    else:
                        elements[q.perm] = cq
                        nxt.append(q)
            frontier = nxt
        perms = [Permutation(k) for k in elements]
        # Deterministic order with identity first.
        perms.sort(key=lambda p: (p != ident, p.perm))
        chars = np.array([elements[p.perm] for p in perms], dtype=np.complex128)
        flip = np.zeros(len(perms), dtype=bool)
        if spin_inversion not in (None, 0):
            if spin_inversion not in (1, -1):
                raise ValueError(f"spin_inversion must be ±1, got {spin_inversion}")
            perms = perms + perms
            chars = np.concatenate([chars, chars * spin_inversion])
            flip = np.concatenate([flip, np.ones(len(flip), dtype=bool)])
        return SymmetryGroup(n_sites, perms, chars, flip)

    # -- queries ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.perms)

    @property
    def is_trivial(self) -> bool:
        return len(self.perms) == 1 and not self.flip.any()

    @property
    def has_complex_characters(self) -> bool:
        return bool(np.abs(self.characters.imag).max() > _CHAR_TOL)

    @property
    def inversion_mask(self) -> int:
        return (1 << self.n_sites) - 1

    def shift_mask_tables(self, pad_to: Optional[int] = None):
        """Dense [G, S] shift/mask tables (padded with zero masks) + flip XOR masks.

        Returns (left_shift [G,S] u64, right_shift [G,S] u64, mask [G,S] u64,
        xor_mask [G] u64) suitable for both NumPy and JAX orbit scans:
        ``g·α = (OR_k ((α & mask_k) << l_k) >> r_k) ⊕ xor``.
        """
        S = pad_to or max(len(n.shifts) for n in self.networks)
        G = len(self.perms)
        ls = np.zeros((G, S), dtype=np.uint64)
        rs = np.zeros((G, S), dtype=np.uint64)
        ms = np.zeros((G, S), dtype=np.uint64)
        for g, net in enumerate(self.networks):
            for k, (d, m) in enumerate(zip(net.shifts, net.masks)):
                ms[g, k] = m
                if d >= 0:
                    ls[g, k] = d
                else:
                    rs[g, k] = -d
        xor = np.where(self.flip, np.uint64(self.inversion_mask), np.uint64(0))
        return ls, rs, ms, xor

    def coset_walk(self):
        """Decompose the group for incremental orbit scans.

        Picks the cyclic subgroup ``H = ⟨h⟩`` whose generator ``h`` maximizes
        period/network-width (for lattice groups: the translation), writes
        ``G = ∪_j H·c_j``, and returns

            (h_net, coset_nets, elem_idx)

        where ``h_net``/``coset_nets[j]`` are ``(lshift, rshift, mask, xor)``
        exact-width tuples and ``elem_idx[j][k]`` is the canonical element
        index of ``h^k·c_j``.  An orbit scan then applies each coset rep once
        and advances with the cheap ``h`` network — O(Σ|c_j| + G·|h|) work
        instead of O(G·S_max), which is what makes ``state_info`` fast on
        device for reflection/inversion-extended translation groups.
        """
        index_of = {
            (p.perm, bool(f)): i
            for i, (p, f) in enumerate(zip(self.perms, self.flip))
        }

        def net_of(i: int, flip: bool):
            net = self.networks[i]  # cached decomposition
            ls = np.array([max(d, 0) for d in net.shifts], dtype=np.uint64)
            rs = np.array([max(-d, 0) for d in net.shifts], dtype=np.uint64)
            ms = np.array(net.masks, dtype=np.uint64)
            xor = np.uint64(self.inversion_mask if flip else 0)
            return (ls, rs, ms, xor)

        # Score candidate cyclic generators among *non-flip* elements (flip
        # composes as a pure xor and is cheaper as part of the coset reps).
        best, best_score = None, -1.0
        for i, p in enumerate(self.perms):
            if self.flip[i]:
                continue
            score = p.period() / max(len(self.networks[i].shifts), 1)
            if score > best_score:
                best, best_score = i, score
        h = self.perms[best]
        period = h.period()

        # H elements as permutation tuples (flip=False throughout H).
        h_pows = [Permutation.identity(self.n_sites)]
        for _ in range(period - 1):
            h_pows.append(h * h_pows[-1])

        seen = set()
        coset_nets, elem_idx = [], []
        for j, p in enumerate(self.perms):
            key = (p.perm, bool(self.flip[j]))
            if key in seen:
                continue
            idxs = []
            for k in range(period):
                q = h_pows[k] * p
                kk = (q.perm, bool(self.flip[j]))
                seen.add(kk)
                # spin inversion commutes with any site permutation (it xors
                # the full n-bit mask), so h^k·c_j carries c_j's flip flag
                idxs.append(index_of[kk])
            coset_nets.append(net_of(j, bool(self.flip[j])))
            elem_idx.append(np.array(idxs, dtype=np.int32))
        return net_of(best, False), coset_nets, elem_idx

    # -- orbit math (host / NumPy) ------------------------------------------

    def apply_all(self, states: np.ndarray) -> np.ndarray:
        """[G, B] array of g·α for every group element (NumPy, chunk-friendly)."""
        states = np.asarray(states, dtype=np.uint64)
        out = np.empty((len(self.perms), states.size), dtype=np.uint64)
        inv = np.uint64(self.inversion_mask)
        for g, net in enumerate(self.networks):
            t = net.apply_numpy(states)
            if self.flip[g]:
                t ^= inv
            out[g] = t
        return out

    def state_info(self, states: np.ndarray):
        """Host reference for ``ls_hs_state_info`` (reference src/FFI.chpl:181-184).

        Returns (representatives [B] u64, characters [B] c128, norms [B] f64).
        """
        states = np.asarray(states, dtype=np.uint64)
        orbit = self.apply_all(states)  # [G, B]
        reps = orbit.min(axis=0)
        # first g achieving the min (matches a deterministic device scan).
        # The returned coefficient is χ*(g): ⟨rep~|·|α⟩ picks up the conjugate
        # character, and it is consumed multiplicatively by the matvec rescale
        # (BatchedOperator.chpl:198-203) — so we return it pre-conjugated.
        first = (orbit == reps[None, :]).argmax(axis=0)
        chars = np.conj(self.characters[first])
        stab = (orbit == states[None, :])
        norms2 = (stab * self.characters[:, None].real).sum(axis=0) / len(self.perms)
        norms2 = np.where(norms2 > _CHAR_TOL, norms2, 0.0)
        return reps, chars, np.sqrt(norms2)

    def is_representative(self, states: np.ndarray):
        """Host reference for ``ls_hs_is_representative`` (FFI.chpl:177-179).

        Returns (flags [B] bool, norms [B] f64); a state is kept iff
        flag ∧ norm > 0 (StatesEnumeration.chpl:186-188).
        """
        reps, _, norms = self.state_info(states)
        return (reps == np.asarray(states, dtype=np.uint64)) & (norms > 0), norms

    def sector_dimension_census(self, hamming_weight: Optional[int]) -> int:
        """Representative count by pure combinatorics — NO enumeration.

        dim = (1/|G|) Σ_g χ*(g) · |Fix_hw(g)| (trace of the sector
        projector over the fixed-hamming space).  |Fix| of an element
        (π, flip) comes from its cycle structure: walking a cycle, the bit
        pattern is determined by the start bit and the cumulative flip;
        a cycle with odd total flip admits no fixed string, otherwise it
        contributes ``x^c + x^(L−c)`` ones (c = positions with cumulative
        flip 1), combined by a small knapsack over cycles.  This is the
        independent census the sharded enumeration is validated against —
        the fixed-hamming analog of ``determineEnumerationRanges``'s
        rank/unrank space accounting (StatesEnumeration.chpl:77-113).
        """
        n = self.n_sites
        if hamming_weight is None:
            # free space: |Fix| = 2^(#cycles with even flip) or 0
            total = 0.0 + 0.0j
            for g, p in enumerate(self.perms):
                cnt = 1
                for _, flips in _cycles_with_flip(p, bool(self.flip[g])):
                    if sum(flips) % 2:
                        cnt = 0
                        break
                    cnt *= 2
                total += np.conj(self.characters[g]) * cnt
            dim = total.real / len(self.perms)
            return int(round(dim))
        total = 0.0 + 0.0j
        for g, p in enumerate(self.perms):
            poly = np.zeros(hamming_weight + 1)
            poly[0] = 1.0
            dead = False
            for cyc, flips in _cycles_with_flip(p, bool(self.flip[g])):
                if sum(flips) % 2:
                    dead = True
                    break
                L = len(cyc)
                # ones when the start bit is 0: positions whose cumulative
                # flip (before entering the position) is 1
                c = 0
                acc = 0
                for f in flips[:-1]:
                    acc ^= f
                    c += acc
                new = np.zeros_like(poly)
                # both start bits, even when they give the same ones-count
                # (flip cycles with c = L/2 contribute 2·x^(L/2))
                for ones in (c, L - c):
                    if ones <= hamming_weight:
                        new[ones:] += poly[: poly.size - ones]
                poly = new
            if not dead:
                total += np.conj(self.characters[g]) * poly[hamming_weight]
        dim = total.real / len(self.perms)
        return int(round(dim))


def _cycles_with_flip(p: Permutation, flip: bool):
    """Cycles of ``p`` with per-step flip bits (global spin inversion flips
    at every step; plain permutations never do)."""
    n = len(p.perm)
    seen = [False] * n
    out = []
    step = 1 if flip else 0
    for i in range(n):
        if seen[i]:
            continue
        cyc = []
        j = i
        while not seen[j]:
            seen[j] = True
            cyc.append(j)
            j = p.perm[j]
        out.append((cyc, [step] * len(cyc)))
    return out


def trivial_group(n_sites: int) -> SymmetryGroup:
    return SymmetryGroup.build(n_sites)
