# Copied from distributed_matvec_tpu/models/expression.py
"""Symbolic operator expressions and their compilation to *nonbranching terms*.

The reference framework (twesterhout/distributed-matvec) receives Hamiltonians as
strings like ``"σˣ₀ σˣ₁"`` plus a list of site tuples (see e.g.
``reference data/heisenberg_chain_10.yaml``) and compiles them — inside the
opaque ``liblattice_symmetries_haskell`` component (declared at
``reference src/FFI.chpl:109-113`` as ``ls_hs_nonbranching_terms``) — into
tables of *nonbranching terms* consumed by the batched kernels
``ls_internal_operator_apply_{diag,off_diag}_x1`` (``reference src/FFI.chpl:219-225``).

We re-derive that representation from first principles.  A nonbranching term
``t`` maps one computational basis state to exactly one basis state:

    t|α⟩ = v · [α ∧ m == r] · (−1)^popcount(α ∧ s) · |α ⊕ x⟩

with
    v — complex amplitude,
    x — flip mask (bits toggled),
    s — sign mask (Pauli-z / fermionic-parity phases),
    m — filter mask, r — required bit pattern under ``m`` (projectors, σ±, fermions).

Every product of single-site spin-1/2 operators and every normal-ordered product
of fermionic creation/annihilation operators (with Jordan-Wigner strings) is a
*sum* of such terms, and the family is closed under composition — see
``NonbranchingTerm.compose``.

Bit convention: bit ``i`` of the 64-bit basis state is the spin at site ``i``;
bit value 1 ↔ spin up ↔ σᶻ eigenvalue +1.  (The golden data shipped with this
repo is generated with the same convention, so the contract is self-consistent;
Heisenberg-type Hamiltonians are invariant under flipping it.)
"""

from __future__ import annotations

import cmath
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = [
    "NonbranchingTerm",
    "SymbolicTerm",
    "SymbolicExpression",
    "parse_expression",
    "simplify_terms",
]

_ZERO_TOL = 1e-15


@dataclass(frozen=True)
class NonbranchingTerm:
    """One nonbranching term ``t|α⟩ = v·[α∧m==r]·(−1)^pc(α∧s)·|α⊕x⟩``."""

    v: complex
    x: int = 0  # flip mask
    s: int = 0  # sign mask
    m: int = 0  # filter mask
    r: int = 0  # required pattern (subset of m)

    def __post_init__(self):
        assert self.r & ~self.m == 0, "r must be a subset of m"

    @property
    def is_diagonal(self) -> bool:
        return self.x == 0

    def compose(self, other: "NonbranchingTerm") -> "NonbranchingTerm | None":
        """Operator product ``self ∘ other`` (``other`` acts first).

        Derivation: with β = α ⊕ other.x,
          [β ∧ m₁ == r₁]  ⇔  [α ∧ m₁ == r₁ ⊕ (other.x ∧ m₁)]
          (−1)^pc(β ∧ s₁) = (−1)^pc(α ∧ s₁) · (−1)^pc(other.x ∧ s₁)
        Returns ``None`` when the combined filters are contradictory (the
        product is the zero operator).
        """
        t1, t2 = self, other
        r1p = t1.r ^ (t2.x & t1.m)
        overlap = t1.m & t2.m
        if (r1p & overlap) != (t2.r & overlap):
            return None
        sign = -1.0 if _popcount(t2.x & t1.s) & 1 else 1.0
        return NonbranchingTerm(
            v=t1.v * t2.v * sign,
            x=t1.x ^ t2.x,
            s=t1.s ^ t2.s,
            m=t1.m | t2.m,
            r=r1p | t2.r,
        )

    def dagger(self) -> "NonbranchingTerm":
        """Hermitian adjoint.  t†|β⟩ picks up the filter evaluated post-flip."""
        # ⟨β|t|α⟩ = v·[α∧m==r]·(−1)^pc(α∧s)·[β==α⊕x]
        # ⟨α|t†|β⟩ = conj of that with α = β⊕x ⇒ filter [β∧m == r⊕(x∧m)],
        # sign (−1)^pc(β∧s)·(−1)^pc(x∧s).
        sign = -1.0 if _popcount(self.x & self.s) & 1 else 1.0
        return NonbranchingTerm(
            v=self.v.conjugate() * sign,
            x=self.x,
            s=self.s,
            m=self.m,
            r=self.r ^ (self.x & self.m),
        )

    def apply_int(self, alpha: int) -> Tuple[complex, int]:
        """Reference (slow, pure-python) application — used by tests only."""
        if (alpha & self.m) != self.r:
            return 0.0, alpha
        sign = -1.0 if _popcount(alpha & self.s) & 1 else 1.0
        return self.v * sign, alpha ^ self.x


def _popcount(x: int) -> int:
    return bin(x).count("1")


def simplify_terms(terms: Iterable[NonbranchingTerm]) -> List[NonbranchingTerm]:
    """Group terms with identical (x, s, m, r) masks, summing amplitudes."""
    acc: Dict[Tuple[int, int, int, int], complex] = {}
    for t in terms:
        if t is None:
            continue
        key = (t.x, t.s, t.m, t.r)
        acc[key] = acc.get(key, 0.0) + t.v
    out = [
        NonbranchingTerm(v=v, x=k[0], s=k[1], m=k[2], r=k[3])
        for k, v in acc.items()
        if abs(v) > _ZERO_TOL
    ]
    # Deterministic order: diagonal first, then by masks.
    out.sort(key=lambda t: (t.x != 0, t.x, t.s, t.m, t.r))
    return out


# ---------------------------------------------------------------------------
# Primitive single-site operators → atoms
# ---------------------------------------------------------------------------

def _spin_atoms(kind: str, site: int) -> List[NonbranchingTerm]:
    """Atoms for a single-site spin operator at ``site``.

    With bit 1 ↔ up ↔ σᶻ = +1 and basis ordering (↑, ↓):
      σˣ: flips the bit, amplitude 1 both ways.
      σʸ: |↓⟩→−i·... : amplitude for 0→1 is −i, for 1→0 is +i  ⇒ v=−i with a
          sign mask on the pre-flip bit.
      σᶻ: diag(+1 on bit 1, −1 on bit 0) ⇒ v=−1, sign mask.
      σ⁺=|↑⟩⟨↓|: requires bit 0, flips.   σ⁻: requires bit 1, flips.
    """
    b = 1 << site
    if kind == "x":
        return [NonbranchingTerm(1.0, x=b)]
    if kind == "y":
        return [NonbranchingTerm(-1j, x=b, s=b)]
    if kind == "z":
        return [NonbranchingTerm(-1.0, s=b)]
    if kind == "+":
        return [NonbranchingTerm(1.0, x=b, m=b, r=0)]
    if kind == "-":
        return [NonbranchingTerm(1.0, x=b, m=b, r=b)]
    if kind == "n":  # number operator (1+σᶻ)/2 = |↑⟩⟨↑|
        return [NonbranchingTerm(1.0, m=b, r=b)]
    if kind == "I":
        return [NonbranchingTerm(1.0)]
    raise ValueError(f"unknown spin operator kind: {kind!r}")


def _fermion_atoms(kind: str, site: int) -> List[NonbranchingTerm]:
    """Fermionic c†/c/n with Jordan-Wigner string over bits below ``site``."""
    b = 1 << site
    below = b - 1
    if kind == "c+":  # creation: requires empty, sets bit, JW parity sign
        return [NonbranchingTerm(1.0, x=b, m=b, r=0, s=below)]
    if kind == "c":  # annihilation
        return [NonbranchingTerm(1.0, x=b, m=b, r=b, s=below)]
    if kind == "n":
        return [NonbranchingTerm(1.0, m=b, r=b)]
    raise ValueError(f"unknown fermion operator kind: {kind!r}")


# ---------------------------------------------------------------------------
# Symbolic expressions (site placeholders, instantiated later over site tuples)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SymbolicTerm:
    """``coeff · Π factors``; each factor is (family, kind, site_placeholder).

    family ∈ {"spin", "fermion"}; kind as accepted by the atom constructors.
    Factors are kept in left-to-right operator order (rightmost acts first).
    """

    coeff: complex
    factors: Tuple[Tuple[str, str, int], ...]


@dataclass(frozen=True)
class SymbolicExpression:
    terms: Tuple[SymbolicTerm, ...]

    def max_placeholder(self) -> int:
        mx = -1
        for t in self.terms:
            for _, _, p in t.factors:
                mx = max(mx, p)
        return mx

    def instantiate(self, sites: Sequence[int]) -> List[NonbranchingTerm]:
        """Replace placeholder ``k`` by ``sites[k]`` and expand to terms."""
        out: List[NonbranchingTerm] = []
        for term in self.terms:
            # Start from the scalar and compose factor atoms left→right.
            acc = [NonbranchingTerm(term.coeff)]
            for family, kind, placeholder in term.factors:
                site = sites[placeholder]
                if site < 0:
                    raise ValueError(f"negative site index {site}")
                atoms = (
                    _spin_atoms(kind, site)
                    if family == "spin"
                    else _fermion_atoms(kind, site)
                )
                nxt: List[NonbranchingTerm] = []
                for a in acc:
                    for b in atoms:
                        c = a.compose(b)
                        if c is not None:
                            nxt.append(c)
                acc = nxt
            out.extend(acc)
        return simplify_terms(out)


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_SUPERSCRIPTS = {"ˣ": "x", "ʸ": "y", "ᶻ": "z", "⁺": "+", "⁻": "-", "ᵈᵃᵍ": "c+"}
_SUBSCRIPT_DIGITS = {c: str(i) for i, c in enumerate("₀₁₂₃₄₅₆₇₈₉")}


class _Tokenizer:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def peek(self) -> str:
        while self.pos < len(self.text) and self.text[self.pos].isspace():
            self.pos += 1
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def error(self, msg: str):
        raise ValueError(f"parse error at {self.pos} in {self.text!r}: {msg}")


def _read_subscript_int(tz: _Tokenizer) -> int:
    digits = ""
    while tz.pos < len(tz.text):
        c = tz.text[tz.pos]
        if c in _SUBSCRIPT_DIGITS:
            digits += _SUBSCRIPT_DIGITS[c]
            tz.pos += 1
        elif c.isdigit():
            digits += c
            tz.pos += 1
        else:
            break
    if not digits:
        tz.error("expected a (subscript) site index")
    return int(digits)


def _read_number(tz: _Tokenizer) -> complex:
    start = tz.pos
    t = tz.text
    n = len(t)
    while tz.pos < n and (t[tz.pos].isdigit() or t[tz.pos] == "."):
        tz.pos += 1
    if tz.pos < n and t[tz.pos] in "eE":
        save = tz.pos
        tz.pos += 1
        if tz.pos < n and t[tz.pos] in "+-":
            tz.pos += 1
        if tz.pos < n and t[tz.pos].isdigit():
            while tz.pos < n and t[tz.pos].isdigit():
                tz.pos += 1
        else:
            tz.pos = save
    value = float(t[start : tz.pos])
    # optional imaginary suffix: 2im / 2j / 2ⅈ
    if tz.pos < n and t[tz.pos] in "jⅈ":
        tz.pos += 1
        return value * 1j
    if t.startswith("im", tz.pos):
        tz.pos += 2
        return value * 1j
    return value


def _read_primitive(tz: _Tokenizer) -> Tuple[str, str, int, complex]:
    """Returns (family, kind, placeholder, extra_scalar)."""
    c = tz.peek()
    t = tz.text
    if c in ("σ", "s") or c == "S" or t.startswith("\\sigma", tz.pos):
        scale = 1.0
        if t.startswith("\\sigma", tz.pos):
            tz.pos += len("\\sigma")
        else:
            if c == "S":
                scale = 0.5  # S = σ/2
            tz.pos += 1
        # superscript or ^x
        kind = None
        if tz.pos < len(t):
            ch = t[tz.pos]
            if ch in _SUPERSCRIPTS:
                kind = _SUPERSCRIPTS[ch]
                tz.pos += 1
            elif ch == "^":
                tz.pos += 1
                kind = t[tz.pos]
                tz.pos += 1
            elif ch in "xyz+-":
                kind = ch
                tz.pos += 1
        if kind not in ("x", "y", "z", "+", "-"):
            tz.error(f"bad Pauli superscript {kind!r}")
        if tz.pos < len(t) and t[tz.pos] == "_":
            tz.pos += 1
        site = _read_subscript_int(tz)
        return ("spin", kind, site, scale)
    if c == "n":
        tz.pos += 1
        if tz.pos < len(t) and t[tz.pos] == "_":
            tz.pos += 1
        site = _read_subscript_int(tz)
        return ("spin", "n", site, 1.0)
    if c == "c":
        tz.pos += 1
        kind = "c"
        if tz.pos < len(t) and t[tz.pos] in ("†", "+"):
            kind = "c+"
            tz.pos += 1
        elif t.startswith("^\\dagger", tz.pos):
            kind = "c+"
            tz.pos += len("^\\dagger")
        if tz.pos < len(t) and t[tz.pos] == "_":
            tz.pos += 1
        site = _read_subscript_int(tz)
        return ("fermion", kind, site, 1.0)
    if c == "I":
        tz.pos += 1
        return ("spin", "I", 0, 1.0)
    tz.error(f"unexpected character {c!r}")


def parse_expression(text: str) -> SymbolicExpression:
    """Parse an expression like ``"0.8 × σˣ₀ σˣ₁"`` or ``"σ⁺₀ σ⁻₁ + σ⁻₀ σ⁺₁"``.

    Grammar:  sum := product (('+'|'-') product)* ;
              product := signed (('×'|'*')? signed)* ;
              signed := '-' signed | number | primitive | '(' sum ')'.

    Returns a :class:`SymbolicExpression` with site *placeholders* — instantiate
    against each row of the YAML ``sites`` list (reference format:
    ``data/heisenberg_chain_10.yaml``; the subscript indexes into each row).
    """
    tz = _Tokenizer(text)
    terms = _parse_sum(tz)
    if tz.peek():
        tz.error("trailing input")
    return SymbolicExpression(tuple(terms))


def _parse_sum(tz: _Tokenizer) -> List[SymbolicTerm]:
    terms = _parse_product(tz)
    while True:
        c = tz.peek()
        if c == "+":
            tz.pos += 1
            terms += _parse_product(tz)
        elif c in ("-", "−"):
            tz.pos += 1
            terms += [
                SymbolicTerm(-t.coeff, t.factors) for t in _parse_product(tz)
            ]
        else:
            return terms


def _parse_product(tz: _Tokenizer) -> List[SymbolicTerm]:
    # One product, distributed left-to-right so operator order is preserved
    # even through parenthesised sub-sums: Π is kept as a running sum-of-terms.
    acc: List[SymbolicTerm] = [SymbolicTerm(1.0 + 0.0j, ())]

    def mul_scalar(v: complex):
        nonlocal acc
        acc = [SymbolicTerm(t.coeff * v, t.factors) for t in acc]

    def mul_terms(sub: List[SymbolicTerm]):
        nonlocal acc
        acc = [
            SymbolicTerm(a.coeff * s.coeff, a.factors + s.factors)
            for a in acc
            for s in sub
        ]

    first = True
    while True:
        c = tz.peek()
        if c in ("×", "*"):
            tz.pos += 1
            c = tz.peek()
        elif not first and (c == "" or c in "+-−)"):
            break
        if c == "(":
            tz.pos += 1
            inner = _parse_sum(tz)
            if tz.peek() != ")":
                tz.error("expected ')'")
            tz.pos += 1
            mul_terms(inner)
        elif c and (c.isdigit() or c == "."):
            mul_scalar(_read_number(tz))
        elif c in ("i", "ⅈ", "j"):
            # bare imaginary unit: ⅈ, j, i, im
            tz.pos += 2 if tz.text.startswith("im", tz.pos) else 1
            mul_scalar(1j)
        elif c in ("-", "−") and first:
            tz.pos += 1
            mul_scalar(-1.0)
            continue
        else:
            fam, kind, site, scale = _read_primitive(tz)
            mul_scalar(scale)
            if kind != "I":
                mul_terms([SymbolicTerm(1.0 + 0.0j, ((fam, kind, site),))])
        first = False
    return acc
