# Copied from distributed_matvec_tpu/models/lattices.py
"""Model-family constructors: the lattice geometries shipped with the reference.

The reference's ``data/*.yaml`` covers Heisenberg chains (4–40 sites, with and
without translation/parity/inversion sectors), square lattices 4x4–6x6, kagome
12/16/36, and pyrochlore.  These constructors generate the same edge lists (and the
symmetric sectors used by the ``*_symm`` configs) programmatically.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .basis import SpinBasis
from .operator import Operator

__all__ = [
    "heisenberg_from_edges",
    "chain_edges",
    "square_edges",
    "square_diagonal_edges",
    "kagome_12_edges",
    "kagome_16_edges",
    "kagome_torus_edges",
    "kagome_36_edges",
    "pyrochlore_edges",
    "heisenberg_pyrochlore",
    "heisenberg_chain",
    "heisenberg_square",
    "heisenberg_kagome",
    "xxz_chain",
    "transverse_field_ising_chain",
    "j1j2_square",
]


def heisenberg_from_edges(
    basis: SpinBasis,
    edges: Sequence[Tuple[int, int]],
    coupling: float = 1.0,
    extra: Sequence[Tuple[float, Sequence[Tuple[int, int]]]] = (),
    spin_half_ops: bool = False,
) -> Operator:
    """Σ_⟨ij⟩ J (σˣᵢσˣⱼ + σʸᵢσʸⱼ + σᶻᵢσᶻⱼ) — the Hamiltonian of every reference
    config.  ``spin_half_ops`` switches to S = σ/2 operators as used by the
    kagome configs (data/heisenberg_kagome_16.yaml)."""
    sym = "S" if spin_half_ops else "σ"
    sites = [list(e) for e in edges]
    # float(...)!r: numpy scalars repr as 'np.float64(x)' under numpy>=2,
    # which the expression parser rejects
    prefix = "" if coupling == 1.0 else f"{float(coupling)!r} × "
    exprs = [
        (f"{prefix}{sym}ˣ₀ {sym}ˣ₁", sites),
        (f"{prefix}{sym}ʸ₀ {sym}ʸ₁", sites),
        (f"{prefix}{sym}ᶻ₀ {sym}ᶻ₁", sites),
    ]
    for j, es in extra:
        s = [list(e) for e in es]
        jr = f"{float(j)!r}"
        exprs += [
            (f"{jr} × {sym}ˣ₀ {sym}ˣ₁", s),
            (f"{jr} × {sym}ʸ₀ {sym}ʸ₁", s),
            (f"{jr} × {sym}ᶻ₀ {sym}ᶻ₁", s),
        ]
    return Operator.from_expressions(basis, exprs, name="Heisenberg Hamiltonian")


def chain_edges(n: int, periodic: bool = True) -> List[Tuple[int, int]]:
    edges = [(i, i + 1) for i in range(n - 1)]
    if periodic:
        edges.append((n - 1, 0))
    return edges


def square_edges(nx: int, ny: int, periodic: bool = True) -> List[Tuple[int, int]]:
    def idx(x, y):
        return (y % ny) * nx + (x % nx)

    edges = []
    for y in range(ny):
        for x in range(nx):
            if periodic or x + 1 < nx:
                edges.append((idx(x, y), idx(x + 1, y)))
            if periodic or y + 1 < ny:
                edges.append((idx(x, y), idx(x, y + 1)))
    # Keep multiplicity: on a periodic torus with nx==2 or ny==2 the wrap bond
    # doubles a nearest-neighbour bond, and both couplings are physical
    # (chain_edges(2) likewise keeps [(0,1),(1,0)]).
    return sorted(tuple(sorted(e)) for e in edges)


# Kagome clusters — edge lists transcribed from data/heisenberg_kagome_{12,16}.yaml
# (open boundary conditions; note those configs use S = σ/2 operators).
def kagome_12_edges() -> List[Tuple[int, int]]:
    return [
        (0, 1), (0, 4), (1, 2), (1, 4), (2, 3), (2, 5), (3, 5),
        (4, 6), (5, 7), (5, 8),
        (6, 7), (6, 10), (7, 8), (7, 10), (8, 9), (8, 11), (9, 11),
    ]


def kagome_16_edges() -> List[Tuple[int, int]]:
    return [
        (0, 1), (0, 4), (1, 2), (1, 4), (2, 3), (2, 5), (3, 5), (4, 6),
        (5, 7), (5, 8), (6, 7), (6, 10), (7, 8), (7, 10), (8, 9), (8, 11),
        (9, 11), (10, 12), (11, 13), (11, 14), (12, 13), (13, 14), (14, 15),
    ]


def kagome_torus_edges(lx: int, ly: int) -> List[Tuple[int, int]]:
    """Periodic kagome lattice of ``lx × ly`` three-site unit cells (the
    geometry behind the reference's commented ``benchmark-kagome-36``
    workload, Makefile:85,108 — 36 sites at lx=4, ly=3).

    Cell (x, y) carries sublattice sites a/b/c; nearest-neighbour bonds are
    the up-triangle (a-b, a-c, b-c) plus the down-triangle closures
    b(x,y)-a(x+1,y), c(x,y)-a(x,y+1), b(x,y)-c(x+1,y-1) — giving every
    site coordination 4.  Wrap-doubled bonds on width-≤2 tori keep their
    multiplicity (both couplings are physical, as in :func:`square_edges`).
    """
    def site(x, y, s):
        return 3 * ((y % ly) * lx + (x % lx)) + s

    edges: List[Tuple[int, int]] = []
    for y in range(ly):
        for x in range(lx):
            a, b, c = site(x, y, 0), site(x, y, 1), site(x, y, 2)
            edges += [(a, b), (a, c), (b, c)]
            edges += [(b, site(x + 1, y, 0)),
                      (c, site(x, y + 1, 0)),
                      (b, site(x + 1, y - 1, 2))]
    return edges


def kagome_36_edges() -> List[Tuple[int, int]]:
    """36-site periodic kagome cluster (4×3 unit cells)."""
    return kagome_torus_edges(4, 3)


def pyrochlore_edges(lx: int, ly: int, lz: int) -> List[Tuple[int, int]]:
    """Periodic pyrochlore lattice of ``lx × ly × lz`` four-site cells (the
    reference's commented ``benchmark-pyrochlore-2x2x2`` workload,
    Makefile:84,107 — 32 sites at 2×2×2).

    Corner-sharing tetrahedra on an FCC cell grid: the UP tetrahedron of
    cell r is its four sublattice sites (6 bonds); the DOWN tetrahedron's
    corners are site s of cell r + a_s (a_0 = 0, a_1/2/3 = the three cell
    steps), giving 6 more — coordination 6 everywhere.
    """
    def site(x, y, z, s):
        return 4 * (((z % lz) * ly + (y % ly)) * lx + (x % lx)) + s

    a = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1))
    edges: List[Tuple[int, int]] = []
    for z in range(lz):
        for y in range(ly):
            for x in range(lx):
                for i in range(4):
                    for j in range(i + 1, 4):
                        edges.append((site(x, y, z, i), site(x, y, z, j)))
                        edges.append((
                            site(x + a[i][0], y + a[i][1], z + a[i][2], i),
                            site(x + a[j][0], y + a[j][1], z + a[j][2], j)))
    return edges


def heisenberg_pyrochlore(lx: int = 2, ly: int = 2, lz: int = 2) -> Operator:
    """Heisenberg model on the periodic pyrochlore lattice (32 sites at the
    reference's 2×2×2 benchmark size)."""
    n = 4 * lx * ly * lz
    basis = SpinBasis(n, n // 2)
    return heisenberg_from_edges(basis, pyrochlore_edges(lx, ly, lz),
                                 spin_half_ops=True)


def _translation(n: int) -> List[int]:
    return [(i + 1) % n for i in range(n)]


def _reflection(n: int) -> List[int]:
    return [(n - 1) - i for i in range(n)]


def heisenberg_chain(
    n: int,
    hamming_weight: Optional[int] = None,
    symmetric: bool = False,
    spin_inversion: Optional[int] = None,
) -> Operator:
    """Heisenberg ring; ``symmetric=True`` adds the translation+reflection
    sector-0 generators of the ``*_symm`` configs (data/heisenberg_chain_24_symm.yaml)."""
    if hamming_weight is None:
        hamming_weight = n // 2
    syms = []
    if symmetric:
        syms = [(_translation(n), 0), (_reflection(n), 0)]
        if spin_inversion is None and 2 * hamming_weight == n:
            spin_inversion = 1
    basis = SpinBasis(n, hamming_weight, spin_inversion, syms)
    return heisenberg_from_edges(basis, chain_edges(n))


def heisenberg_square(nx: int, ny: int) -> Operator:
    n = nx * ny
    basis = SpinBasis(n, n // 2)
    return heisenberg_from_edges(basis, square_edges(nx, ny))


def kagome_torus_translations(lx: int, ly: int,
                              sector_x: int = 0, sector_y: int = 0
                              ) -> List[Tuple[List[int], int]]:
    """The two unit-cell translation generators of the ``lx × ly`` kagome
    torus as (permutation, sector) pairs — the symmetry-adapted form of the
    reference's commented kagome_36 workload (Makefile:85,108) at a basis
    size this host can enumerate (|G| = lx·ly reduces the 4×3 torus's
    C(36,18) ≈ 9.1·10⁹ hamming states to ≈ 7.6·10⁸ representatives).

    Site labeling matches :func:`kagome_torus_edges`; the edge set is
    manifestly invariant under both generators (cells translate, sublattice
    index fixed), so any (sector_x, sector_y) momentum pair is a valid
    symmetry sector of the Heisenberg model on this torus.
    """
    def site(x, y, s):
        return 3 * ((y % ly) * lx + (x % lx)) + s

    tx = [0] * (3 * lx * ly)
    ty = [0] * (3 * lx * ly)
    for y in range(ly):
        for x in range(lx):
            for s in range(3):
                tx[site(x, y, s)] = site(x + 1, y, s)
                ty[site(x, y, s)] = site(x, y + 1, s)
    return [(tx, sector_x), (ty, sector_y)]


def heisenberg_kagome(n: int) -> Operator:
    if n == 12:
        edges = kagome_12_edges()
    elif n == 16:
        edges = kagome_16_edges()
    elif n == 36:
        edges = kagome_36_edges()
    else:
        raise ValueError(f"no kagome cluster with {n} sites")
    basis = SpinBasis(n, n // 2)
    return heisenberg_from_edges(basis, edges, spin_half_ops=True)


# ---------------------------------------------------------------------------
# Beyond the reference's shipped configs: the same expression compiler covers
# any σ-product Hamiltonian; these are standard families users expect.
# ---------------------------------------------------------------------------


def xxz_chain(
    n: int,
    delta: float = 1.0,
    hamming_weight: Optional[int] = None,
    symmetric: bool = False,
) -> Operator:
    """XXZ ring: Σ σˣσˣ + σʸσʸ + Δ·σᶻσᶻ (Δ=1 is the Heisenberg point)."""
    if hamming_weight is None:
        hamming_weight = n // 2
    syms = [(_translation(n), 0), (_reflection(n), 0)] if symmetric else []
    basis = SpinBasis(n, hamming_weight, None, syms)
    sites = [list(e) for e in chain_edges(n)]
    return Operator.from_expressions(
        basis,
        [("σˣ₀ σˣ₁", sites), ("σʸ₀ σʸ₁", sites),
         (f"{float(delta)!r} × σᶻ₀ σᶻ₁", sites)],
        name=f"XXZ(Δ={delta}) chain",
    )


def transverse_field_ising_chain(n: int, h: float = 1.0) -> Operator:
    """TFIM ring: −Σ σᶻσᶻ − h·Σ σˣ (no hamming sector — σˣ flips spins)."""
    sites = [list(e) for e in chain_edges(n)]
    fields = [[i] for i in range(n)]
    basis = SpinBasis(n)          # full 2^n space
    return Operator.from_expressions(
        basis,
        [("-1.0 × σᶻ₀ σᶻ₁", sites), (f"{-float(h)!r} × σˣ₀", fields)],
        name=f"TFIM(h={h}) chain",
    )


def square_diagonal_edges(nx: int, ny: int) -> List[Tuple[int, int]]:
    """Next-nearest-neighbour (diagonal) bonds of the periodic square lattice."""
    def idx(x, y):
        return (y % ny) * nx + (x % nx)

    edges = []
    for y in range(ny):
        for x in range(nx):
            edges.append((idx(x, y), idx(x + 1, y + 1)))
            edges.append((idx(x + 1, y), idx(x, y + 1)))
    return sorted(tuple(sorted(e)) for e in edges)


def j1j2_square(nx: int, ny: int, j2: float = 0.5) -> Operator:
    """Frustrated J1–J2 Heisenberg on the periodic square lattice."""
    n = nx * ny
    basis = SpinBasis(n, n // 2)
    return heisenberg_from_edges(
        basis, square_edges(nx, ny),
        extra=[(j2, square_diagonal_edges(nx, ny))])
