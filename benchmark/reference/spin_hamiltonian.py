"""Plain PyTorch reference of a symmetry-reduced spin-1/2 Hamiltonian.

It takes the model as plain data (sites, Hamming weight, spin inversion,
generator permutations with their sectors, and two-site terms on edges) and
works out again, from the representatives alone, what the program derives:

* the symmetry group, closed from its generators, with real characters;
* each state's orbit through byte lookup tables (``g·s`` is the OR of one
  table row per byte of ``s``), its representative (the orbit's least
  state), the character of the element that reaches it, and its norm
  ``n(s) = sqrt(Σ_{g·s=s} χ(g) / |G|)``;
* the sector's dimension by Burnside's count over cycle structures, with no
  enumeration;
* ``H``'s elements in the symmetric basis, ``⟨r'~|H|r~⟩ = Σ c·χ·n(r')/n(r)``
  over the flips of ``r`` that land in the orbit of ``r'``, as a diagonal and
  a CSR matrix of the distinct off-diagonal pairs;
* the lowest eigenvalue, by a plain three-term Lanczos recurrence (no
  reorthogonalization: lost orthogonality only repeats Ritz values, and the
  lowest still converges to rounding).

It runs in blocks of rows on any device and in float64 or, for the control,
float32.  It imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

#: states per orbit block: the ``[|G|, block]`` int64 images stay near
#: half a GB at |G| = 128
ORBIT_BLOCK = 1 << 19


def _period(p: Sequence[int]) -> int:
    cur, k = list(p), 1
    ident = list(range(len(p)))
    while cur != ident:
        cur = [p[i] for i in cur]
        k += 1
    return k


def _cycles(p: Sequence[int]) -> List[int]:
    seen, lengths = [False] * len(p), []
    for i in range(len(p)):
        if seen[i]:
            continue
        n, j = 0, i
        while not seen[j]:
            seen[j] = True
            j = p[j]
            n += 1
        lengths.append(n)
    return lengths


def close_group(n: int, generators: Sequence[dict], spin_inversion):
    """Every element of the group the generators span, as (permutation,
    character, flip) triples.  ``χ(gen) = exp(−2πi·sector/period)`` must be
    ±1; spin inversion doubles the group with ``χ·spin_inversion``."""
    ident = tuple(range(n))
    elems: Dict[Tuple[int, ...], float] = {ident: 1.0}
    gens = []
    for g in generators:
        p = tuple(int(i) for i in g["perm"])
        if sorted(p) != list(ident):
            raise ValueError(f"not a permutation of {n} sites: {p}")
        w = _period(p)
        s = int(g["sector"]) % w
        if (2 * s) % w:
            raise ValueError("the reference takes real characters only "
                             f"(sector {s} of period {w})")
        gens.append((p, 1.0 if s == 0 else -1.0))
    frontier = [ident]
    while frontier:
        nxt = []
        for e in frontier:
            for p, c in gens:
                q = tuple(p[i] for i in e)
                cq = elems[e] * c
                if q in elems:
                    if elems[q] != cq:
                        raise ValueError("inconsistent sectors")
                else:
                    elems[q] = cq
                    nxt.append(q)
        frontier = nxt
    out = [(p, c, False) for p, c in elems.items()]
    if spin_inversion:
        out += [(p, c * float(spin_inversion), True) for p, c, _ in out]
    return out


class SpinModel:
    """The model of one configuration, on one device."""

    def __init__(self, model: dict, device="cpu"):
        self.device = torch.device(device)
        self.n = int(model["n_sites"])
        if self.n > 62:
            raise ValueError("states are int64: at most 62 sites")
        hw = model.get("hamming_weight")
        self.hamming_weight = None if hw is None else int(hw)
        self.elements = close_group(self.n, model.get("generators", ()),
                                    model.get("spin_inversion"))
        self.G = len(self.elements)
        self.terms = list(model["terms"])
        for t in self.terms:
            if t["kind"] != "heisenberg_sigma":
                raise ValueError(f"unknown term kind {t['kind']!r}")
        nbytes = (self.n + 7) // 8
        bits = (np.arange(256)[:, None] >> np.arange(8)[None, :]) & 1
        tab = np.zeros((self.G, nbytes, 256), dtype=np.int64)
        for g, (p, _, _) in enumerate(self.elements):
            for b in range(nbytes):
                w = np.array([(1 << p[8 * b + k]) if 8 * b + k < self.n
                              else 0 for k in range(8)], dtype=np.int64)
                tab[g, b] = bits @ w
        self._tab = torch.from_numpy(tab).to(self.device)
        full = (1 << self.n) - 1
        self._flip = torch.tensor([full if f else 0 for _, _, f in
                                   self.elements], dtype=torch.int64,
                                  device=self.device)
        self._chars = torch.tensor([c for _, c, _ in self.elements],
                                   dtype=torch.float64, device=self.device)

    # -- orbits -----------------------------------------------------------

    def orbit_info(self, s: torch.Tensor):
        """(representative, character, norm²) of each int64 state in ``s``."""
        imgs = torch.zeros((self.G, s.numel()), dtype=torch.int64,
                           device=self.device)
        for b in range(self._tab.shape[1]):
            imgs |= self._tab[:, b, (s >> (8 * b)) & 255]
        imgs ^= self._flip[:, None]
        rep = imgs.min(dim=0).values
        first = (imgs == rep).to(torch.uint8).argmax(dim=0)
        stab = (imgs == s).to(torch.float64)
        norm2 = (self._chars @ stab) / self.G
        return rep, self._chars[first], norm2

    def census(self) -> int:
        """The sector's dimension, ``Σ_g χ(g)·|Fix(g)| / |G|``, from each
        element's cycles (no enumeration)."""
        n, hw = self.n, self.hamming_weight
        total = 0.0
        for p, c, flip in self.elements:
            cyc = _cycles(p)
            if flip:
                if any(L % 2 for L in cyc):
                    continue
                ok = hw is None or 2 * hw == n
                total += c * (2 ** len(cyc) if ok else 0)
                continue
            if hw is None:
                total += c * 2 ** len(cyc)
                continue
            poly = np.zeros(hw + 1)
            poly[0] = 1.0
            for L in cyc:
                new = poly.copy()
                if L <= hw:
                    new[L:] += poly[:hw + 1 - L]
                poly = new
            total += c * poly[hw]
        return int(round(total / self.G))

    # -- the operator ------------------------------------------------------

    def build(self, reps, norms=None) -> "Operator":
        """H in the basis of ``reps`` (sorted representatives, any integer
        array).  Counts what is wrong with the basis on the way: states out
        of order, states that are not their orbit's representative or have
        norm 0, norms that differ from ``norms`` (when given) by more than
        1e-12 relative, and flips whose representative is not in ``reps``."""
        dev = self.device
        reps_t = torch.as_tensor(np.asarray(reps).astype(np.int64)).to(dev)
        N = reps_t.numel()
        bad = int((reps_t[1:] <= reps_t[:-1]).sum()) if N > 1 else 0
        nrm = torch.empty(N, dtype=torch.float64, device=dev)
        for a in range(0, N, ORBIT_BLOCK):
            s = reps_t[a:a + ORBIT_BLOCK]
            rep, _, norm2 = self.orbit_info(s)
            bad += int(((rep != s) | (norm2 <= 1e-12)).sum())
            nrm[a:a + ORBIT_BLOCK] = torch.sqrt(norm2.clamp_min(0))
        if norms is not None:
            theirs = torch.as_tensor(np.asarray(norms, dtype=np.float64)).to(
                dev)
            bad += int((torch.abs(theirs - nrm) > 1e-12 * nrm).sum())
        diag = torch.zeros(N, dtype=torch.float64, device=dev)
        tgt_all, src_all, val_all = [], [], []
        missing = 0
        edges = [(int(i), int(j), float(t.get("coupling", 1.0)))
                 for t in self.terms for i, j in t["edges"]]
        rows_per_block = max(1, ORBIT_BLOCK // max(1, len(edges)))
        for a in range(0, N, rows_per_block):
            s = reps_t[a:a + rows_per_block]
            src_idx = torch.arange(a, a + s.numel(), device=dev)
            srcs, betas, coefs = [], [], []
            for i, j, J in edges:
                anti = ((s >> i) ^ (s >> j)) & 1
                diag[a:a + s.numel()] += J * (1 - 2 * anti).to(torch.float64)
                m = anti.bool()
                srcs.append(src_idx[m])
                betas.append(s[m] ^ ((1 << i) | (1 << j)))
                coefs.append(torch.full((int(m.sum()),), 2.0 * J,
                                        dtype=torch.float64, device=dev))
            src = torch.cat(srcs)
            beta = torch.cat(betas)
            coef = torch.cat(coefs)
            rep, chi, _ = self.orbit_info(beta)
            tgt = torch.searchsorted(reps_t, rep).clamp_max(N - 1)
            found = reps_t[tgt] == rep
            missing += int((~found).sum())
            src, tgt, coef, chi = src[found], tgt[found], coef[found], \
                chi[found]
            val = coef * chi * nrm[tgt] / nrm[src]
            on_diag = tgt == src
            diag.index_add_(0, src[on_diag], val[on_diag])
            off = ~on_diag
            tgt_all.append(tgt[off])
            src_all.append(src[off])
            val_all.append(val[off])
        idx = torch.stack([torch.cat(tgt_all), torch.cat(src_all)])
        A = torch.sparse_coo_tensor(idx, torch.cat(val_all), (N, N))
        del idx, tgt_all, src_all, val_all
        A = A.coalesce().to_sparse_csr()
        return Operator(A, diag, bad=bad, missing=missing)


class Operator:
    """``y = diag·x + A·x`` for ``x`` of shape ``[N]`` or ``[N, R]``."""

    def __init__(self, A, diag, bad: int = 0, missing: int = 0):
        self.A, self.diag = A, diag
        self.n = diag.numel()
        self.nnz = int(A.values().numel())
        #: basis states out of order, not representatives, or with a
        #: wrong norm; flips whose representative is not in the basis
        self.bad, self.missing = bad, missing
        self._lower = None

    def apply(self, x: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
        if dtype == torch.float64:
            A, d = self.A, self.diag
        else:
            if self._lower is None or self._lower[0] != dtype:
                self._lower = (dtype, self.A.to(dtype), self.diag.to(dtype))
            _, A, d = self._lower
        xs = x.to(dtype)
        dd = d if xs.dim() == 1 else d[:, None]
        return (dd * xs + A @ xs).to(x.dtype)

    def lowest_eigenvalue(self, seed: int, dtype=torch.float64,
                          max_iters: int = 600, check: int = 10,
                          rtol: float = 1e-14) -> Tuple[float, int]:
        """(θ, iterations): the least Ritz value of a plain Lanczos run from
        a start drawn from ``seed``, stopped once it moved by at most
        ``rtol`` relative over two checks in a row."""
        dev = self.diag.device
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed) % (1 << 63))
        v = torch.randn(self.n, generator=g, device=dev,
                        dtype=torch.float64).to(dtype)
        v /= torch.linalg.vector_norm(v)
        v_prev = torch.zeros_like(v)
        alphas: List[float] = []
        betas: List[float] = []
        beta, prev, stable, theta = 0.0, None, 0, math.nan
        for it in range(1, max_iters + 1):
            w = self.apply(v, dtype) - beta * v_prev
            a = float(torch.dot(w, v))
            w -= a * v
            beta = float(torch.linalg.vector_norm(w))
            alphas.append(a)
            betas.append(beta)
            if it % check == 0 or beta == 0.0:
                T = np.diag(alphas) + np.diag(betas[:-1], 1) \
                    + np.diag(betas[:-1], -1)
                theta = float(np.linalg.eigvalsh(T)[0])
                if beta == 0.0:
                    return theta, it
                if prev is not None and abs(theta - prev) <= rtol * abs(
                        theta):
                    stable += 1
                    if stable >= 2:
                        return theta, it
                else:
                    stable = 0
                prev = theta
            v_prev, v = v, w / beta
        return theta, max_iters
