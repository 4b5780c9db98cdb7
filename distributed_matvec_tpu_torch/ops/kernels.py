"""Operator-application kernels on tensors: diag, off-diag, and state_info.

PyTorch counterpart of ``distributed_matvec_tpu/ops/kernels.py``: plain
tensor code that runs on whatever device its tables live on.  States are u64
bit patterns in int64 tensors (:mod:`..utils.u64`).

The off-diagonal kernel emits a dense ``[B, T]`` (T = flip-mask groups) with
zero amplitude marking absent elements.  ``state_info`` canonicalizes through
an orbit scan over the group: each coset representative's shift/mask network
is applied once, then the cheap advance network ``h`` walks the cyclic
subgroup, so no ``[B, |G|]`` orbit is ever materialized.

The scan's shift amounts and masks are Python ints (see
:class:`GroupTables`), so each network step is a few elementwise tensor ops
with scalar operands.  Hopper has native f64 and complex128, so the JAX
package's TPU workarounds (the (re, im) pair form, the coset-loop switch) are
not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.symmetry import _CHAR_TOL
from ..utils import u64
from .bits import sign_from_parity

__all__ = ["DiagKernelTables", "OffDiagKernelTables", "GroupTables",
           "OperatorTables", "device_tables", "apply_diag", "apply_off_diag",
           "gather_coefficients", "mask_structure", "state_info"]

# Zero-norm snap tolerance for the stabilizer character sum, shared with the
# host enumeration (models.symmetry._CHAR_TOL): sectors whose character sum
# cancels exactly leave ~1e-16 of residue, which must read as "state not in
# sector" on device exactly as it does on the host.
_NORM2_TOL = _CHAR_TOL

# One network: [(mask, left shift, right shift), ...] as Python ints, the
# mask as the int64 with the same bits.
Network = List[Tuple[int, int, int]]


@dataclass
class DiagKernelTables:
    v: torch.Tensor  # [K] f64
    s: torch.Tensor  # [K] int64 (u64 bits)
    m: torch.Tensor  # [K] int64
    r: torch.Tensor  # [K] int64


@dataclass
class OffDiagKernelTables:
    x: torch.Tensor  # [T] int64 flip mask per group
    v: torch.Tensor  # [T, K] f64, or c128 in a complex sector
    s: torch.Tensor  # [T, K] int64
    m: torch.Tensor  # [T, K] int64
    r: torch.Tensor  # [T, K] int64


@dataclass
class GroupTables:
    """Coset-walk tables of the symmetry group
    (``symmetry.SymmetryGroup.coset_walk``): the advance network ``h``, one
    network and spin-inversion xor per coset representative, and the
    canonical element index of ``h^k·c_j``."""

    h: Network
    cosets: List[Network]
    c_xor: List[int]              # [J] int64 bits
    elem: np.ndarray              # [J, P] element index
    char_conj: torch.Tensor       # [G] χ*(g): f64, or c128 in a complex sector
    char_real: List[float]        # [G] Re χ(g) for the stabilizer sums


@dataclass
class OperatorTables:
    diag: DiagKernelTables
    off: OffDiagKernelTables
    group: Optional[GroupTables]  # None when the basis needs no projection


def _network(ls, rs, ms) -> Network:
    # zero-mask entries contribute nothing; the JAX tables pad with them
    return [(u64.as_signed(m), int(a), int(b))
            for a, b, m in zip(ls.tolist(), rs.tolist(), ms.tolist())
            if int(m)]


def device_tables(op, device) -> OperatorTables:
    """Compile an Operator into kernel tables on ``device``.  The
    off-diagonal values and the group characters are f64 in a real sector
    and complex128 otherwise (``not op.effective_is_real``)."""
    real = op.effective_is_real
    cdtype = torch.float64 if real else torch.complex128
    dt, ot = op.diag_table, op.off_diag_table
    if np.abs(dt.v.imag).max(initial=0.0) >= 1e-12:
        raise ValueError("non-real diagonal")

    def bits(a):
        return u64.from_numpy(a, device)

    def values(a):
        return torch.as_tensor(a.real if real else a, dtype=cdtype,
                               device=device)

    diag = DiagKernelTables(
        v=torch.as_tensor(dt.v.real, dtype=torch.float64, device=device),
        s=bits(dt.s), m=bits(dt.m), r=bits(dt.r))
    off = OffDiagKernelTables(
        x=bits(ot.x), v=values(ot.v), s=bits(ot.s), m=bits(ot.m),
        r=bits(ot.r))
    group = None
    if op.basis.requires_projection:
        g = op.basis.group
        (h_ls, h_rs, h_m, _), coset_nets, elem_idx = g.coset_walk()
        group = GroupTables(
            h=_network(h_ls, h_rs, h_m),
            cosets=[_network(ls, rs, m) for ls, rs, m, _ in coset_nets],
            c_xor=[u64.as_signed(x) for _, _, _, x in coset_nets],
            elem=np.stack(elem_idx),
            char_conj=values(np.conj(g.characters)),
            char_real=[float(c) for c in g.characters.real],
        )
    return OperatorTables(diag=diag, off=off, group=group)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f64 square root.  CUDA's is; PyTorch's CPU kernel
    can be 1 ulp off (sqrt(0.5) → 0.7071067811865475), so CPU tensors go
    through NumPy's, which is."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _apply_network(net: Network, s: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(s)
    for m, ls, rs in net:
        acc |= u64.srl((s & m) << ls, rs)
    return acc


def apply_diag(t: DiagKernelTables, alphas: torch.Tensor) -> torch.Tensor:
    """d(α) for a batch: [B] → [B] f64."""
    if t.v.shape[0] == 0:
        return torch.zeros(alphas.shape, dtype=torch.float64,
                           device=alphas.device)
    a = alphas[:, None]
    sign = sign_from_parity(a & t.s[None, :])
    ok = (a & t.m[None, :]) == t.r[None, :]
    return torch.sum(t.v[None, :] * sign * ok, dim=1)


def apply_off_diag(t: OffDiagKernelTables, alphas: torch.Tensor):
    """H's off-diagonal action: [B] → betas [B, T], amps [B, T].

    amps[i,j] = Σ_k v[j,k]·(−1)^pc(α_i∧s)·[α_i∧m==r]; betas[i,j] = α_i⊕x[j].
    The sum over k runs in order, one leg at a time, as the JAX reduce does.
    """
    betas = alphas[:, None] ^ t.x[None, :]
    a = alphas[:, None]
    amps = torch.zeros(betas.shape, dtype=t.v.dtype, device=alphas.device)
    for k in range(t.v.shape[1]):
        sign = sign_from_parity(a & t.s[None, :, k])
        ok = (a & t.m[None, :, k]) == t.r[None, :, k]
        amps = amps + t.v[None, :, k] * sign * ok
    return betas, amps


def gather_coefficients(t: OperatorTables, alphas: torch.Tensor,
                        norms_alpha: torch.Tensor):
    """Row-form neighbor structure of a Hermitian operator: the canonical
    target states and the row matrix elements
    ``A[α, rep(β)] = conj(⟨β|H|α⟩·χ*(g))·n(β)/n(α)``.  [B] → ([B, T]
    int64, [B, T] f64 or c128); zero amplitude marks "no matrix
    element"."""
    betas, amps = apply_off_diag(t.off, alphas)  # amps = ⟨β|H|α⟩
    if t.group is not None:
        rep_b, char_conj_b, norm_b = state_info(t.group, betas)
        ratio = norm_b / norms_alpha[:, None]
        amps = torch.conj_physical(amps * char_conj_b) * ratio
        betas = rep_b
    else:
        amps = torch.conj_physical(amps)
    return betas, amps


def mask_structure(coeff: torch.Tensor, idx: torch.Tensor,
                   found: torch.Tensor, valid_row: torch.Tensor):
    """Zero out absent or padded entries and count out-of-basis targets.

    ``valid_row`` marks the non-SENTINEL rows ([B] bool).  An entry with a
    *structurally* nonzero coefficient (``coeff != 0``, not amplitude·x)
    whose target is not in the basis counts as ``invalid``, so a first-call
    check holds for every later x.  Returns (idx, coeff, invalid)."""
    nz = (coeff != 0) & valid_row[:, None]
    invalid = torch.sum(nz & ~found)
    nz &= found
    return idx.masked_fill(~nz, 0), coeff.masked_fill(~nz, 0), invalid


def state_info(g: GroupTables, states: torch.Tensor):
    """Orbit scan: canonical representative, χ*, and norm for each state.

      rep(σ)  = min_g g·σ            (unsigned order)
      char(σ) = χ*(g_first-achieving-min, in element order)
      norm(σ) = sqrt((1/|G|)·Σ_{g·σ=σ} Re χ(g))   (0 ⇒ not in the sector)

    The scan visits the elements in the JAX scan's order (coset by coset,
    advancing through the cyclic subgroup) and keeps the FIRST element that
    reaches the minimum, so χ* and the stabilizer sum match it bit for bit.
    """
    G = len(g.char_real)
    flat = states.reshape(-1)
    best = flat.clone()                  # the identity, element index 0
    gidx = torch.zeros(flat.shape, dtype=torch.int64, device=flat.device)
    stab = torch.zeros(flat.shape, dtype=torch.float64, device=flat.device)

    def update(y, gi):
        nonlocal best, stab
        better = u64.ult(y, best)
        best = torch.where(better, y, best)
        gidx.masked_fill_(better, int(gi))
        stab = torch.where(y == flat, stab + g.char_real[int(gi)], stab)

    P = g.elem.shape[1]
    for j, net in enumerate(g.cosets):
        z = _apply_network(net, flat) ^ g.c_xor[j]
        update(z, g.elem[j, 0])
        for k in range(1, P):
            z = _apply_network(g.h, z)
            update(z, g.elem[j, k])
    char = g.char_conj[gidx]
    # XLA compiles the reference's ``stab / G`` as ``stab · (1/G)``;
    # the same product keeps the norms bit-identical
    norm2 = stab * (1.0 / G)
    norm = torch.where(norm2 > _NORM2_TOL,
                       _sqrt(torch.clamp(norm2, min=0.0)),
                       torch.zeros_like(norm2))
    shape = states.shape
    return best.reshape(shape), char.reshape(shape), norm.reshape(shape)
