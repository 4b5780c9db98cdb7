"""Carry the reference's state across.

The system has no weights: its "parameters" are the built basis and the
operator's term tables.  :func:`operator_arrays` flattens an operator of
either package into NumPy arrays (it reads only attributes both packages'
``Operator`` and ``SpinBasis`` have, so it needs no import of the JAX
package), and :func:`operator_from_reference` rebuilds the port's
:class:`~.models.operator.Operator` from them with the basis already built
— so both packages can start from identical representatives and tables.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .models.basis import SpinBasis
from .models.expression import NonbranchingTerm
from .models.operator import Operator

__all__ = ["operator_arrays", "operator_from_reference"]

_TABLE_KEYS = ("diag_v", "diag_s", "diag_m", "diag_r",
               "off_x", "off_v", "off_s", "off_m", "off_r")


def operator_arrays(op) -> Dict[str, np.ndarray]:
    """The operator's basis spec, built representatives and norms, and term
    tables as NumPy arrays.  ``hamming_weight`` −1 and ``spin_inversion`` 0
    stand for None; ``sym_perms`` is [S, n] and ``sym_sectors`` [S]."""
    b = op.basis
    if getattr(b, "particle_type", "spin") != "spin":
        raise NotImplementedError("only spin bases carry across")
    n = b.number_spins
    dt, ot = op.diag_table, op.off_diag_table
    return {
        "number_spins": np.int64(n),
        "hamming_weight": np.int64(-1 if b.hamming_weight is None
                                   else b.hamming_weight),
        "spin_inversion": np.int64(b.spin_inversion or 0),
        "sym_perms": np.asarray([p for p, _ in b.symmetries],
                                np.int64).reshape(-1, n),
        "sym_sectors": np.asarray([s for _, s in b.symmetries], np.int64),
        "representatives": np.asarray(b.representatives, np.uint64),
        "norms": np.asarray(b.norms, np.float64),
        "diag_v": np.asarray(dt.v), "diag_s": np.asarray(dt.s),
        "diag_m": np.asarray(dt.m), "diag_r": np.asarray(dt.r),
        "off_x": np.asarray(ot.x), "off_v": np.asarray(ot.v),
        "off_s": np.asarray(ot.s), "off_m": np.asarray(ot.m),
        "off_r": np.asarray(ot.r),
    }


def operator_from_reference(arrays: Dict[str, np.ndarray],
                            device=None) -> Operator:
    """The port's Operator from :func:`operator_arrays` output, its basis
    built from the given representatives and norms.  The term list is read
    back from the tables (padding legs carry zero amplitude and are
    dropped), and the Operator's own table build reproduces them, since
    both sort the simplified terms the same way.  ``device`` is accepted
    for symmetry with the engine; the Operator itself is host data."""
    del device
    hw = int(arrays["hamming_weight"])
    inv = int(arrays["spin_inversion"])
    basis = SpinBasis(
        int(arrays["number_spins"]), None if hw < 0 else hw,
        inv or None,
        [(list(p), int(s)) for p, s in zip(arrays["sym_perms"].tolist(),
                                           arrays["sym_sectors"].tolist())])
    basis.unchecked_set_representatives(
        np.asarray(arrays["representatives"], np.uint64),
        np.asarray(arrays["norms"], np.float64))
    u = {k: np.asarray(arrays[k]) for k in _TABLE_KEYS}
    terms = [NonbranchingTerm(v=complex(v), x=0, s=int(s), m=int(m),
                              r=int(r))
             for v, s, m, r in zip(u["diag_v"], u["diag_s"], u["diag_m"],
                                   u["diag_r"])]
    for t, x in enumerate(u["off_x"].tolist()):
        for j in range(u["off_v"].shape[1]):
            v = complex(u["off_v"][t, j])
            if v == 0:
                continue
            terms.append(NonbranchingTerm(
                v=v, x=int(x), s=int(u["off_s"][t, j]),
                m=int(u["off_m"][t, j]), r=int(u["off_r"][t, j])))
    op = Operator(basis, terms)
    for k in _TABLE_KEYS:
        part, field = k.split("_")
        table = op.diag_table if part == "diag" else op.off_diag_table
        if not np.array_equal(np.asarray(getattr(table, field)), u[k]):
            raise ValueError(f"table {k} does not carry across")
    return op
