"""The benchmark's fixed measures: the card's published peaks, the bytes a
product must move, and the kernel-name table that buckets device time.

These are copies, frozen here so that a change to the program cannot move
the yardstick it is measured with.  ``decode_bytes`` is the byte count of
the repository's ``chip_smoke.py`` (with ``packed_words`` of the program's
plan codec); ``KERNEL_PHASES`` is the table of the program's
``obs/kernel_costs.py``.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, data sheet: HBM3 bandwidth in bytes per second, and
#: float64 outside the tensor cores in operations per second
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12


def packed_words(n: int, width: int) -> int:
    """u32 words that hold ``n`` values of ``width`` bits, and one spare
    word so that a two-word read never runs off the end."""
    return (n * width + 31) // 32 + 1


def decode_bytes(spec: dict, B: int) -> int:
    """Bytes one launch of the decode kernel must move: its dest and row
    word streams, its codes, the per-bucket fill counts, the dictionary and
    the chunk's ``x`` read once, and the send buffer written once.  ``spec``
    is the plan codec's record spec (``n_live``, ``w_dest``, ``w_row``,
    ``code_bits``, ``D``, ``ndict``, ``n_recv``), ``B`` the row chunk."""
    nl = spec["n_live"]
    words = packed_words(nl, spec["w_dest"]) + packed_words(nl, spec["w_row"])
    return (4 * words + nl * spec["code_bits"] // 8 + 4 * spec["D"]
            + 8 * spec["ndict"] + 8 * B + 8 * (spec["n_recv"] + 1))


def apply_bytes(n_states: int, nnz: int, columns: int) -> int:
    """Bytes one float64 product ``Y = H·X`` of ``columns`` columns must move
    whatever implements it: ``X`` read once and ``Y`` written once
    (16 B per state and column), and each stored off-diagonal element read
    once, as plain CSR holds it (an 8 B coefficient and a 4 B index)."""
    return 16 * n_states * columns + 12 * nnz


def bound_s(nbytes: float) -> float:
    """The least time the card takes to move ``nbytes`` at its peak."""
    return nbytes / HBM_BYTES_PER_S


#: Kernel-name substrings (lower case) → phase, first match wins.
KERNEL_PHASES = (
    ("nccl", "exchange"),
    ("gloo", "exchange"),
    ("memcpy dtoh", "exchange"),
    ("memcpy ptop", "exchange"),
    ("memcpy htod", "plan_h2d"),
    ("fused_decode", "compute"),
    ("ell_terms_kernel", "compute"),
    ("ell_tail_kernel", "compute"),
    ("indexfunc", "accumulate"),
    ("index_add", "accumulate"),
    ("indexing_backward", "accumulate"),
    ("index_put", "accumulate"),
    ("scatter", "accumulate"),
    ("fillfunctor", "overhead"),
    ("memset", "overhead"),
    ("memcpy dtod", "overhead"),
    ("indexselect", "compute"),
    ("index_select", "compute"),
    ("gather", "compute"),
    ("elementwise", "compute"),
    ("reduce_kernel", "compute"),
    ("gemm", "compute"),
    ("gemv", "compute"),
    ("dot_kernel", "compute"),
    ("aten::mul", "compute"),
    ("aten::where", "compute"),
)


def classify_kernel(name: str) -> str:
    """Phase of one kernel or copy name; ``overhead`` where none matches."""
    low = str(name).lower()
    for sub, phase in KERNEL_PHASES:
        if sub in low:
            return phase
    return "overhead"


#: the decode kernel's name, as the profiler records it
DECODE_KERNEL = "fused_decode"
