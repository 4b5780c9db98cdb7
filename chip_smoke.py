#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, one JSON line each with its seconds:

1. ``build``: the CUDA kernels (``nvcc``, one process per source, started
   together) and the C++ enumerator, from the checkout's sources into
   ``build/``.
2. ``kernel_check``: each kernel against its plain PyTorch version on the
   card (``torch.equal``), on synthetic chunks (``KERNEL_CASES``) — u8 and
   u16 codes, small and large dictionaries, 1- to 32-bit fields that
   straddle u32 words, no padding, all padding, entry counts beside the
   kernel's tile, entries in random order over the bucket prefixes of 2–4
   shards, D = 4 chunks whose receive-side rok differs from the send
   occupancy both ways, and one device's identity layout at
   chain_32_symm's size.
3. ``small``: chain_16_symm through the streamed engine and Lanczos: the
   matvec against the host NumPy ``matvec_host`` (atol 1e-13 / rtol 1e-12;
   the receive-side ``index_add_`` uses atomics, so sums run in another
   order), E0/4 against the N=16 ring anchor −7.1422963606 (1e-9).
4. ``full``: ``heisenberg_chain(32, symmetric=True)`` at the default row
   chunk and the ``lossless`` codec — 4 707 969 representatives, |G| = 128,
   T = 32 — enumerated by the native C++ kernel; one real plan chunk is
   held against the plain version, then the launch counts are set to 0,
   the main path runs (timed applies, then Lanczos), and the counts are
   read: every apply must have launched the decode kernel once per plan
   chunk.  E0 must match −56.826110112297656 (the recorded TPU run) to
   1e-8 relative, and the JAX package's E0 on the CPU,
   −56.82610975579819 (``tools/torch_e0_parity.py``), to 1e-10.
5. ``split``: where an apply's time goes — the plan's host → device copy
   alone, the apply with the plan already on the card, the decode kernel
   per launch over every chunk of the plan beside its byte bound, its
   plain version, and the earlier one-thread-per-entry design (timed in
   turns, with its zero fill and without), and a ``torch.profiler``
   breakdown of one streamed apply by device kernel, in which nothing may
   fill a send buffer once per chunk.
6. ``local_full``: the same chain_32_symm operator (enumerated once, by
   the full leg) through ``LocalEngine``, the default single-device path,
   in plain PyTorch: the one-pass ``ell`` build (seconds, T0/S/Tmax,
   table bytes, peak memory beside the 1.6× reckoning), its apply against
   the streamed engine's (atol 1e-13 / rtol 1e-12), 7 applies timed (host
   wall and device time) and one profiled, Lanczos (E0 within 1e-8
   relative of the recorded value and 1e-10 of the full leg's); the
   low-memory build forced by a small budget, ``torch.equal`` to the
   one-pass tables; ``compact`` mode built, timed and solved to the same
   E0; one ``fused`` apply against the ell apply, timed.  ``plain_work``
   holds each apply's bytes and byte bound at 3.35 TB/s.
7. ``solvers``: the eager solver family on the same chain_32_symm
   operator at full width, over ``local_full``'s ell engine:
   ``lanczos_block(k=4, block_size=4)`` against ``lanczos(k=4)`` (1e-9)
   and the full leg's E0 (1e-10); ``lanczos`` with ``reorth="selective"``
   against ``"full"`` (E0 within 1e-10); ``lobpcg(k=4)`` (E0 within 1e-8
   relative); ``kpm_moments`` (256 moments, 4 vectors: the bracket holds
   E0, the Jackson DOS integrates to 1 ± 0.02), then the same block and
   bounds at 128 moments through the streamed engine's ``[1, M, 4]``
   apply (moments within 1e-10 of the ell ones; the decode kernel
   launched 4 times per plan chunk per apply, counted from 0 around this
   run); ``krylov_evolve`` of the ground state to t = 1 (``e^{−iE0 t}ψ0``
   within 1e-9, norm drift below 1e-10); ``expectations([H])`` (E0
   within 1e-9).  Each solver's seconds, applies and the time inside
   them, ms per apply per column at R = 1 and R = 4 on both engines, and
   a ``torch.profiler`` breakdown of the ell R = 4 apply.
8. ``cross_sector``: the same ring in the translation-only k = 0 sector
   (18 784 170 states: no reflection, no spin inversion, so other orbits,
   norms and plan) must give the same E0 as the full leg to 1e-9.
9. ``sharded``: the same chain_32_symm operator (enumerated once, by the
   full leg) through ``DistributedEngine(op, n_devices=4, mode=m)`` — four
   hash shards on the one card, row chunk 16 384 — in every mode:
   ``streamed``, ``ell``, ``compact`` and ``fused``.  Each build's seconds,
   peak device memory and plan or table bytes; the apply, through
   ``from_hashed``, against ``local_full``'s ell apply (atol 1e-13 / rtol
   1e-12); 7 timed applies (host wall and CUDA events; one for fused);
   for streamed and ell, a ``torch.profiler`` breakdown of one apply and
   Lanczos E0 within 1e-10 of the full leg's and 1e-8 relative of the
   recorded value.  For streamed, the decode kernel
   on real D = 4 chunks: every chunk of shard 0 and the middle chunk of
   every shard against the plain version (``torch.equal``), its time per
   launch over every (chunk, shard) beside the byte bound, and its
   launches counted from 0 around the main path: 4 × 72 per apply.  Times
   here are one card running four shards, not a four-card result.  The
   streamed and fused engines stay built for the next phase.
10. ``pipeline``: ``pipeline_depth`` switched on engines already built —
   the full leg's D = 1 streamed engine at depths 0, 2 and 4, the sharded
   leg's D = 4 streamed engine at 0 and 2, and one D = 4 fused apply at 0
   and at 2.  Each pipelined streamed apply must equal its engine's
   depth-0 apply bit for bit (both under
   ``torch.use_deterministic_algorithms``), the fused one within atol
   1e-13 / rtol 1e-12 (deterministic, a fused apply takes ≈ 30 s; the
   card tests hold fused bit for bit at chain_16_symm), and each must
   report the depth it resolved (fused: 2); the decode kernel is held
   against its plain version on one chunk inside a depth-2 apply; a
   ``[1, M, 6]`` streamed apply at depth 2 must equal its two column
   groups (4 + 2).  Then 7 timed streamed applies per engine and depth
   (host wall median and device time, ``last_pipeline.barrier_ms``), the
   pipelined ones with the launch counts set to 0 just before and read
   just after: one per plan chunk per shard per apply; and the two fused
   applies' host times.
11. ``ranks``: the rank engine, ``DistributedEngine(op, group=g)`` — one
   hash shard per process rank, meeting only in ``torch.distributed``
   collectives — on the same chain_32_symm operator.  (a) Two ranks share
   the one card over gloo (spawned; each builds the basis itself): ``ell``
   (build, apply, 3 timed applies, Lanczos to E0, then ``lanczos_block(k=4,
   block_size=4)`` and ``lobpcg(k=4)`` as ``solvers`` runs them) and
   ``streamed`` at B = 65 536 with 2²¹-entry buckets (build, the decode
   kernel on three of its own chunks against the plain version, 3 timed
   applies with its launches counted from 0: one per plan chunk per apply;
   then at depth 2 an apply bit-equal to depth 0 under deterministic
   algorithms, and 3 more timed applies, counted alike).  Rank 0 gathers
   each apply, which must equal ``local_full``'s ell apply (atol 1e-13 /
   rtol 1e-12); both ranks' E0 must be the same bits and within 1e-10 of
   the full leg's; both ranks' block-solver eigenvalues the same bits and
   within 1e-10 of ``solvers``' one-process ones.  Per rank: build
   seconds, apply ms (host wall and CUDA events), the exchange's ms and
   bytes per apply, the host ms waiting in retires at depth 2, each block
   solver's seconds, applies, share outside the applies and count of
   collectives, whether the exchange is staged through host memory, and
   whether this torch's gloo takes CUDA tensors itself in
   ``all_to_all_single``.  A rank that fails or outlasts the join timeout
   fails the phase.  Two ranks on one card are not a two-card result.  (b) A
   one-rank NCCL group in this process: the streamed engine at D = 1 with
   every exchange through ``all_to_all_single``; its plan must equal the
   full leg's byte for byte and its apply the full leg's bit for bit at
   depth 0 and at depth 2 (all applies under
   ``torch.use_deterministic_algorithms``).  (c) With two or more cards,
   leg (a) over NCCL, one rank per card; on one card a line says it did
   not run and why.
12. ``local_complex``: the translation-only k = 1 sector of the 32-ring,
   complex Hermitian (about 18.8 M states): the ``ell`` build takes the
   low-memory path by itself (1.6× the full-width complex tables passes
   the 12 GB default budget), one ``fused`` apply against the ell apply,
   complex128 Lanczos to a converged E0(k=1) strictly above the full
   leg's E0(k=0), with the peak memory, and a native-complex
   ``krylov_evolve`` of a random state to t = 0.25 (norm drift below
   1e-10).  It keeps one ell apply of a seeded state for
   ``streamed_complex`` and frees its engines.
13. ``tiers`` (after ``pipeline``): the full leg's chain_32_symm operator
   through the streamed engine's other tiers and forms, each held to the
   full leg's lossless D = 1 apply of one seeded state: ``off`` (the raw
   layout; plan bytes; the apply bit-equal under
   ``torch.use_deterministic_algorithms``; decode path ``torch``, no
   decode-kernel launch); ``f32`` and ``bf16`` (decode path ``cuda``: the
   unchanged kernel on quantized dictionaries, held against its plain
   version on one real chunk, launched once per chunk per apply, counted
   from 0 around an apply and a Lanczos solve; the apply's largest error
   relative to the largest lossless value within 1e-6 and 1e-2; the E0
   each finds beside the lossless one, no bound); raw coefficient streams
   (``ops.plan_codec.DICT_MAX`` lowered around one lossless build:
   ``coeff == "raw"``, bit-equal apply); ``hybrid`` at ``all-stream``,
   ``stream:<even terms>`` and ``all-recompute`` (one chunk's send buffer
   bit-equal to the lossless engine's, the apply bit-equal at depth 0 and
   2, ``hybrid_stream_fraction``, plan bytes, host and device ms).  Each
   build's seconds; no engine outlives its leg.
14. ``streamed_complex`` (after ``local_complex``): the same k = 1 sector
   of the 32-ring through ``DistributedEngine(op)`` — the streamed engine,
   lossless, a complex dictionary, decode path ``torch``: build seconds,
   plan bytes, codec spec and peak memory; the apply against
   ``local_complex``'s ell apply (atol 1e-13 / rtol 1e-12); 3 timed
   applies (host wall and CUDA events) and a ``torch.profiler`` breakdown
   of one (decode, host → device copy, ``index_add_``); complex-Hermitian
   Lanczos to E0(k = 1) within 1e-10 of ``local_complex``'s
   −55.581030569044785; a ``[1, M, 3]`` apply against three single-column
   ones (atol 1e-13); no decode-kernel launch.

``local_small`` runs after ``small``: chain_16_symm through ``LocalEngine``
in ``ell``, ``compact`` and ``fused`` mode at ``batch_size=61`` (chunking
and padding engage), matvec rank-1 and ``[N, 3]`` against ``matvec_host``
(atol 1e-13 / rtol 1e-12), E0/4 against the anchor (1e-9), and a complex
k = 1 sector of the 16-ring in ``ell`` and ``fused`` mode against
``matvec_host``.

Then the kernels line ``{"kernels": [...]}`` (launches on the main paths
of ``full``, ``solvers``, ``sharded``, ``pipeline``, ``tiers`` and
``ranks``, and apart at one shard, at four, in the pipelined applies, in
the quantized tiers and on the ranks;
largest error against the plain version, time per launch beside its bound
and the plain version's time, at one shard and at four), the card's name
and power limit as ``nvidia-smi`` prints them, and last ``{"ok": true, "device": {...}}``.
Any failed check raises and the script exits non-zero.  It needs one CUDA
device; without one it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and FP64 outside
#: the tensor cores — the decode kernel's one multiply per entry is plain
#: FP64
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12

CHAIN32_STATES = 4_707_969
CHAIN32_E0 = -56.826110112297656      # BENCH_RECORDED_r02.json lanczos_e0
#: the JAX package's LocalEngine and lanczos on the CPU in float64, to a
#: residual of 2e-13 (tools/torch_e0_parity.py): the recorded TPU value
#: above lies 3.6e-7 below it, so that run was not this arithmetic
CHAIN32_E0_CPU = -56.82610975579819
N16_E0_OVER_4 = -7.1422963606


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def run_phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    info = out[0] if isinstance(out, tuple) else out
    emit({"phase": name, "seconds": time.perf_counter() - t0, **info})
    return out


# -- phase 1 ------------------------------------------------------------------

def build_phase():
    from distributed_matvec_tpu_torch.enumeration import native
    from distributed_matvec_tpu_torch.ops import cuda_kernels

    enum_ok = {}
    t = threading.Thread(
        target=lambda: enum_ok.update(ok=native.native_available()))
    t.start()
    libs = cuda_kernels.build_all()
    t.join()
    if not enum_ok.get("ok"):
        raise RuntimeError("the C++ enumerator did not build")
    ptxas = [ln.strip() for name in libs
             for ln in cuda_kernels.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    return {"libraries": sorted(libs), "native_enumerator": True,
            "ptxas": ptxas}


# -- phase 2 ------------------------------------------------------------------

def synthetic_chunk(device, B, n_recv, n_live, n_real, code_bits, ndict,
                    seed, identity=False, w_dest=None, w_row=None, D=None,
                    rok_differs=False):
    """One encoded chunk as the codec writes it: ``n_recv`` send slots in D
    buckets (D = 1 with ``identity``, else the largest of 4, 3, 2, 1 that
    divides ``n_recv``, unless given), ``n_real`` live entries filling a
    random prefix of each bucket — in order with ``identity``, as at one
    device, else in random order — then padding entries at the drop
    sentinel with one pad code and row 0; and the per-bucket fill counts.
    ``w_dest``/``w_row`` widen the fields beyond the bits their values
    need.  With ``rok_differs`` the chunk's receive side gets other bucket
    counts, so its rok flags and the send occupancy differ in both
    directions (the trap of taking rok for the send side; raises if the
    draw does not show it).  Returns the kernel's arguments."""
    import numpy as np
    import torch

    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    rng = np.random.default_rng(seed)
    if D is None:
        D = 1 if identity else next(k for k in (4, 3, 2, 1)
                                    if n_recv % k == 0)
    cap = n_recv // D
    spec = {"n_live": n_live, "n_recv": n_recv, "D": D, "cap_eff": cap,
            "w_dest": w_dest or PC.bits_for(n_recv),
            "w_row": w_row or PC.bits_for(B - 1),
            "code_bits": code_bits, "ndict": ndict, "coeff": "dict",
            "cshape": [B, 32]}
    slot = np.arange(n_recv)
    fill = np.bincount(rng.permutation(n_recv)[:n_real] // cap,
                       minlength=D).astype(np.int32)
    occupied = slot % cap < fill[slot // cap]
    if rok_differs:
        recv = np.bincount(rng.permutation(n_recv)[:n_real] // cap,
                           minlength=D)
        rok = slot % cap < recv[slot // cap]
        if not ((rok & ~occupied).any() and (occupied & ~rok).any()):
            raise AssertionError("rok and the send occupancy do not differ "
                                 "both ways")
    dest = np.full(n_live, n_recv, np.int64)
    dest[:n_real] = (np.flatnonzero(occupied) if identity
                     else rng.permutation(np.flatnonzero(occupied)))
    rows = np.zeros(n_live, np.int64)
    rows[:n_real] = np.sort(rng.integers(0, B, n_real)) if identity \
        else rng.integers(0, B, n_real)
    code_np = np.uint8 if code_bits == 8 else np.uint16
    codes = np.full(n_live, ndict - 1, code_np)
    codes[:n_real] = rng.integers(0, ndict, n_real)
    words = np.concatenate([PC.pack_bits(dest, spec["w_dest"]),
                            PC.pack_bits(rows, spec["w_row"])])
    ecodes = torch.from_numpy(codes if code_bits == 8
                              else codes.view(np.int16))
    return (spec, torch.from_numpy(words.view(np.int32)).to(device),
            ecodes.to(device), torch.from_numpy(fill).to(device),
            torch.from_numpy(rng.standard_normal(ndict)).to(device),
            torch.from_numpy(rng.standard_normal(B)).to(device))


def check_kernel(args) -> float:
    """Kernel vs plain version on the same inputs; raises unless equal.
    Returns the largest absolute difference (0.0 when equal).  The kernel
    runs twice: through the wrapper, and once more into a buffer filled
    with NaN first, so a slot it leaves unwritten shows."""
    import torch

    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    spec = args[0]
    want = PC._fused_decode_gather_scatter_plain(*args)
    outs = [PC.fused_decode_gather_scatter(*args)]
    if outs[0].device.type == "cuda":
        outs.append(torch.full_like(outs[0], float("nan")))
        PC._launch_fused_decode(*args, outs[1])
        torch.cuda.synchronize()
    err = 0.0
    for got in outs:
        e = float((got - want).abs().max())
        err = max(err, e)
        if not torch.equal(got, want):
            raise AssertionError(
                f"fused decode kernel differs from its plain version "
                f"(max abs err {e}, spec {spec})")
    return err


def per_entry_launch(spec, edest, ecodes, cdict, x_c, out) -> None:
    """The earlier design of the decode kernel (one thread per entry, no
    fill counts, ``out`` zero-filled by the caller), for timing beside the
    kernel; the main path never calls it."""
    import torch

    from distributed_matvec_tpu_torch.ops import cuda_kernels
    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    lib = cuda_kernels.library("fused_decode")
    rc = lib.dmt_fused_decode_per_entry(
        edest.data_ptr(), PC.packed_words(spec["n_live"], spec["w_dest"]),
        ecodes.data_ptr(), spec["code_bits"], cdict.data_ptr(),
        x_c.data_ptr(), out.data_ptr(), spec["n_live"], spec["w_dest"],
        spec["w_row"], spec["n_recv"],
        torch.cuda.current_stream(out.device).cuda_stream)
    if rc:
        raise RuntimeError(f"per-entry decode launch failed: "
                           f"{cuda_kernels.error_string(rc)}")


#: kernel_check's synthetic chunks: (B, n_recv, n_live, n_real, code_bits,
#: ndict, keyword options).  The kernel's tile is 1024 entries.  Unless a
#: case says otherwise, the live entries sit in random order over the
#: prefixes of 4, 3 or 2 buckets.
KERNEL_CASES = [
    (96, 150, 136, 121, 8, 200, {}),
    (5000, 9000, 8000, 7000, 8, 13, {}),
    # u16 codes, a large dictionary
    (65536, 1_200_000, 1_200_008, 1_199_000, 16, 3000, {}),
    # u16 codes; 32-bit fields
    (300, 2000, 1800, 1500, 16, 700, {"w_dest": 32, "w_row": 32}),
    # one device at chain_32_symm's shape: dest the identity, rows sorted
    (65536, 1_380_000, 1_380_008, 1_379_000, 8, 200, {"identity": True}),
    # no padding entry: the drop slot is 0.0
    (4096, 5000, 4000, 4000, 8, 50, {}),
    (4096, 4000, 4000, 4000, 8, 50, {"identity": True}),
    # every entry padding
    (100, 300, 264, 0, 8, 9, {}),
    # n_live just below and above multiples of the tile
    (700, 1100, 1023, 1000, 8, 30, {}),
    (700, 1100, 1025, 1025, 8, 30, {}),
    (700, 2047, 2047, 2046, 16, 30, {"identity": True}),
    (700, 2100, 2049, 2040, 8, 30, {}),
    # 1-bit fields: one slot, two rows
    (2, 1, 8, 1, 8, 4, {}),
    (2, 1, 1, 1, 8, 4, {}),
    # D = 4 shards, the receive side's rok unlike the send occupancy in
    # both directions: at the sharded leg's shape (16 384 rows, ~85 k
    # entries per bucket), buckets smaller than a tile, and u16 codes
    (16384, 344_000, 340_008, 339_000, 8, 200,
     {"D": 4, "rok_differs": True}),
    (700, 1200, 1000, 990, 8, 30, {"D": 4, "rok_differs": True}),
    (300, 2400, 2200, 2100, 16, 700, {"D": 4, "rok_differs": True}),
]


def kernel_check_phase(device):
    errs = [check_kernel(synthetic_chunk(device, *case[:6], seed=i,
                                         **case[6]))
            for i, case in enumerate(KERNEL_CASES)]
    return {"cases": len(errs),
            "rok_differs_cases": sum(bool(c[6].get("rok_differs"))
                                     for c in KERNEL_CASES),
            "max_abs_err": max(errs)}, max(errs)


# -- phase 3 ------------------------------------------------------------------

def small_phase(device):
    import numpy as np

    from distributed_matvec_tpu_torch import DistributedEngine, lanczos
    from distributed_matvec_tpu_torch.models.lattices import heisenberg_chain

    op = heisenberg_chain(16, symmetric=True)
    eng = DistributedEngine(op, device=device)
    x = np.random.default_rng(5).random(op.basis.number_states) - 0.5
    y = eng.matvec_global(x)
    ref = op.matvec_host(x)
    np.testing.assert_allclose(y, ref, atol=1e-13, rtol=1e-12)
    res = lanczos(eng.matvec, v0=eng.random_hashed(1), k=1, device=device)
    e0 = float(res.eigenvalues[0])
    if not (res.converged and abs(e0 / 4 - N16_E0_OVER_4) < 1e-9):
        raise AssertionError(f"chain_16_symm E0/4 {e0 / 4} != "
                             f"{N16_E0_OVER_4} (converged {res.converged})")
    return {"n_states": int(op.basis.number_states),
            "matvec_max_abs_err": float(np.abs(y - ref).max()),
            "lanczos_iters": int(res.num_iters), "e0": e0,
            "e0_over_4": e0 / 4}


# -- local_small --------------------------------------------------------------

def assert_close(got, want, what, atol=1e-13, rtol=1e-12) -> float:
    """Raise unless ``|got − want| ≤ atol + rtol·|want|`` everywhere (on
    the device); returns the largest absolute difference."""
    import torch

    got = torch.as_tensor(got)
    want = torch.as_tensor(want).to(got.device)
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or bool(
            (diff > atol + rtol * want.abs()).any()):
        raise AssertionError(f"{what}: max abs err {float(diff.max())}")
    return float(diff.max())


def local_small_phase(device):
    import numpy as np

    from distributed_matvec_tpu_torch import LocalEngine, SpinBasis, lanczos
    from distributed_matvec_tpu_torch.models.lattices import (
        chain_edges, heisenberg_chain, heisenberg_from_edges)

    op = heisenberg_chain(16, symmetric=True)
    op.basis.build()
    n = op.basis.number_states
    rng = np.random.default_rng(5)
    x = rng.random(n) - 0.5
    X = rng.random((n, 3)) - 0.5
    ref = op.matvec_host(x)
    REF = np.stack([op.matvec_host(X[:, j]) for j in range(3)], axis=1)
    out = {"n_states": n}
    for mode in ("ell", "compact", "fused"):
        eng = LocalEngine(op, batch_size=61, mode=mode, device=device)
        err = max(assert_close(eng.matvec(x), ref, f"{mode} matvec"),
                  assert_close(eng.matvec(X), REF, f"{mode} [N, 3] matvec"))
        res = lanczos(eng.matvec, n, k=1, device=device)
        e0 = float(res.eigenvalues[0])
        if not (res.converged and abs(e0 / 4 - N16_E0_OVER_4) < 1e-9):
            raise AssertionError(f"{mode}: chain_16_symm E0/4 {e0 / 4} != "
                                 f"{N16_E0_OVER_4}")
        out[mode] = {"matvec_max_abs_err": err, "e0_over_4": e0 / 4,
                     "lanczos_iters": int(res.num_iters),
                     "ell_split": eng.ell_split}
    # a complex sector: momentum k = 1 of the 16-ring
    basis = SpinBasis(16, 8, None, [([*range(1, 16), 0], 1)])
    cop = heisenberg_from_edges(basis, chain_edges(16))
    basis.build()
    nc = basis.number_states
    z = (rng.random(nc) - 0.5) + 1j * (rng.random(nc) - 0.5)
    zref = cop.matvec_host(z)
    for mode in ("ell", "fused"):
        eng = LocalEngine(cop, batch_size=61, mode=mode, device=device)
        if eng.real:
            raise AssertionError("the k = 1 sector is not complex")
        out[f"k1_{mode}_max_abs_err"] = assert_close(
            eng.matvec(z), zref, f"k = 1 {mode} matvec")
    out["k1_n_states"] = nc
    return out


# -- phase 4 ------------------------------------------------------------------

def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def full_phase(device, n=32, expect_states=CHAIN32_STATES,
               expect_e0=CHAIN32_E0, expect_e0_cpu=CHAIN32_E0_CPU,
               applies=7):
    import numpy as np
    import torch

    from distributed_matvec_tpu_torch import DistributedEngine, lanczos
    from distributed_matvec_tpu_torch.models.lattices import heisenberg_chain
    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    # "native" makes the enumeration raise rather than fall back to NumPy
    os.environ["DMT_ENUMERATION_BACKEND"] = "native"
    op = heisenberg_chain(n, symmetric=True)
    t0 = time.perf_counter()
    op.basis.build()
    enum_s = time.perf_counter() - t0
    n_states = int(op.basis.number_states)
    if expect_states is not None and n_states != expect_states:
        raise AssertionError(f"{n_states} representatives, expected "
                             f"{expect_states}")
    t0 = time.perf_counter()
    eng = DistributedEngine(op, device=device)
    engine_s = time.perf_counter() - t0

    # one real plan chunk, kernel vs plain version
    ci = eng.nchunks // 2
    views = eng._chunk_views(eng._plan_host[ci, 0].to(device))
    x_c = torch.from_numpy(np.random.default_rng(9).standard_normal(
        eng.batch_size)).to(device)
    chunk_err = check_kernel((eng._codec.spec, views[0], views[1], views[4],
                              eng._cdict[0], x_c))

    # the main path, with the launch counts set to 0 just before it
    PC.fused_decode_gather_scatter.launches = 0
    eng.n_applies = 0
    xh = eng.random_hashed(1)
    y = eng.matvec(xh)                       # first apply: warm-up
    walls = []
    for _ in range(applies):
        _sync(device)
        t0 = time.perf_counter()
        y = eng.matvec(xh)
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    x2 = eng.random_hashed(2)
    y2 = eng.matvec(x2)
    if not bool(torch.isfinite(y).all()):
        raise AssertionError("non-finite matvec output")
    # H is symmetric: <x2, H x1> = <x1, H x2>
    a, b = float(torch.vdot(x2[0], y[0])), float(torch.vdot(xh[0], y2[0]))
    if abs(a - b) > 1e-12 * max(abs(a), abs(b), 1.0):
        raise AssertionError(f"<x2,Hx1> {a} != <x1,Hx2> {b}")
    t0 = time.perf_counter()
    res = lanczos(eng.matvec, v0=eng.random_hashed(0), k=1, tol=1e-10,
                  device=device)
    _sync(device)
    lanczos_s = time.perf_counter() - t0
    launches = PC.fused_decode_gather_scatter.launches
    n_applies = eng.n_applies

    e0 = float(res.eigenvalues[0])
    if launches == 0 or launches != eng.nchunks * n_applies:
        raise AssertionError(
            f"{launches} decode launches for {n_applies} applies of "
            f"{eng.nchunks} chunks")
    if expect_e0 is not None and abs(e0 - expect_e0) > 1e-8 * abs(
            expect_e0):
        raise AssertionError(f"E0 {e0} != {expect_e0}")
    if expect_e0_cpu is not None and abs(e0 - expect_e0_cpu) > 1e-10:
        raise AssertionError(f"E0 {e0} != the JAX package's {expect_e0_cpu} "
                             "on the CPU")
    info = {"n_states": n_states, "enumeration_s": enum_s,
            "enumeration": "native", "engine_init_s": engine_s,
            "plan_build_s": eng.timings["plan_build_s"],
            "plan_encode_s": eng.timings["plan_encode_s"],
            "plan_bytes_raw": int(eng.plan_bytes_raw),
            "plan_bytes": int(eng.plan_bytes), "nchunks": eng.nchunks,
            "batch_size": eng.batch_size,
            "spec": eng._codec.spec,
            "real_chunk": ci, "real_chunk_max_abs_err": chunk_err,
            "apply_ms": walls, "apply_ms_median": statistics.median(walls),
            "applies": n_applies, "launches": launches,
            "lanczos_iters": int(res.num_iters),
            "lanczos_converged": bool(res.converged),
            "lanczos_s": lanczos_s, "e0": e0}
    return info, eng, launches, chunk_err


# -- phase 5 and the kernels line ---------------------------------------------

def device_ms(device, fn, reps=3):
    """Median device time of ``fn()`` in ms: the stream is first held busy
    (``torch.cuda._sleep``) so the host enqueues the whole of ``fn`` before
    the device reaches the first event, and host launch gaps do not count."""
    import torch

    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize(device)
        torch.cuda._sleep(200_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize(device)
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def split_phase(device, eng):
    """The apply's parts at the full size: plan H2D alone, the apply from a
    device-resident plan, the decode kernel per launch over every chunk of
    the plan beside its plain version and beside the earlier design (one
    thread per entry after a separate zero fill; timed in turns: kernel,
    earlier, earlier, kernel), the zero fill alone and the earlier kernel
    alone, and a ``torch.profiler`` breakdown of one streamed apply."""
    import numpy as np
    import torch

    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    n = eng.nchunks
    spec = eng._codec.spec
    n_recv = spec["n_recv"]
    dev_plan = eng._plan_host.to(device)
    views = [eng._chunk_views(dev_plan[ci, 0]) for ci in range(n)]
    B = eng.batch_size
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        n * B)).to(device)
    args = [(spec, v[0], v[1], v[4], eng._cdict[0], x[ci * B:(ci + 1) * B])
            for ci, v in enumerate(views)]

    def h2d():
        buf = eng._dev_bufs[0]
        for ci in range(n):
            buf.copy_(eng._plan_host[ci], non_blocking=True)

    def kernel():
        for a in args:
            PC.fused_decode_gather_scatter(*a)

    def plain():
        for a in args:
            PC._fused_decode_gather_scatter_plain(*a)

    def zeros():
        return torch.zeros(n_recv + 1, dtype=torch.float64, device=device)

    def fill():
        for _ in range(n):
            zeros()

    def per_entry():                 # as the earlier wrapper ran it
        for a in args:
            per_entry_launch(a[0], a[1], a[2], a[4], a[5], zeros())

    filled = zeros()

    def per_entry_kernel():          # the earlier kernel without its fill
        for a in args:
            per_entry_launch(a[0], a[1], a[2], a[4], a[5], filled)

    xh = eng.random_hashed(3)
    # largest error of the kernel against the plain version over the plan
    err = max(check_kernel(a) for a in args)
    # the earlier design on every chunk too, so its times are of right work
    for a in args:
        out = zeros()
        per_entry_launch(a[0], a[1], a[2], a[4], a[5], out)
        if not torch.equal(out, PC._fused_decode_gather_scatter_plain(*a)):
            raise AssertionError("the per-entry design differs from the "
                                 "plain version")
    bytes_per_launch = decode_bytes(spec, B)
    t_bytes = bytes_per_launch / HBM_BYTES_PER_S * 1e3
    t_ops = spec["n_live"] / FP64_FLOP_PER_S * 1e3
    turns = {"kernel": [], "per_entry": []}
    for name in ("kernel", "per_entry", "per_entry", "kernel"):
        fn = kernel if name == "kernel" else per_entry
        turns[name].append(device_ms(device, fn, reps=5) / n)
    kernel_ms = statistics.median(turns["kernel"])
    timing = {
        "h2d_ms_per_apply": device_ms(device, h2d),
        "device_plan_apply_ms": device_ms(
            device, lambda: eng._apply(xh, [[v] for v in views])),
        "kernel_ms_per_launch": kernel_ms,
        "kernel_ms_turns": turns["kernel"],
        "per_entry_ms_per_launch": statistics.median(turns["per_entry"]),
        "per_entry_ms_turns": turns["per_entry"],
        "fill_ms_per_launch": device_ms(device, fill, reps=5) / n,
        "per_entry_kernel_ms_per_launch":
            device_ms(device, per_entry_kernel, reps=5) / n,
        "plain_ms_per_launch": device_ms(device, plain) / n,
        "bound_ms_per_launch": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_per_launch": bytes_per_launch,
        "kernel_bytes_per_s": bytes_per_launch / (kernel_ms * 1e-3),
        "kernel_share_of_bound": max(t_bytes, t_ops) / kernel_ms,
        "plan_max_abs_err": err,
        "max_memory_allocated": int(torch.cuda.max_memory_allocated(device)),
        "profile": profile_apply(
            lambda: eng._apply(xh, eng._stream_chunks())),
    }
    # the send buffer has no fill of its own: nothing in the apply fills a
    # [n_recv + 1] tensor once per chunk
    fills = [f for f in timing["profile"]["fill_ops"]
             if f[1] and f[1][0] == [n_recv + 1] and f[2] >= n]
    if fills:
        raise AssertionError(f"the send buffer is filled per chunk: {fills}")
    return timing


def decode_bytes(spec, B) -> int:
    """Bytes one decode launch must move: the dest and row word streams,
    the codes, the fill counts, the dictionary and the chunk's x read once,
    the send buffer written once."""
    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    nl = spec["n_live"]
    words = (PC.packed_words(nl, spec["w_dest"])
             + PC.packed_words(nl, spec["w_row"]))
    return (4 * words + nl * spec["code_bits"] // 8 + 4 * spec["D"]
            + 8 * spec["ndict"] + 8 * B + 8 * (spec["n_recv"] + 1))


def profile_apply(fn, top=8):
    """Device time of one apply ``fn()`` by kernel (and host → device
    copy), from ``torch.profiler``: the ``top`` largest as
    ``[name, ms, calls]``, the sum over all of them, every fill kernel's
    row, every ``aten::fill_``/``aten::zero_`` call grouped by the
    shape it filled as ``[op, shapes, calls]``, and the device ms by part
    (host → device copies, ``index_add_`` kernels, the rest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows, fills = [], []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        # aten:: rows repeat the time of the kernels they launch
        if us and not e.key.startswith("aten::"):
            rows.append([e.key[:72], us / 1e3, e.count])
            if "fill" in e.key.lower():
                fills.append(rows[-1])
    rows.sort(key=lambda r: -r[1])
    fill_ops = [[e.key, e.input_shapes, e.count]
                for e in prof.key_averages(group_by_input_shape=True)
                if e.key in ("aten::fill_", "aten::zero_")]
    # the streamed apply's parts: the plan's host → device copy, the
    # receive side's index_add_, and the rest (decode, exchange copy)
    parts = {"h2d_ms": 0.0, "index_add_ms": 0.0, "rest_ms": 0.0}
    for name, ms, _ in rows:
        low = name.lower()
        part = ("h2d_ms" if "htod" in low else "index_add_ms"
                if "indexfunc" in low or "index_add" in low else "rest_ms")
        parts[part] += ms
    return {"device_ms_total": sum(r[1] for r in rows),
            "top": rows[:top], "fill_kernels": fills, "fill_ops": fill_ops,
            "parts": parts}


def cross_sector_phase(device, e0_full, n=32):
    from distributed_matvec_tpu_torch import DistributedEngine, lanczos
    from distributed_matvec_tpu_torch.models.basis import SpinBasis
    from distributed_matvec_tpu_torch.models.lattices import (
        chain_edges, heisenberg_from_edges)

    os.environ["DMT_ENUMERATION_BACKEND"] = "native"
    basis = SpinBasis(n, n // 2, None, [([(i + 1) % n for i in range(n)], 0)])
    t0 = time.perf_counter()
    basis.build()
    enum_s = time.perf_counter() - t0
    op = heisenberg_from_edges(basis, chain_edges(n))
    t0 = time.perf_counter()
    eng = DistributedEngine(op, device=device)
    engine_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = lanczos(eng.matvec, v0=eng.random_hashed(0), k=1, tol=1e-10,
                  device=device)
    _sync(device)
    lanczos_s = time.perf_counter() - t0
    e0 = float(res.eigenvalues[0])
    if not (res.converged and abs(e0 - e0_full) < 1e-9):
        raise AssertionError(f"translation-only E0 {e0} != full-leg E0 "
                             f"{e0_full} (converged {res.converged})")
    return {"n_states": int(basis.number_states), "enumeration_s": enum_s,
            "engine_init_s": engine_s,
            "plan_encode_s": eng.timings["plan_encode_s"],
            "plan_bytes": int(eng.plan_bytes), "nchunks": eng.nchunks,
            "lanczos_iters": int(res.num_iters), "lanczos_s": lanczos_s,
            "e0": e0, "e0_minus_full": e0 - e0_full}


# -- local_full and local_complex ---------------------------------------------

def plain_work(eng, ms, applies_per_solve):
    """Bytes one ell or compact apply must move (each table entry, x, y and
    the diagonal once; compact also gathers the norms and reads 1/n) and
    the byte and operation bounds beside the measured device time."""
    n, n_pad = eng.n_states, eng.n_padded
    T0, S, Tmax = eng.ell_split
    vb = 8 if eng.real else 16
    entry_b = 4 if eng.mode == "compact" else 4 + vb
    entries = n_pad * T0 + S * (Tmax - T0)
    # the tables, the tail rows, x read, y written, the diagonal
    nbytes = entries * entry_b + 4 * S + 2 * n * vb + 8 * n
    if eng.mode == "compact":
        nbytes += 2 * n * 8              # the norms gathered, 1/n read
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    # a multiply and an add per entry: 2 flops real, 8 complex
    t_ops = entries * (2 if eng.real else 8) / FP64_FLOP_PER_S * 1e3
    return {"mode": eng.mode, "dtype": "f64" if eng.real else "c128",
            "T0": T0, "S": S, "Tmax": Tmax, "n_padded": n_pad,
            "entries": entries, "bytes": nbytes, "ms": ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "share_of_bound": max(t_bytes, t_ops) / ms,
            "applies_per_solve": applies_per_solve}


def timed_build(device, make):
    """``make()`` (a ``LocalEngine``) with its seconds, the peak device
    memory it added and its table split and bytes."""
    eng, build_s, peak = build_timed(device, make)
    return eng, {"build_s": build_s, "build_peak_bytes": peak,
                 "ell_split": eng.ell_split, "ell_nbytes": eng.ell_nbytes,
                 "low_memory_build": eng.low_memory_build}


def build_timed(device, make):
    """``make()`` with its seconds and the peak device memory it added
    (None off the card)."""
    import torch

    _sync(device)
    base = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    out = make()
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device) - base
            if device.type == "cuda" else None)
    return out, time.perf_counter() - t0, peak


def apply_times(device, eng, x, applies=7):
    walls = []
    for _ in range(applies):
        _sync(device)
        t0 = time.perf_counter()
        eng.matvec(x)
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"apply_ms_host": walls,
            "apply_ms_host_median": statistics.median(walls),
            "apply_ms_device": device_ms(device, lambda: eng.matvec(x),
                                         reps=applies)}


def local_full_phase(device, streamed, e0_full):
    import numpy as np
    import torch

    from distributed_matvec_tpu_torch import LocalEngine, lanczos

    op = streamed.operator
    n = op.basis.number_states
    T = streamed.num_terms
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(n)).to(
        device)
    y_streamed = streamed.matvec_global(x.cpu().numpy())

    eng, ell = timed_build(device, lambda: LocalEngine(op, device=device))
    if eng.low_memory_build:
        raise AssertionError("chain_32_symm took the low-memory build")
    ell["full_width_bytes"] = eng.n_padded * T * 12
    ell["reckoned_peak_bytes"] = 1.6 * ell["full_width_bytes"]
    y = eng.matvec(x)
    ell["vs_streamed_max_abs_err"] = assert_close(y, y_streamed,
                                                  "ell vs streamed apply")
    ell.update(apply_times(device, eng, x))
    ell["profile"] = profile_apply(lambda: eng.matvec(x))
    t0 = time.perf_counter()
    res = lanczos(eng.matvec, n, k=1, tol=1e-10, device=device)
    _sync(device)
    e0 = float(res.eigenvalues[0])
    ell.update(lanczos_s=time.perf_counter() - t0,
               lanczos_iters=int(res.num_iters), e0=e0,
               e0_minus_streamed=e0 - e0_full)
    if not (res.converged and abs(e0 - CHAIN32_E0) <= 1e-8 * abs(CHAIN32_E0)
            and abs(e0 - e0_full) < 1e-10):
        raise AssertionError(f"ell E0 {e0}: recorded {CHAIN32_E0}, "
                             f"streamed {e0_full}")
    work = [plain_work(eng, ell["apply_ms_device"], int(res.num_iters))]

    # the low-memory build, forced by a budget of the full-width tables'
    # size (below their 1.6× reckoning): the same tables
    budget = ell["full_width_bytes"] / 1e9
    lm, lowmem = timed_build(device, lambda: LocalEngine(
        op, build_budget_gb=budget, device=device))
    if not lm.low_memory_build:
        raise AssertionError(f"a {budget} GB budget did not force the "
                             "low-memory build")
    lowmem["build_budget_gb"] = budget
    a, b = eng.structure_arrays(), lm.structure_arrays()
    if sorted(a) != sorted(b) or not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("low-memory ELL tables differ from one-pass")
    lowmem["equal_to_one_pass"] = sorted(a)
    del lm, a, b

    cmp, compact = timed_build(device, lambda: LocalEngine(
        op, mode="compact", device=device))
    compact["vs_ell_max_abs_err"] = assert_close(cmp.matvec(x), y,
                                                 "compact vs ell apply")
    compact.update(apply_times(device, cmp, x))
    t0 = time.perf_counter()
    res = lanczos(cmp.matvec, n, k=1, tol=1e-10, device=device)
    _sync(device)
    e0c = float(res.eigenvalues[0])
    compact.update(lanczos_s=time.perf_counter() - t0,
                   lanczos_iters=int(res.num_iters), e0=e0c,
                   e0_minus_streamed=e0c - e0_full)
    if not (res.converged and abs(e0c - e0_full) < 1e-10
            and abs(e0c - CHAIN32_E0) <= 1e-8 * abs(CHAIN32_E0)):
        raise AssertionError(f"compact E0 {e0c} != streamed {e0_full}")
    work.append(plain_work(cmp, compact["apply_ms_device"],
                           int(res.num_iters)))
    del cmp

    fused = LocalEngine(op, mode="fused", device=device)
    t0 = time.perf_counter()
    yf = fused.matvec(x)                 # checks the out-of-basis count
    _sync(device)
    fused_info = {"vs_ell_max_abs_err": assert_close(yf, y,
                                                     "fused vs ell apply"),
                  "first_apply_s": time.perf_counter() - t0}
    fused_info.update(apply_times(device, fused, x, applies=1))
    return {"n_states": n, "ell": ell, "lowmem": lowmem, "compact": compact,
            "fused": fused_info, "plain_work": work}, eng


def solve_timed(device, eng, fn):
    """``fn(eng.matvec)`` with its seconds, applies, the seconds inside the
    applies, and the share outside them (the solver's own algebra).  For
    the run, ``eng.matvec`` is a bound wrapper that synchronizes around
    each apply and times it; the solvers still see the engine behind it as
    ``matvec.__self__``."""
    acc = {"apply_s": 0.0, "applies": 0}

    def matvec(self, x, *args, **kwargs):
        _sync(device)
        t0 = time.perf_counter()
        y = type(self).matvec(self, x, *args, **kwargs)
        _sync(device)
        acc["apply_s"] += time.perf_counter() - t0
        acc["applies"] += 1
        return y

    eng.matvec = types.MethodType(matvec, eng)
    try:
        _sync(device)
        t0 = time.perf_counter()
        res = fn(eng.matvec)
        _sync(device)
        sec = time.perf_counter() - t0
    finally:
        del eng.matvec
    return res, {"seconds": sec, "applies": acc["applies"],
                 "apply_seconds": acc["apply_s"],
                 "seconds_per_apply": sec / max(acc["applies"], 1),
                 "share_outside_applies": 1.0 - acc["apply_s"] / sec}


def solvers_phase(device, streamed, eng, e0_full):
    """The eager solvers over ``LocalEngine`` ell at chain_32_symm, and KPM
    through the streamed engine's multi-column apply; see the module
    docstring for the checks."""
    import numpy as np
    import torch

    from distributed_matvec_tpu_torch import (
        kpm_moments, krylov_evolve, lanczos, lanczos_block, lobpcg,
        reconstruct_dos)
    from distributed_matvec_tpu_torch.models.observables import expectations
    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    n = eng.n_states
    out = {"n_states": n}

    rk, out["lanczos_k4"] = solve_timed(device, eng, lambda mv: lanczos(
        mv, n, k=4, tol=1e-10, device=device))
    rb, out["lanczos_block"] = solve_timed(device, eng, lambda mv:
                                           lanczos_block(
        mv, n, k=4, block_size=4, max_iters=800, tol=1e-10, device=device))
    dk = float(np.abs(rb.eigenvalues - rk.eigenvalues).max())
    out["lanczos_block"].update(
        eigenvalues=rb.eigenvalues.tolist(), columns=rb.num_iters,
        max_abs_diff_vs_lanczos_k4=dk,
        e0_minus_full=float(rb.eigenvalues[0]) - e0_full)
    out["lanczos_k4"].update(eigenvalues=rk.eigenvalues.tolist(),
                             iters=rk.num_iters)
    if not (rb.converged and rk.converged and dk < 1e-9
            and abs(rb.eigenvalues[0] - e0_full) < 1e-10):
        raise AssertionError(f"lanczos_block {rb.eigenvalues} vs lanczos "
                             f"{rk.eigenvalues}, full leg E0 {e0_full}")

    rs, out["lanczos_selective"] = solve_timed(
        device, eng, lambda mv: lanczos(mv, n, k=1, tol=1e-12,
                                        reorth="selective", device=device))
    rf, out["lanczos_full"] = solve_timed(
        device, eng, lambda mv: lanczos(mv, n, k=1, tol=1e-12, reorth="full",
                                        compute_eigenvectors=True,
                                        device=device))
    e0 = float(rf.eigenvalues[0])
    for name, r in (("lanczos_selective", rs), ("lanczos_full", rf)):
        out[name].update(e0=float(r.eigenvalues[0]), iters=r.num_iters,
                         full_sweeps=r.full_sweeps)
    if not (rs.converged and rf.converged
            and abs(float(rs.eigenvalues[0]) - e0) < 1e-10):
        raise AssertionError(f"selective E0 {rs.eigenvalues} != full {e0}")

    (ev, _, it), out["lobpcg"] = solve_timed(device, eng, lambda mv: lobpcg(
        mv, n, k=4, tol=1e-15, max_iters=400, device=device))
    out["lobpcg"].update(eigenvalues=ev.tolist(), iters=it,
                         e0_rel_diff=abs(ev[0] - e0) / abs(e0))
    if not abs(ev[0] - e0) < 1e-8 * abs(e0):
        raise AssertionError(f"lobpcg E0 {ev[0]} != lanczos {e0}")

    # KPM: one seeded block of 4 normalized columns, in block order
    V0 = np.random.default_rng(0).standard_normal((n, 4))
    V0 /= np.linalg.norm(V0, axis=0, keepdims=True)
    km, out["kpm_ell"] = solve_timed(device, eng, lambda mv: kpm_moments(
        mv, 256, V0=torch.from_numpy(V0).to(device)))
    energies, rho = reconstruct_dos(km.moments, km.scale)
    mass = float(np.trapezoid(rho, energies))
    out["kpm_ell"].update(bounds=list(km.bounds), dos_mass=mass,
                          moments=256, vectors=4)
    if not (km.bounds[0] < e0 < km.bounds[1] and abs(mass - 1.0) < 0.02):
        raise AssertionError(f"KPM bracket {km.bounds} (E0 {e0}), DOS "
                             f"mass {mass}")

    # ms per apply per column, R = 1 and R = 4, both engines (outside the
    # counted run below)
    x4 = torch.from_numpy(V0).to(device)
    xh4 = streamed.to_hashed(V0)
    per_col = {}
    for name, e, x1, xr, reps in (
            ("ell", eng, x4[:, 0].contiguous(), x4, 5),
            ("streamed", streamed, xh4[..., 0].contiguous(), xh4, 3)):
        ms1 = device_ms(device, lambda: e.matvec(x1), reps=reps)
        ms4 = device_ms(device, lambda: e.matvec(xr), reps=reps)
        per_col[name] = {"r1_ms": ms1, "r4_ms": ms4,
                         "r4_ms_per_column": ms4 / 4,
                         "r4_over_r1_per_column": ms4 / 4 / ms1}
    per_col["ell"]["r4_profile"] = profile_apply(lambda: eng.matvec(x4))
    out["ms_per_apply"] = per_col

    # the streamed [1, M, 4] path, launch counts set to 0 just before it
    PC.fused_decode_gather_scatter.launches = 0
    streamed.n_applies = 0
    ks, out["kpm_streamed"] = solve_timed(
        device, streamed, lambda mv: kpm_moments(mv, 128, V0=xh4,
                                                 bounds=km.bounds))
    launches = PC.fused_decode_gather_scatter.launches
    dmu = float(np.abs(ks.moments - km.moments[:128]).max())
    out["kpm_streamed"].update(moments=128, vectors=4, launches=launches,
                               max_abs_diff_vs_ell=dmu)
    if not (dmu < 1e-10 and streamed.n_applies == 64
            and launches == streamed.nchunks * 4 * streamed.n_applies):
        raise AssertionError(
            f"streamed moments differ by {dmu}, or {launches} launches for "
            f"{streamed.n_applies} applies of {streamed.nchunks} chunks")

    psi0 = rf.eigenvectors[0]
    evo, out["krylov_evolve"] = solve_timed(device, eng, lambda mv:
                                            krylov_evolve(
        mv, psi0=psi0, t_final=1.0, device=device))
    want = np.exp(-1j * e0) * psi0.to(torch.complex128)
    err = float(torch.linalg.vector_norm(evo.psi - want))
    out["krylov_evolve"].update(steps=evo.num_steps, norm_drift=evo.norm_drift,
                                energy_drift=evo.energy_drift,
                                err_vs_phase=err)
    if not (err < 1e-9 and evo.norm_drift < 1e-10
            and abs(evo.times[-1] - 1.0) < 1e-12):
        raise AssertionError(f"evolved ground state off by {err}, norm "
                             f"drift {evo.norm_drift}")

    t0 = time.perf_counter()
    [(_, val)] = expectations([eng.operator], eng, psi0)
    out["expectations"] = {"seconds": time.perf_counter() - t0,
                           "value": val, "minus_e0": val - e0}
    if not abs(val - e0) < 1e-9:
        raise AssertionError(f"<H> {val} != E0 {e0}")
    return out, launches


#: the sharded leg: shards on the one card, and the row chunk that keeps a
#: chunk's ~85 k live entries per bucket under the 150 000 default (the
#: default B = 65 536 would put ~339 k in each and overflow)
SHARDS = 4
SHARDED_BATCH = 16384


def sharded_phase(device, op, ell_ref, e0_full, expect_e0=CHAIN32_E0,
                  D=SHARDS, B=SHARDED_BATCH, applies=7):
    """``DistributedEngine(op, n_devices=D, mode=m)`` in every ported mode
    on the one card; see the module docstring for the checks."""
    import numpy as np
    import torch

    from distributed_matvec_tpu_torch import DistributedEngine, lanczos
    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    n = op.basis.number_states
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(n)).to(
        device)
    y_ref = ell_ref.matvec(x)
    x_np = x.cpu().numpy()
    out = {"n_states": n, "n_shards": D, "batch_size": B}
    kernel = {"engines": {}}
    for mode in ("streamed", "ell", "compact", "fused"):
        eng, build_s, peak = build_timed(device, lambda: DistributedEngine(
            op, n_devices=D, mode=mode, batch_size=B, device=device))
        info = {"build_s": build_s, "build_peak_bytes": peak,
                "timings": eng.timings, "shard_size": eng.shard_size,
                "counts": [int(c) for c in eng.counts]}
        if mode == "streamed":
            info.update(plan_bytes=int(eng.plan_bytes),
                        plan_bytes_raw=int(eng.plan_bytes_raw),
                        nchunks=eng.nchunks, spec=eng._codec.spec)
            kernel.update(sharded_kernel_check(device, eng))
        elif mode in ("ell", "compact"):
            info.update(table_bytes=eng.ell_nbytes,
                        ell_split=eng.ell_split,
                        query_capacity=eng.query_capacity)
        if mode == "streamed":
            PC.fused_decode_gather_scatter.launches = 0
            eng.n_applies = 0
        t0 = time.perf_counter()
        y = torch.from_numpy(eng.matvec_global(x_np)).to(device)
        _sync(device)
        info["first_apply_s"] = time.perf_counter() - t0
        info["vs_local_ell_max_abs_err"] = assert_close(
            y, y_ref, f"D = {D} {mode} vs LocalEngine ell apply")
        xh = eng.to_hashed(x_np)
        if mode == "fused":
            info.update(apply_times(device, eng, xh, applies=1))
        else:
            info.update(apply_times(device, eng, xh, applies=applies))
        if mode in ("streamed", "ell") and device.type == "cuda":
            info["profile"] = profile_apply(lambda: eng.matvec(xh))
        if mode in ("streamed", "ell"):
            t0 = time.perf_counter()
            res = lanczos(eng.matvec, v0=eng.random_hashed(0), k=1,
                          tol=1e-10, device=device)
            _sync(device)
            e0 = float(res.eigenvalues[0])
            info.update(lanczos_s=time.perf_counter() - t0,
                        lanczos_iters=int(res.num_iters), e0=e0,
                        e0_minus_full=e0 - e0_full)
            if not (res.converged and abs(e0 - e0_full) < 1e-10
                    and (expect_e0 is None or abs(e0 - expect_e0)
                         <= 1e-8 * abs(expect_e0))):
                raise AssertionError(f"D = {D} {mode} E0 {e0}: full leg "
                                     f"{e0_full}, recorded {expect_e0}")
        if mode == "streamed":
            launches = PC.fused_decode_gather_scatter.launches
            per_apply = D * eng.nchunks
            if launches == 0 or launches != per_apply * eng.n_applies:
                raise AssertionError(
                    f"{launches} decode launches for {eng.n_applies} "
                    f"applies of {D} × {eng.nchunks} chunks")
            info.update(applies=eng.n_applies, launches=launches,
                        launches_per_apply=per_apply)
            kernel["launches"] = launches
        out[mode] = info
        if mode in ("streamed", "fused"):
            # the pipeline phase switches these engines' depths
            kernel["engines"][mode] = eng
        del eng
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out, kernel


def sharded_kernel_check(device, eng):
    """The decode kernel on real D-shard chunks: every chunk of shard 0 and
    the middle chunk of every shard against the plain version
    (``torch.equal``, also into a NaN-filled buffer), then its time per
    launch over every (chunk, shard) of the plan from a device-resident
    copy, beside the byte bound and the plain version's time."""
    import numpy as np
    import torch

    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    D, B, n = eng.n_devices, eng.batch_size, eng.nchunks
    spec = eng._codec.spec
    dev_plan = eng._plan_host.to(device)
    x = torch.from_numpy(np.random.default_rng(21).standard_normal(
        (D, n * B))).to(device)

    def args(ci, d):
        v = eng._chunk_views(dev_plan[ci, d])
        return (spec, v[0], v[1], v[4], eng._cdict[d],
                x[d, ci * B:(ci + 1) * B])

    pairs = [(ci, 0) for ci in range(n)] + [(n // 2, d)
                                            for d in range(1, D)]
    err = max(check_kernel(args(ci, d)) for ci, d in pairs)
    every = [args(ci, d) for ci in range(n) for d in range(D)]

    def kernel():
        for a in every:
            PC.fused_decode_gather_scatter(*a)

    def plain():
        for a in every:
            PC._fused_decode_gather_scatter_plain(*a)

    nbytes = decode_bytes(spec, B)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = spec["n_live"] / FP64_FLOP_PER_S * 1e3
    ms = device_ms(device, kernel, reps=5) / len(every)
    del dev_plan
    return {"checked_chunks": len(pairs), "max_abs_err": err,
            "ms": ms, "plain_ms": device_ms(device, plain) / len(every),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_per_launch": nbytes, "share_of_bound":
                max(t_bytes, t_ops) / ms}


# -- phase 10: pipeline --------------------------------------------------------

#: the full leg's engine at these depths, the D = 4 engines at the first
#: depth beside 0
PIPE_DEPTHS = (2, 4)


def deterministic(fn):
    """``fn()`` under ``torch.use_deterministic_algorithms``: the card's
    ``index_add_`` then sums in one order, so two schedules of the same
    work give the same bits."""
    import torch

    torch.use_deterministic_algorithms(True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(False)


def kernel_held_at(call):
    """A stand-in for the decode wrapper that launches the kernel through
    it as always and, on its ``call``-th call, holds that launch's output
    against the plain version on the same inputs.  Returns (stand-in,
    list the largest differences go into)."""
    import torch

    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    kernel = PC.fused_decode_gather_scatter
    seen, errs = [0], []

    def held(spec, edest, ecodes, fill, cdict, x_c, out=None):
        # the wrapper counts its launch on the module's name for it
        PC.fused_decode_gather_scatter = kernel
        try:
            got = kernel(spec, edest, ecodes, fill, cdict, x_c, out=out)
        finally:
            PC.fused_decode_gather_scatter = held
        if seen[0] == call:
            want = PC._fused_decode_gather_scatter_plain(
                spec, edest, ecodes, fill, cdict, x_c)
            errs.append(float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(
                    f"decode launch {call} of a pipelined apply differs "
                    f"from the plain version by {errs[-1]}")
        seen[0] += 1
        return got

    return held, errs


def pipeline_timing(device, eng, xh, applies=7):
    """``apply_times`` at the engine's current depth, with the depth it
    reports and the last apply's ``last_pipeline`` record."""
    info = apply_times(device, eng, xh, applies=applies)
    info.update(depth=eng.pipeline_depth, last_pipeline=eng.last_pipeline)
    return info


def pipeline_phase(device, full_eng, sharded_engs):
    """``pipeline_depth`` on engines already built: the full leg's D = 1
    streamed engine at depths 0, 2 and 4, the sharded leg's D = 4 streamed
    engine at 0 and 2, and one D = 4 fused apply at 0 and at 2.  Every
    pipelined streamed apply must equal its engine's depth-0 apply bit for
    bit (both under deterministic algorithms); the fused apply at depth 2
    must equal depth 0 within atol 1e-13 / rtol 1e-12 (the card's atomic
    ``index_add_``: a deterministic fused apply takes ≈ 30 s here, so the
    card tests hold fused bit for bit at chain_16_symm); the decode kernel
    is held against its plain version on one chunk of a depth-2 apply; a
    ``[1, M, 6]`` streamed apply at depth 2 must equal its two column
    groups (4 + 2); then the streamed applies are timed at each depth
    (median of 7, host wall and device), the pipelined ones with the
    launch counts set to 0 just before and read just after: one per plan
    chunk per shard per apply."""
    import numpy as np
    import torch

    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    s4, f4 = sharded_engs["streamed"], sharded_engs["fused"]
    out = {"note": "D = 4 is four shards on one card, in one process"}
    x1 = full_eng.random_hashed(17)
    x4 = s4.random_hashed(17)

    # bit for bit against depth 0
    checks = {}
    for name, eng, xh, depths in (("d1_streamed", full_eng, x1, PIPE_DEPTHS),
                                  ("d4_streamed", s4, x4, PIPE_DEPTHS[:1])):
        eng.pipeline_depth = 0
        t0 = time.perf_counter()
        y0 = deterministic(lambda: eng.matvec(xh))
        _sync(device)
        seconds = {0: time.perf_counter() - t0}
        reported = {}
        for depth in depths:
            eng.pipeline_depth = depth
            reported[depth] = eng.pipeline_depth
            t0 = time.perf_counter()
            y = deterministic(lambda: eng.matvec(xh))
            _sync(device)
            seconds[depth] = time.perf_counter() - t0
            if not torch.equal(y, y0):
                raise AssertionError(
                    f"{name} at depth {depth} differs from depth 0: max "
                    f"abs err {float((y - y0).abs().max())}")
        checks[name] = {"reported_depth": reported,
                        "bit_equal_to_depth_0": list(depths),
                        "deterministic_apply_s": seconds}
        del y0, y
    out["checks"] = checks

    # the kernel against its plain version inside a depth-2 apply
    full_eng.pipeline_depth = 2
    held, errs = kernel_held_at(full_eng.nchunks // 2)
    PC.fused_decode_gather_scatter, kernel = held, \
        PC.fused_decode_gather_scatter
    try:
        full_eng.matvec(x1)
        _sync(device)
    finally:
        PC.fused_decode_gather_scatter = kernel
    if len(errs) != 1:
        raise AssertionError("the held decode launch did not run")
    out["kernel_max_abs_err"] = errs[0]

    # a 6-column block at depth 2: two column groups, each streaming the
    # plan (both schedules, and R = 3 + 3, are held on the CPU)
    X6 = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (1, full_eng.shard_size, 6))).to(device)
    y6 = deterministic(lambda: full_eng.matvec(X6))
    parts = deterministic(lambda: torch.cat(
        [full_eng.matvec(X6[..., :4].contiguous()),
         full_eng.matvec(X6[..., 4:].contiguous())], dim=2))
    if not torch.equal(y6, parts):
        raise AssertionError("R = 6 at depth 2 differs from its column "
                             "groups")
    out["r6_equals_column_groups_at_depth"] = full_eng.pipeline_depth
    del X6, y6, parts

    # timing: depth 0 first (not counted), then the pipelined applies with
    # the counts set to 0 just before them
    timing = {"d1_streamed": {}, "d4_streamed": {}, "d4_fused": {}}
    for name, eng, xh in (("d1_streamed", full_eng, x1),
                          ("d4_streamed", s4, x4)):
        eng.pipeline_depth = 0
        timing[name][0] = pipeline_timing(device, eng, xh)
    PC.fused_decode_gather_scatter.launches = 0
    expect = 0
    for name, eng, xh, depths in (("d1_streamed", full_eng, x1, PIPE_DEPTHS),
                                  ("d4_streamed", s4, x4, PIPE_DEPTHS[:1])):
        for depth in depths:
            eng.pipeline_depth = depth
            eng.n_applies = 0
            timing[name][depth] = pipeline_timing(device, eng, xh)
            expect += eng.n_applies * eng.nchunks * eng.n_devices
    launches = PC.fused_decode_gather_scatter.launches
    if device.type == "cuda" and (launches == 0 or launches != expect):
        raise AssertionError(f"{launches} decode launches in the pipelined "
                             f"applies, expected {expect}")
    # one fused apply at each depth, timed, the second against the first
    yf = {}
    for depth in (0, 2):
        f4.pipeline_depth = depth
        _sync(device)
        t0 = time.perf_counter()
        yf[depth] = f4.matvec(x4)
        _sync(device)
        timing["d4_fused"][depth] = {
            "apply_ms_host": (time.perf_counter() - t0) * 1e3,
            "depth": f4.pipeline_depth, "last_pipeline": f4.last_pipeline}
    out["checks"]["d4_fused"] = {
        "reported_depth": {2: timing["d4_fused"][2]["depth"]},
        "vs_depth_0_max_abs_err": assert_close(
            yf[2], yf[0], "D = 4 fused at depth 2 vs depth 0")}
    del yf
    out["timing"] = timing
    out["launches"] = launches
    for eng in (full_eng, s4, f4):
        eng.pipeline_depth = 0
    return out, launches


# -- phase 13: tiers -------------------------------------------------------------

#: the quantized tiers' documented bounds on an apply's largest error
#: relative to the largest lossless value (tests/test_plan_codec.py)
TIER_BOUNDS = {"f32": 1e-6, "bf16": 1e-2}


def release(device) -> None:
    """Collect what the caller dropped (an engine: its pinned plan goes
    back to torch's host cache) and return the device memory."""
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def send_buffer(eng, ci, x_c):
    """Chunk ci's send buffer of a D = 1 streamed or hybrid engine,
    ``[n_recv]``, from a device copy of its record: the decode kernel's
    output on the ``cuda`` path, the torch decode (and, in hybrid mode,
    the recompute side) otherwise."""
    import torch

    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    spec = eng._codec.spec
    views = eng._chunk_views(eng._plan_host[ci, 0].to(eng.device))
    if eng.stream_kernel == "cuda":
        out = PC.fused_decode_gather_scatter(spec, views[0], views[1],
                                             views[4], eng._cdict[0], x_c)
        return out[:spec["n_recv"]]
    send = torch.empty((spec["n_recv"] + 1, 1), dtype=x_c.dtype,
                       device=x_c.device)
    eng._decode_send(send, views, 0, ci, x_c[:, None])
    return send[:spec["n_recv"], 0]


def tiers_phase(device, full_eng, e0_full):
    """The streamed engine's other tiers and forms on the full leg's
    operator, against its lossless D = 1 engine; see the module
    docstring."""
    import numpy as np
    import torch

    from distributed_matvec_tpu_torch import DistributedEngine, lanczos
    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    op = full_eng.operator
    xh = full_eng.random_hashed(19)
    y_ref = deterministic(lambda: full_eng.matvec(xh))
    ref_scale = float(y_ref.abs().max())
    ci = full_eng.nchunks // 2
    x_c = xh[0, ci * full_eng.batch_size:(ci + 1) * full_eng.batch_size]
    send_ref = send_buffer(full_eng, ci, x_c)
    out = {"n_states": int(op.basis.number_states),
           "reference": "the full leg's lossless D = 1 engine",
           "lossless_plan_bytes": int(full_eng.plan_bytes)}

    def build(**kw):
        eng, build_s, peak = build_timed(device, lambda: DistributedEngine(
            op, batch_size=full_eng.batch_size, device=device, **kw))
        return eng, {"build_s": build_s, "build_peak_bytes": peak,
                     "timings": eng.timings, "spec": eng._codec.spec,
                     "plan_bytes": int(eng.plan_bytes),
                     "plan_bytes_raw": int(eng.plan_bytes_raw),
                     "stream_kernel": eng.stream_kernel}

    def bit_equal(eng, what, depths=(0,)):
        """The engine's apply, counted from 0, against the reference bit
        for bit (deterministic) at each depth; no decode launch."""
        PC.fused_decode_gather_scatter.launches = 0
        for depth in depths:
            eng.pipeline_depth = depth
            y = deterministic(lambda: eng.matvec(xh))
            if not torch.equal(y, y_ref):
                raise AssertionError(
                    f"{what} at depth {depth} differs from the lossless "
                    f"apply: max abs err {float((y - y_ref).abs().max())}")
        eng.pipeline_depth = 0
        if eng.stream_kernel != "torch" \
                or PC.fused_decode_gather_scatter.launches:
            raise AssertionError(
                f"{what}: decode path {eng.stream_kernel}, "
                f"{PC.fused_decode_gather_scatter.launches} kernel launches")
        return list(depths)

    # off: the raw layout
    eng, info = build(stream_compress="off")
    info["bit_equal_at_depth"] = bit_equal(eng, "off")
    info.update(apply_times(device, eng, xh, applies=3))
    out["off"] = info
    del eng
    release(device)

    # f32 and bf16: the unchanged kernel on quantized dictionaries
    launches = 0
    for tier in ("f32", "bf16"):
        eng, info = build(stream_compress=tier)
        if eng.stream_kernel != "cuda" or eng._codec.spec["coeff"] != "dict":
            raise AssertionError(f"{tier}: decode path {eng.stream_kernel}, "
                                 f"coeff {eng._codec.spec['coeff']}")
        views = eng._chunk_views(eng._plan_host[ci, 0].to(device))
        info["chunk_max_abs_err"] = check_kernel(
            (eng._codec.spec, views[0], views[1], views[4], eng._cdict[0],
             x_c))
        del views
        PC.fused_decode_gather_scatter.launches = 0
        eng.n_applies = 0
        y = eng.matvec(xh)
        rel = float((y - y_ref).abs().max()) / ref_scale
        t0 = time.perf_counter()
        res = lanczos(eng.matvec, v0=eng.random_hashed(0), k=1, tol=1e-10,
                      device=device)
        _sync(device)
        n = PC.fused_decode_gather_scatter.launches
        if device.type == "cuda" and (
                n == 0 or n != eng.nchunks * eng.n_applies):
            raise AssertionError(f"{tier}: {n} decode launches for "
                                 f"{eng.n_applies} applies of "
                                 f"{eng.nchunks} chunks")
        if not rel <= TIER_BOUNDS[tier]:
            raise AssertionError(f"{tier}: relative apply error {rel} above "
                                 f"{TIER_BOUNDS[tier]}")
        launches += n
        e0 = float(res.eigenvalues[0])
        info.update(rel_err_vs_lossless=rel, bound=TIER_BOUNDS[tier],
                    launches=n, applies=eng.n_applies,
                    lanczos_s=time.perf_counter() - t0,
                    lanczos_iters=int(res.num_iters), e0=e0,
                    e0_lossless=e0_full, e0_minus_lossless=e0 - e0_full)
        info.update(apply_times(device, eng, xh, applies=3))
        out[tier] = info
        del eng, y, res
        release(device)
    out["launches"] = launches
    out["kernel_max_abs_err"] = max(out[t]["chunk_max_abs_err"]
                                    for t in ("f32", "bf16"))

    # raw coefficient streams: the dictionary ceiling lowered for a build
    saved = PC.DICT_MAX
    PC.DICT_MAX = 8
    try:
        eng, info = build()
    finally:
        PC.DICT_MAX = saved
    if eng._codec.spec["coeff"] != "raw":
        raise AssertionError("DICT_MAX = 8 left a dictionary")
    info["dict_max"] = 8
    info["bit_equal_at_depth"] = bit_equal(eng, "raw coefficients")
    info.update(apply_times(device, eng, xh, applies=3))
    out["raw_coeff"] = info
    del eng
    release(device)

    # hybrid: the send buffer and the apply bit for bit
    even = "stream:" + ",".join(map(str, range(0, full_eng.num_terms, 2)))
    out["hybrid"] = {}
    for split in ("all-stream", even, "all-recompute"):
        eng, info = build(mode="hybrid", hybrid_split=split)
        send = send_buffer(eng, ci, x_c)
        if not torch.equal(send, send_ref):
            raise AssertionError(
                f"hybrid {split}: chunk {ci}'s send buffer differs from the "
                f"streamed one by {float((send - send_ref).abs().max())}")
        del send
        info.update(hybrid_split=split,
                    hybrid_stream_fraction=eng.hybrid_stream_fraction,
                    send_buffer_bit_equal_chunk=ci,
                    bit_equal_at_depth=bit_equal(eng, f"hybrid {split}",
                                                 depths=(0, 2)))
        # a recompute apply costs seconds: one timed apply of each split
        # that recomputes
        info.update(apply_times(device, eng, xh, applies=3 if split
                                == "all-stream" else 1))
        out["hybrid"][split] = info
        del eng
        release(device)
    return out, launches


# -- phase 11: ranks ------------------------------------------------------------

#: the ranks leg: two ranks sharing the one card over gloo, each holding one
#: hash shard.  The row chunk is the full leg's; at two shards a chunk puts
#: ≈ 680 k live entries in each bucket, so the buckets hold 2²¹ (the
#: default 150 000 would overflow at any B ≥ 16 384)
RANKS = 2
RANKS_BATCH = 1 << 16
RANKS_REMOTE_BUFFER = 1 << 21
#: seconds a collective may wait, and the ranks may take in all
RANKS_COLLECTIVE_TIMEOUT_S = 300
RANKS_JOIN_TIMEOUT_S = 480
RANKS_APPLIES = 3


def rank_apply_times(device, eng, xh, applies=RANKS_APPLIES):
    """``applies`` applies on every rank together: host wall clock between
    synchronizations, the CUDA-event time between the apply's first and
    last work (the gaps a host-staged exchange leaves included), the bytes
    this rank put into the exchange per apply, and at a pipeline depth the
    host ms each apply spent waiting in its retires."""
    import torch

    walls, events, barrier = [], [], []
    b0 = eng.exchange_bytes
    for _ in range(applies):
        _sync(device)
        t0 = time.perf_counter()
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        eng.matvec(xh)
        if device.type == "cuda":
            e1.record()
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
        if device.type == "cuda":
            events.append(e0.elapsed_time(e1))
        if eng.last_pipeline is not None:
            barrier.append(eng.last_pipeline["barrier_ms"])
    return {"depth": eng.pipeline_depth, "barrier_ms": barrier,
            "apply_ms_host": walls,
            "apply_ms_host_median": statistics.median(walls),
            "apply_ms_device": events,
            "apply_ms_device_median": statistics.median(events)
            if events else None,
            "exchange_bytes_per_apply": (eng.exchange_bytes - b0) / applies}


def exchange_ms(device, group, shape, calls, reps=3, staged=False):
    """Host ms of ``calls`` exchanges of a float64 send block ``shape``
    (one apply's worth), median of ``reps``, each ``exchange`` or (with
    ``staged``) ``exchange_staged``; collective."""
    import torch

    send = torch.zeros(shape, dtype=torch.float64, device=device)
    exchange = group.exchange_staged if staged else group.exchange
    exchange(send)
    times = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(calls):
            exchange(send)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


#: the dtypes checked through a group's collectives on the card (int16 is
#: the u16 code streams' dtype; bool and complex travel as uint8 and
#: ``view_as_real``)
WIRE_DTYPES = ("int16", "bool", "int32", "int64", "float64", "complex128")


def wire_check(group, device):
    """Every ``WIRE_DTYPES`` dtype through the group's exchange, its
    variable-size exchange and its all-gather, on ``device``: each must
    come back in its own dtype, on its device, with its values.  Returns
    the dtypes checked; collective."""
    import torch

    W, r = group.world_size, group.rank

    def block(src, dst, name):
        v = torch.arange(3, dtype=torch.int64, device=device) \
            + 100 * src + 10 * dst
        if name == "bool":
            return v % 3 == 0
        if name == "complex128":
            return v.to(torch.complex128) * (1 - 2j)
        return v.to(getattr(torch, name))

    for name in WIRE_DTYPES:
        pairs = [(group.exchange(torch.stack([block(r, p, name)
                                              for p in range(W)])),
                  torch.stack([block(s, r, name) for s in range(W)])),
                 (group.all_gather(block(r, r, name)),
                  torch.stack([block(s, s, name) for s in range(W)])),
                 (torch.cat(group.exchange_lists(
                     [block(r, p, name)[:p + 1] for p in range(W)])),
                  torch.cat([block(s, r, name)[:r + 1]
                             for s in range(W)]))]
        for got, want in pairs:
            if (got.dtype != want.dtype or got.device != want.device
                    or not torch.equal(got, want)):
                raise AssertionError(f"{group.backend} {name}: got "
                                     f"{got.dtype} {got.tolist()}, want "
                                     f"{want.tolist()}")
    return list(WIRE_DTYPES)


def gloo_cuda_probe(device):
    """Whether this torch's gloo runs ``all_to_all_single`` on CUDA tensors
    itself, tried on a group of its own with a short timeout.  Reported
    only: the engine's gloo branch stages CUDA tensors through pinned host
    memory either way.  (gloo's ``isend``/``irecv``, the staged exchange's
    rounds, are not probed: on CUDA tensors they abort the process —
    ``gloo::IoException`` "writev … Bad address" on the card's torch.)"""
    import datetime

    import torch
    import torch.distributed as dist

    if device.type != "cuda":
        return "not a CUDA rank"
    pg = dist.new_group(backend="gloo",
                        timeout=datetime.timedelta(seconds=60))
    w = dist.get_world_size()
    send = torch.arange(2 * w, dtype=torch.float64, device=device)
    recv = torch.empty_like(send)
    try:
        dist.all_to_all_single(recv, send, group=pg)
        _sync(device)
        ok = torch.equal(recv.cpu(), torch.cat(
            [torch.arange(2 * dist.get_rank(), 2 * dist.get_rank() + 2,
                          dtype=torch.float64)] * w))
        return "accepted" if ok else "accepted, wrong values"
    except RuntimeError as e:
        return f"refused: {str(e).splitlines()[0][:160]}"


def rank_worker(rank, backend, world, tmp, n, batch, remote_buffer,
                device_type):
    """One rank of the ranks leg: chain_n_symm built here, then ``ell``
    (build, apply, Lanczos, ``lanczos_block`` and ``lobpcg``) and
    ``streamed`` (build, the decode kernel on this rank's chunks against
    its plain version, 3 counted and timed applies at depth 0, the apply at
    depth 2 bit-equal to depth 0, 3 counted and timed applies at depth 2),
    each apply gathered and saved by rank 0.  Writes ``rank{rank}.json``
    into ``tmp``."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    os.environ["DMT_ENUMERATION_BACKEND"] = "native"
    from distributed_matvec_tpu_torch import (DistributedEngine, lanczos,
                                              lanczos_block, lobpcg)
    from distributed_matvec_tpu_torch.models.lattices import heisenberg_chain
    from distributed_matvec_tpu_torch.ops import plan_codec as PC
    from distributed_matvec_tpu_torch.parallel.mesh import init_distributed

    device = torch.device("cpu") if device_type == "cpu" else \
        torch.device("cuda", 0 if backend == "gloo" else rank)
    g = init_distributed(backend, f"file://{tmp}/rendezvous_{backend}",
                         world, rank, device=device,
                         timeout_s=RANKS_COLLECTIVE_TIMEOUT_S)
    out = {"rank": rank, "backend": backend, "device": str(g.device),
           "host_staged": g.stages_host}
    if backend == "gloo":
        out["gloo_takes_cuda_tensors"] = gloo_cuda_probe(device)
    out["wire_dtypes_checked"] = wire_check(g, device)
    op = heisenberg_chain(n, symmetric=True)
    t0 = time.perf_counter()
    op.basis.build()
    out["enumeration_s"] = time.perf_counter() - t0
    N = op.basis.number_states
    x = np.random.default_rng(13).standard_normal(N)

    # ell: build, apply (gathered), timed applies, Lanczos
    eng, build_s, peak = build_timed(device, lambda: DistributedEngine(
        op, mode="ell", group=g))
    xh = eng.to_hashed(x)
    y = eng.from_hashed(eng.matvec(xh))
    if rank == 0:
        np.save(os.path.join(tmp, f"y_ell_{backend}.npy"), y)
    info = {"build_s": build_s, "build_peak_bytes": peak,
            "table_bytes": eng.ell_nbytes, "ell_split": eng.ell_split,
            "query_capacity": eng.query_capacity,
            "shard_size": eng.shard_size, "count": int(eng.counts[rank])}
    info.update(rank_apply_times(device, eng, xh))
    info["exchange_ms_per_apply"] = exchange_ms(
        device, g, (world, eng.query_capacity, 1), 1)
    t0 = time.perf_counter()
    res = lanczos(eng.matvec, v0=eng.random_hashed(0), k=1, tol=1e-10)
    _sync(device)
    info.update(lanczos_s=time.perf_counter() - t0,
                lanczos_iters=int(res.num_iters),
                lanczos_converged=bool(res.converged),
                e0=float(res.eigenvalues[0]))
    # the block solvers, as the solvers phase runs them on one process
    for name, solve in (
            ("lanczos_block", lambda mv: lanczos_block(
                mv, k=4, block_size=4, max_iters=800, tol=1e-10)),
            ("lobpcg", lambda mv: lobpcg(mv, N, k=4, tol=1e-15,
                                         max_iters=400))):
        before = dict(g.collectives)
        r, st = solve_timed(device, eng, solve)
        st["collectives"] = {k: v - before.get(k, 0)
                             for k, v in g.collectives.items()}
        if name == "lanczos_block":
            st.update(eigenvalues=r.eigenvalues.tolist(),
                      columns=r.num_iters, converged=bool(r.converged))
        else:
            st.update(eigenvalues=r[0].tolist(), iters=r[2])
        info[name] = st
        del r
    out["ell"] = info
    del eng, res
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # streamed: build, the kernel on this rank's chunks, counted applies
    eng, build_s, peak = build_timed(device, lambda: DistributedEngine(
        op, mode="streamed", batch_size=batch,
        remote_buffer_size=remote_buffer, group=g))
    spec = eng._codec.spec
    info = {"build_s": build_s, "build_peak_bytes": peak,
            "timings": eng.timings, "plan_bytes": int(eng.plan_bytes),
            "nchunks": eng.nchunks, "batch_size": eng.batch_size,
            "spec": spec}
    if device.type == "cuda":
        B = eng.batch_size
        xc = torch.from_numpy(np.random.default_rng(21 + rank)
                              .standard_normal(eng.nchunks * B)).to(device)
        checked = sorted({0, eng.nchunks // 2, eng.nchunks - 1})
        errs = []
        for ci in checked:
            v = eng._chunk_views(eng._plan_host[ci, 0].to(device))
            errs.append(check_kernel((spec, v[0], v[1], v[4], eng._cdict[0],
                                      xc[ci * B:(ci + 1) * B])))
        info.update(kernel_checked_chunks=checked,
                    kernel_max_abs_err=max(errs))
    xh = eng.to_hashed(x)
    PC.fused_decode_gather_scatter.launches = 0
    eng.n_applies = 0
    y = eng.from_hashed(eng.matvec(xh))
    info.update(rank_apply_times(device, eng, xh))
    launches = PC.fused_decode_gather_scatter.launches
    if device.type == "cuda" and launches != eng.nchunks * eng.n_applies:
        raise AssertionError(f"rank {rank}: {launches} decode launches for "
                             f"{eng.n_applies} applies of {eng.nchunks} "
                             "chunks")
    info.update(applies=eng.n_applies, launches=launches,
                exchange_ms_per_apply=exchange_ms(
                    device, g, (world, spec["cap_eff"], 1), eng.nchunks))
    # depth 2: bit-equal to depth 0 (not counted), then counted and timed
    y0 = deterministic(lambda: eng.matvec(xh))
    eng.pipeline_depth = 2
    y2 = deterministic(lambda: eng.matvec(xh))
    if not torch.equal(y0, y2):
        raise AssertionError(f"rank {rank}: the depth-2 streamed apply "
                             "differs from depth 0")
    del y0, y2
    PC.fused_decode_gather_scatter.launches = 0
    eng.n_applies = 0
    pipe = rank_apply_times(device, eng, xh)
    launches2 = PC.fused_decode_gather_scatter.launches
    if device.type == "cuda" and launches2 != eng.nchunks * eng.n_applies:
        raise AssertionError(f"rank {rank}: {launches2} decode launches for "
                             f"{eng.n_applies} depth-2 applies of "
                             f"{eng.nchunks} chunks")
    pipe.update(applies=eng.n_applies, launches=launches2,
                bit_equal_to_depth_0=True,
                exchange_ms_per_apply=exchange_ms(
                    device, g, (world, spec["cap_eff"], 1), eng.nchunks,
                    staged=True))
    info["depth2"] = pipe
    info["launches"] = launches + launches2
    if rank == 0:
        np.save(os.path.join(tmp, f"y_streamed_{backend}.npy"), y)
    out["streamed"] = info
    with open(os.path.join(tmp, f"rank{rank}_{backend}.json"), "w") as fh:
        json.dump(out, fh)
    import torch.distributed as dist

    dist.destroy_process_group()


def spawn_ranks(backend, world, tmp, n, device_type="cuda"):
    """Run ``rank_worker`` in ``world`` spawned processes; returns their
    outputs in rank order.  A rank that fails, or that has not finished
    within ``RANKS_JOIN_TIMEOUT_S``, fails the leg (the others are
    killed)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        rank_worker, args=(backend, world, tmp, n, RANKS_BATCH,
                           RANKS_REMOTE_BUFFER, device_type),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + RANKS_JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"{backend} ranks did not finish in "
                                     f"{RANKS_JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(30)
    outs = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}_{backend}.json")) as fh:
            outs.append(json.load(fh))
    return outs


def check_ranks(tmp, backend, outs, y_ref, e0_full, block_ref):
    """Rank 0's gathered applies against ``y_ref`` (atol 1e-13 / rtol
    1e-12), every rank's E0 against the full leg's (1e-10), and the block
    solvers' eigenvalues the same bits on every rank and within 1e-10 of
    the one-process solves' (``block_ref``: solver → eigenvalues)."""
    import numpy as np

    errs = {}
    for mode in ("ell", "streamed"):
        y = np.load(os.path.join(tmp, f"y_{mode}_{backend}.npy"))
        errs[mode] = assert_close(y, y_ref, f"{backend} ranks {mode} apply "
                                            "vs LocalEngine ell apply")
    e0s = [o["ell"]["e0"] for o in outs]
    if len(set(e0s)) != 1 or not all(o["ell"]["lanczos_converged"]
                                     for o in outs) \
            or abs(e0s[0] - e0_full) > 1e-10:
        raise AssertionError(f"{backend} ranks E0 {e0s}, full leg "
                             f"{e0_full}")
    block = {}
    for name, want in block_ref.items():
        evs = [o["ell"][name]["eigenvalues"] for o in outs]
        d = max(abs(a - b) for a, b in zip(evs[0], want))
        if any(e != evs[0] for e in evs) or len(evs[0]) != len(want) \
                or d > 1e-10:
            raise AssertionError(f"{backend} ranks {name} eigenvalues "
                                 f"{evs}, one process {want}")
        block[name] = {"max_abs_diff_vs_one_process": d,
                       "same_bits_on_every_rank": True}
    return {"vs_local_ell_max_abs_err": errs, "e0": e0s[0],
            "e0_minus_full": e0s[0] - e0_full, "block_solvers": block}


def nccl_one_rank_leg(device, full_eng, tmp):
    """A one-rank NCCL group in this process: the streamed engine at D = 1
    with every exchange through ``all_to_all_single``.  Its plan must equal
    the full leg's byte for byte, and its apply the full leg's bit for bit
    (both under ``torch.use_deterministic_algorithms``, so the receive-side
    ``index_add_`` sums in one order)."""
    import torch
    import torch.distributed as dist

    from distributed_matvec_tpu_torch import DistributedEngine
    from distributed_matvec_tpu_torch.ops import plan_codec as PC
    from distributed_matvec_tpu_torch.parallel.mesh import init_distributed

    g = init_distributed("nccl", f"file://{tmp}/rendezvous_nccl1", 1, 0,
                         timeout_s=RANKS_COLLECTIVE_TIMEOUT_S)
    try:
        wire = wire_check(g, device)
        eng, build_s, peak = build_timed(device, lambda: DistributedEngine(
            full_eng.operator, batch_size=full_eng.batch_size, group=g))
        if not torch.equal(eng._plan_host, full_eng._plan_host):
            raise AssertionError("the one-rank NCCL plan differs from the "
                                 "full leg's")
        xh = full_eng.random_hashed(5)
        torch.use_deterministic_algorithms(True)
        try:
            y_full = full_eng.matvec(xh)
            PC.fused_decode_gather_scatter.launches = 0
            eng.n_applies = 0
            y = eng.matvec(xh)
            eng.pipeline_depth = 2
            y2 = eng.matvec(xh)
            eng.pipeline_depth = 0
        finally:
            torch.use_deterministic_algorithms(False)
        for depth, got in ((0, y), (2, y2)):
            if not torch.equal(got, y_full):
                raise AssertionError(
                    f"one-rank NCCL apply at depth {depth} differs from the "
                    f"full leg's: max abs err "
                    f"{float((got - y_full).abs().max())}")
        info = {"backend": g.backend, "build_s": build_s,
                "build_peak_bytes": peak, "nchunks": eng.nchunks,
                "equal_to_full_bit_for_bit": [0, 2],
                "wire_dtypes_checked": wire}
        info.update(rank_apply_times(device, eng, xh))
        eng.pipeline_depth = 2
        info["depth2"] = rank_apply_times(device, eng, xh)
        eng.pipeline_depth = 0
        launches = PC.fused_decode_gather_scatter.launches
        applies = eng.n_applies
        # the full leg's engine (the exchange a transpose) and this one in
        # turns: full, rank, rank, full
        turns = [rank_apply_times(device, e, xh)["apply_ms_host_median"]
                 for e in (full_eng, eng, eng, full_eng)]
        info.update(turns_ms_host_full_rank_rank_full=turns,
                    profile=profile_apply(lambda: eng.matvec(xh)),
                    profile_full=profile_apply(lambda: full_eng.matvec(xh)))
        if launches != eng.nchunks * applies:
            raise AssertionError(f"{launches} decode launches for "
                                 f"{applies} applies of {eng.nchunks} "
                                 "chunks")
        info.update(applies=applies, launches=launches,
                    exchange_ms_per_apply=exchange_ms(
                        device, g, (1, eng._codec.spec["cap_eff"], 1),
                        eng.nchunks))
        del eng
    finally:
        dist.destroy_process_group()
    return info


def ranks_phase(device, op, ell_ref, full_eng, e0_full, block_ref):
    """The rank engine on the card; see the module docstring."""
    import tempfile

    import numpy as np
    import torch

    n = op.basis.number_states
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(n)).to(
        device)
    y_ref = ell_ref.matvec(x).cpu().numpy()
    out = {"n_states": n, "world_size": RANKS, "batch_size": RANKS_BATCH,
           "remote_buffer_size": RANKS_REMOTE_BUFFER,
           "note": "two ranks sharing one card over gloo: not a two-card "
                   "result"}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = spawn_ranks("gloo", RANKS, tmp, 32)
        out["gloo"] = {"seconds": time.perf_counter() - t0, "ranks": outs,
                       **check_ranks(tmp, "gloo", outs, y_ref, e0_full,
                                     block_ref)}
        launches = sum(o["streamed"]["launches"] for o in outs)
        cards = torch.cuda.device_count()
        if cards >= RANKS:
            t0 = time.perf_counter()
            outs = spawn_ranks("nccl", RANKS, tmp, 32)
            out["nccl"] = {"seconds": time.perf_counter() - t0,
                           "ranks": outs,
                           **check_ranks(tmp, "nccl", outs, y_ref, e0_full,
                                         block_ref)}
            launches += sum(o["streamed"]["launches"] for o in outs)
        else:
            out["nccl"] = {"ran": False, "why": (
                f"{cards} card(s): NCCL needs one card per rank, so the "
                f"{RANKS}-rank NCCL leg (ell with the block solvers, "
                "streamed at depth 0 and 2) runs only where "
                f"torch.cuda.device_count() >= {RANKS}")}
            emit({"leg": "ranks.nccl", "ran": False,
                  "why": out["nccl"]["why"]})
        out["nccl_one_rank"] = nccl_one_rank_leg(device, full_eng, tmp)
        launches += out["nccl_one_rank"]["launches"]
    out["launches"] = launches
    out["kernel_max_abs_err"] = max(
        o["streamed"]["kernel_max_abs_err"]
        for leg in ("gloo", "nccl") for o in out[leg].get("ranks", ()))
    return out


def local_complex_phase(device, e0_full, n=32):
    import numpy as np
    import torch

    from distributed_matvec_tpu_torch import (LocalEngine, krylov_evolve,
                                              lanczos)
    from distributed_matvec_tpu_torch.models.basis import SpinBasis
    from distributed_matvec_tpu_torch.models.lattices import (
        chain_edges, heisenberg_from_edges)

    os.environ["DMT_ENUMERATION_BACKEND"] = "native"
    basis = SpinBasis(n, n // 2, None, [([(i + 1) % n for i in range(n)], 1)])
    t0 = time.perf_counter()
    basis.build()
    enum_s = time.perf_counter() - t0
    op = heisenberg_from_edges(basis, chain_edges(n))
    N = basis.number_states
    eng, ell = timed_build(device, lambda: LocalEngine(op, device=device))
    if eng.real or not eng.low_memory_build:
        raise AssertionError(f"k = 1: real {eng.real}, low-memory build "
                             f"{eng.low_memory_build}")
    ell["full_width_bytes"] = eng.n_padded * eng.num_terms * 20
    ell["reckoned_peak_bytes"] = 1.6 * ell["full_width_bytes"]
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal(N)
                         + 1j * rng.standard_normal(N)).to(device)
    y = eng.matvec(x)
    ell["apply_ms_device"] = device_ms(device, lambda: eng.matvec(x), reps=3)

    fused = LocalEngine(op, mode="fused", device=device)
    t0 = time.perf_counter()
    yf = fused.matvec(x)
    _sync(device)
    fused_info = {"vs_ell_max_abs_err": assert_close(yf, y,
                                                     "fused vs ell apply"),
                  "first_apply_s": time.perf_counter() - t0}
    # the ell apply, kept on the host for streamed_complex
    kept = (x.cpu().numpy(), y.cpu().numpy())
    del fused, yf, y, x

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = lanczos(eng.matvec, N, k=1, tol=1e-10, device=device)
    _sync(device)
    e0 = float(res.eigenvalues[0])
    resid = float(res.residual_norms[0])
    iters = int(res.num_iters)
    if not (res.converged and resid < 1e-10 * max(1.0, abs(e0))
            and e0 > e0_full):
        raise AssertionError(f"k = 1 E0 {e0} (residual {resid}, converged "
                             f"{res.converged}) not above k = 0 {e0_full}")
    info = {"n_states": N, "enumeration_s": enum_s, "ell": ell,
            "fused": fused_info, "lanczos_s": time.perf_counter() - t0,
            "lanczos_iters": iters, "e0": e0,
            "residual": resid, "e0_minus_k0": e0 - e0_full,
            # the default basis cap of 96 vectors, plus one, in c128
            "krylov_bytes": 97 * N * 16,
            "solve_peak_bytes": torch.cuda.max_memory_allocated(device),
            "plain_work": plain_work(eng, ell["apply_ms_device"], iters)}
    del res
    # native complex128 time evolution of a seeded random state
    evo, info["krylov_evolve"] = solve_timed(device, eng, lambda mv:
                                             krylov_evolve(
        mv, n=N, t_final=0.25, seed=3, device=device))
    info["krylov_evolve"].update(steps=evo.num_steps,
                                 norm_drift=evo.norm_drift,
                                 energy_drift=evo.energy_drift)
    if not (evo.norm_drift < 1e-10 and abs(evo.times[-1] - 0.25) < 1e-12):
        raise AssertionError(f"k = 1 evolve norm drift {evo.norm_drift}")
    return info, op, kept


#: local_complex's E0 of the 32-ring's translation-only k = 1 sector (the
#: LocalEngine ell solve on an H100)
RING32_K1_E0 = -55.581030569044785


def streamed_complex_phase(device, op, kept):
    """The 32-ring's k = 1 sector through the streamed engine; see the
    module docstring."""
    import numpy as np
    import torch

    from distributed_matvec_tpu_torch import DistributedEngine, lanczos
    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    x, y_ell = kept
    eng, build_s, peak = build_timed(device, lambda: DistributedEngine(
        op, device=device))
    spec = eng._codec.spec
    if eng.real or eng.stream_kernel != "torch" or spec["ckind"] != \
            "complex":
        raise AssertionError(f"k = 1 streamed: real {eng.real}, decode path "
                             f"{eng.stream_kernel}, ckind {spec['ckind']}")
    info = {"n_states": int(op.basis.number_states), "build_s": build_s,
            "build_peak_bytes": peak, "timings": eng.timings,
            "plan_bytes": int(eng.plan_bytes),
            "plan_bytes_raw": int(eng.plan_bytes_raw),
            "nchunks": eng.nchunks,
            "spec": {k: spec[k] for k in ("ckind", "coeff", "ndict",
                                          "code_bits", "n_live", "n_recv",
                                          "cap_eff")},
            "stream_kernel": eng.stream_kernel,
            "receive_add": "index_add_ through view_as_real (f64 [n, 2])"}
    PC.fused_decode_gather_scatter.launches = 0
    y = eng.matvec_global(x)
    info["vs_ell_max_abs_err"] = assert_close(
        torch.from_numpy(y), torch.from_numpy(y_ell),
        "k = 1 streamed vs ell apply")
    del y, y_ell
    xh = eng.to_hashed(x)
    info.update(apply_times(device, eng, xh, applies=3))
    prof = profile_apply(lambda: eng.matvec(xh), top=12)
    info["profile"] = {k: prof[k] for k in ("device_ms_total", "top",
                                             "parts")}
    t0 = time.perf_counter()
    res = lanczos(eng.matvec, v0=eng.random_hashed(0), k=1, tol=1e-10,
                  device=device)
    _sync(device)
    e0 = float(res.eigenvalues[0])
    info.update(lanczos_s=time.perf_counter() - t0,
                lanczos_iters=int(res.num_iters), e0=e0,
                e0_minus_local_complex=e0 - RING32_K1_E0)
    if not (res.converged and abs(e0 - RING32_K1_E0) < 1e-10):
        raise AssertionError(f"k = 1 streamed E0 {e0} != local_complex's "
                             f"{RING32_K1_E0} (converged {res.converged})")
    del res
    rng = np.random.default_rng(14)
    X = eng.to_hashed(rng.standard_normal((x.size, 3))
                      + 1j * rng.standard_normal((x.size, 3)))
    Y = eng.matvec(X)
    info["block_r3_max_abs_err"] = max(
        assert_close(Y[..., r], eng.matvec(X[..., r].contiguous()),
                     f"[1, M, 3] column {r} vs its own apply")
        for r in range(3))
    info["launches"] = PC.fused_decode_gather_scatter.launches
    if info["launches"]:
        raise AssertionError(f"{info['launches']} decode kernel launches "
                             "in a complex streamed engine")
    return info


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import distributed_matvec_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    run_phase("build", build_phase)
    _, synth_err = run_phase("kernel_check", kernel_check_phase, device)
    run_phase("small", small_phase, device)
    run_phase("local_small", local_small_phase, device)
    full, eng, launches, chunk_err = run_phase("full", full_phase, device)
    split = run_phase("split", split_phase, device, eng)
    _, ell = run_phase("local_full", local_full_phase, device, eng,
                       full["e0"])
    solvers, solver_launches = run_phase("solvers", solvers_phase, device,
                                         eng, ell, full["e0"])
    op = eng.operator
    torch.cuda.empty_cache()
    _, sharded = run_phase("sharded", sharded_phase, device, op, ell,
                           full["e0"])
    torch.cuda.empty_cache()
    pipe, pipe_launches = run_phase("pipeline", pipeline_phase, device, eng,
                                    sharded.pop("engines"))
    torch.cuda.empty_cache()
    tiers, tier_launches = run_phase("tiers", tiers_phase, device, eng,
                                 full["e0"])
    block_ref = {name: solvers[name]["eigenvalues"]
                 for name in ("lanczos_block", "lobpcg")}
    ranks = run_phase("ranks", ranks_phase, device, op, ell, eng,
                      full["e0"], block_ref)
    del ell, op, eng
    torch.cuda.empty_cache()
    run_phase("cross_sector", cross_sector_phase, device, full["e0"])
    torch.cuda.empty_cache()
    _, k1_op, kept = run_phase("local_complex", local_complex_phase, device,
                               full["e0"])
    torch.cuda.empty_cache()
    run_phase("streamed_complex", streamed_complex_phase, device, k1_op, kept)
    del k1_op, kept
    emit({"kernels": [{
        "name": "fused_decode_gather_scatter",
        "route": "cuda",
        "source": "distributed_matvec_tpu_torch/csrc/fused_decode.cu",
        "replaces": "distributed_matvec_tpu/ops/plan_codec.py:651",
        "launches": launches + solver_launches + sharded["launches"]
        + pipe_launches + tier_launches + ranks["launches"],
        "max_abs_err": max(synth_err, chunk_err, split["plan_max_abs_err"],
                           sharded["max_abs_err"], pipe["kernel_max_abs_err"],
                           tiers["kernel_max_abs_err"],
                           ranks["kernel_max_abs_err"]),
        "ms": split["kernel_ms_per_launch"],
        "plain_ms": split["plain_ms_per_launch"],
        "bound_ms": split["bound_ms_per_launch"],
        "bound_by": split["bound_by"],
        "library_ms": None,
        # the one-shard legs (full, solvers) and the D = 4 leg apart
        "launches_d1": launches + solver_launches,
        "launches_d4": sharded["launches"],
        # the pipelined applies of the pipeline phase (D = 1 and D = 4)
        "launches_pipeline": pipe_launches,
        # the f32 and bf16 tiers' applies and Lanczos solves (D = 1)
        "launches_tiers": tier_launches,
        # each rank's own launches on its shard (gloo ranks on the card at
        # depth 0 and 2, and the one-rank NCCL group)
        "launches_ranks": ranks["launches"],
        "ms_d4": sharded["ms"], "plain_ms_d4": sharded["plain_ms"],
        "bound_ms_d4": sharded["bound_ms"],
        "bound_by_d4": sharded["bound_by"],
    }]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
