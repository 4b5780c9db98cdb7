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
   the full leg) through ``LocalEngine``, the default single-device path:
   the one-pass ``ell`` build (seconds, T0/S/Tmax,
   table bytes, peak memory beside the 1.6× reckoning), its apply against
   the streamed engine's (atol 1e-13 / rtol 1e-12), 7 applies timed (host
   wall and device time) and one profiled; the ELL apply kernel
   (``csrc/ell_apply.cu``) at R = 1 and R = 4 (``ell_kernel``: µs per
   apply by CUDA events, the byte bound ``16·N·R + 12·nnz`` at
   3.35 TB/s, the plain version's µs state-major and, at R = 4, columns
   first as the engine ran before the kernel, the library's CSR product
   ``csr @ x`` over the same tables, and the kernel ``torch.equal`` to
   the plain version); the kernel's launches counted from 0 over the
   leg's applies and Lanczos, one apply's launches (1, or 2 with a tail)
   and every Lanczos apply's held to it; Lanczos (E0 within 1e-8
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
8. ``cross_sector`` (after ``ranks``): the 30-ring in the translation-only
   k = 0 sector (no reflection, no spin inversion, so other orbits, norms
   and plan), streamed, must give the E0 of ``tiers``' chain_30_symm
   lossless solve to 1e-9 (the 30-ring, not the 32-ring: cut to fit the
   time limit).
9. ``sharded``: the same chain_32_symm operator (enumerated once, by the
   full leg) through ``DistributedEngine(op, n_devices=4, mode=m)`` — four
   hash shards on the one card, row chunk 16 384 — in the modes
   ``streamed``, ``ell`` and ``fused``; ``compact`` at D = 4 runs on
   chain_24_symm (``COMPACT_N``, cut from chain_32_symm to fit the time
   limit), held to a ``LocalEngine`` ell apply of that operator.  Each
   build's seconds,
   peak device memory and plan or table bytes; the apply, through
   ``from_hashed``, against ``local_full``'s ell apply (atol 1e-13 / rtol
   1e-12); 7 timed applies (host wall and CUDA events; fused: its first
   apply's seconds, to fit the time limit);
   for streamed and ell, a ``torch.profiler`` breakdown of one apply; for
   ell, Lanczos E0 within 1e-10 of the full leg's and 1e-8 relative of the
   recorded value (the streamed engine's Lanczos is cut to fit the time
   limit: its apply is held to the ell apply).  For streamed, the decode
   kernel
   on real D = 4 chunks: every chunk of shard 0 and the middle chunk of
   every shard against the plain version (``torch.equal``), its time per
   launch over every (chunk, shard) beside the byte bound, and its
   launches counted from 0 around the main path: 4 × 72 per apply.  Times
   here are one card running four shards, not a four-card result.  The
   streamed and fused engines stay built for the next phases.
10. ``pipeline``: ``pipeline_depth`` switched on engines already built —
   the full leg's D = 1 streamed engine at depths 0, 2 and 4, the sharded
   leg's D = 4 streamed engine at 0 and 2, and one D = 4 fused apply at 2.
   Each pipelined streamed apply must equal its engine's
   depth-0 apply bit for bit (both under
   ``torch.use_deterministic_algorithms``), the fused one the D = 4
   streamed engine's apply within atol 1e-13 / rtol 1e-12 (deterministic,
   a fused apply takes ≈ 30 s; the card tests hold fused bit for bit at
   chain_16_symm; its depth-0 apply is timed by ``sharded``), and each
   must
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
   collectives.  (a) Two ranks share the one card over gloo on ``tiers``'
   chain_30_symm (cut from chain_32_symm to fit the time limit; spawned,
   each loading the parent's basis): ``ell``
   (build, apply, 3 timed applies, Lanczos to E0, then ``lanczos_block``
   and ``lobpcg`` at k = 2, block width 2 — cut from ``solvers``' k = 4
   to fit the time limit, their one-process references alike) and
   ``streamed`` at B = 65 536 with 2²¹-entry buckets (build, the decode
   kernel on three of its own chunks against the plain version, 3 timed
   applies with its launches counted from 0: one per plan chunk per apply;
   then at depth 2 one apply bit-equal to depth 0 under deterministic
   algorithms, its launches counted alike; the timed depth-2 applies are
   cut to fit the time limit).  Rank 0 gathers
   each apply, which must equal a one-process ``LocalEngine`` ell apply
   (atol 1e-13 / rtol 1e-12); both ranks' E0 must be the same bits and
   within 1e-10 of the one-process Lanczos; both ranks' block-solver
   eigenvalues the same bits and within 1e-10 of the same solvers run in
   one process, as ``solvers`` runs them.  Per rank: build
   seconds, apply ms (host wall and CUDA events), the exchange's ms and
   bytes per apply, each block
   solver's seconds, applies, share outside the applies and count of
   collectives, whether the exchange is staged through host memory, and
   whether this torch's gloo takes CUDA tensors itself in
   ``all_to_all_single``.  A rank that fails or outlasts the join timeout
   fails the phase.  Two ranks on one card are not a two-card result.  (b) A
   one-rank NCCL group in this process: the streamed engine at D = 1 with
   every exchange through ``all_to_all_single``; its plan must equal the
   full leg's byte for byte and its apply the full leg's bit for bit at
   depth 0 and at depth 2 (chain_32_symm) (all applies under
   ``torch.use_deterministic_algorithms``), the launches of both counted;
   3 timed applies at depth 0 (the timed depth-2 applies are cut to fit
   the time limit).  (c) With two or more cards,
   leg (a) over NCCL, one rank per card; on one card a line says it did
   not run and why.  (d) In the gloo ranks of (a), the solve service over
   the group (``EnginePool(group=g)``, ``block_width=1``): two ell
   ``eigs`` jobs (one build, one hit, one ``engine_init`` per build) within
   1e-10 of the one-process E0 and the same bits on both ranks, and a
   streamed lossless job whose decode launches each rank counts from 0
   around the drain.  (e) The heartbeat: two more gloo ranks start the
   watchdog (``HB_INTERVAL_S`` 0.5, ``HB_TIMEOUT_S`` 5) and a Lanczos that
   never converges, each check block stretched by
   ``DMT_FAULT=solver_block:delay=200``; SIGSTOP to rank 1 mid-solve, and
   rank 0 must exit 76 within ``HB_TIMEOUT_S + 2·HB_INTERVAL_S + 5`` s
   with one ``stall_report`` naming rank 1 and a ``stall`` flight bundle
   on disk; then rank 1 is killed.
12. ``local_complex``: the translation-only k = 1 sector of the 32-ring,
   complex Hermitian (about 18.8 M states): the ``ell`` build takes the
   low-memory path by itself (1.6× the full-width complex tables passes
   the 12 GB default budget), one ``fused`` apply against the ell apply,
   complex128 Lanczos to a converged E0(k=1) strictly above the full
   leg's E0(k=0), with the peak memory, and a native-complex
   ``krylov_evolve`` of a random state to t = 0.25 (norm drift below
   1e-10).
13. ``tiers`` (after ``pipeline``): chain_30_symm (cut from chain_32_symm
   to fit the time limit, at the full leg's row chunk) through the
   streamed engine's other tiers and forms, each held to a lossless D = 1
   engine's apply of one seeded state and its Lanczos E0: ``off`` (the raw
   layout; plan bytes; the apply bit-equal under
   ``torch.use_deterministic_algorithms``; decode path ``torch``, no
   decode-kernel launch); ``f32`` and ``bf16`` (decode path ``cuda``: the
   unchanged kernel on quantized dictionaries, held against its plain
   version on one real chunk, launched once per chunk per apply, counted
   from 0 around an apply and a Lanczos solve; the apply's largest error
   relative to the largest lossless value within 1e-6 and 1e-2, and beside
   it the health layer's ``compress_rel_err`` drift sample of the same
   applies; the E0
   each finds, through ``lanczos``' default (full reorthogonalization on a
   quantized tier), within 1e-6 and 1e-2 of the lossless one, relative);
   raw coefficient streams
   (``ops.plan_codec.DICT_MAX`` lowered around one lossless build:
   ``coeff == "raw"``, bit-equal apply); ``hybrid`` at ``all-stream``,
   ``stream:<even terms>`` and ``all-recompute`` (one chunk's send buffer
   bit-equal to the lossless engine's, the apply bit-equal at depth 0 and
   2, ``hybrid_stream_fraction``, plan bytes, host and device ms).  Each
   build's seconds; no engine outlives its leg.
14. ``streamed_complex`` (after ``local_complex``): the k = 1 sector of
   the 30-ring (not the 32-ring's, ``local_complex``'s: cut to fit the
   time limit) through ``DistributedEngine(op)`` — the streamed
   engine, lossless, a complex dictionary, decode path ``torch``: build
   seconds, plan bytes, codec spec and peak memory; the apply against an
   ell ``LocalEngine`` of the same sector built here (atol 1e-13 / rtol
   1e-12); 3 timed applies (host wall and CUDA events) and a
   ``torch.profiler`` breakdown of one (decode, host → device copy,
   ``index_add_``); a complex-Hermitian Lanczos of 32 steps from the same
   seeded state on both engines (cut from a solve to E0 to fit the time
   limit), the lowest Ritz values within 1e-10 relative; a ``[1, M, 3]``
   apply against three single-column ones (atol 1e-13); no decode-kernel
   launch.
15. ``costmodel`` (last): the cost model at chain_32_symm's full width, on
   the ``full`` leg's streamed engine and basis, ``local_full``'s ell
   engine and ``tiers``' chain_30_symm operator (nothing enumerated), with
   ``DMT_ARTIFACT_DIR`` and ``DMT_OBS_DIR`` in a fresh temporary
   directory.  The rate calibration (``obs/calibrate.py``) on the card,
   saved as the sidecar everything after it resolves (``source`` must be
   ``measured``); 7 applies of each engine with phases on — the
   ``roofline_report`` under that calibration (per-phase counts, walls,
   bounds, achieved fraction, binding resource), ``reconcile_error``
   below 1e-3 — and 7 with phases off (no ``apply_phases`` event may
   appear), the medians side by side; ``pipeline_depth="auto"`` on the
   full engine, its apply bit-equal to depth 0; one tuned build (cut from
   two to fit the time limit): a ``tune="live"`` lossless streamed engine
   whose first config must equal ``tune.choose_config`` (the static
   search) on the same stats and rates (the token, search and build
   seconds), bit-equal to a ``DistributedEngine`` hand-set to its knobs,
   the decode kernel against its plain version on one of its chunks, and
   ``lanczos_block`` on it to within 1e-10 of −56.82610975579819, its
   decode launches counted from 0 (``launches_costmodel``); then the same
   engine through windows of ``DMT_TUNE_WINDOW`` = 8 applies (each
   window's measured/priced ratio and posterior rates), any re-key's next
   apply bit-equal to a hand-set engine at the new knobs;
   ``hybrid_split="auto"`` on chain_30_symm, its mask and an apply
   bit-equal to ``hybrid_split="stream:<that mask>"``.  Every earlier leg
   runs with ``DMT_PHASES=off``, timing its applies as before.

``resilience`` runs after ``solvers``, on the full leg's streamed engine
(D = 1, lossless, the decode kernel) and ``local_full``'s ell engine:
(health) with ``health_every=1``, 2 × 7 applies of each engine with the
probes off and on, in turns — the synchronized wall and the host's
dispatch time (an apply that waited on the device would show its device
time there) side by side; a 64-step Lanczos on the streamed engine with
every apply probed: no ``solver_health`` warning and ``matvec_nonfinite``
0; a NaN planted in x: no event at its apply, one critical
``nonfinite_output`` at the next apply's drain, and ``DMT_HEALTH=strict``
raising ``HealthError``.  (memory) the ledger as that Lanczos held it (the
two engines, the H2D ring, the host plan and its Krylov workspace), a
watermark against ``torch.cuda.max_memory_allocated``, and a real OOM: a
ballast tensor leaves 1 GiB free and ``LocalEngine(op)`` (3.5 GB peak)
must raise ``OomError`` whose report's ledger names the ballast, with
remediation and ``cudaMemGetInfo``'s free bytes; the decode kernel's
``cudaFuncGetAttributes`` per instance.  (faults)
``DMT_FAULT=plan_upload:n=2`` heals through the retries to an apply
bit-equal to the clean one (fired twice); ``exchange:n=1`` at depth 2
raises ``[fault-injection]`` before any device work and the next apply is
bit-equal; the apply median with ``DMT_FAULT`` unset.  (profile)
``DMT_PROFILE=sampled``, ``profile_every=4``: 16 applies of each engine
give 4 windows each (traces on disk), the overhead guard's measured
percentage, the kernel table of a streamed window (the decode kernel in
``compute``, ``index_add_`` in ``accumulate``, every ``overhead`` kernel
name listed), and the roofline report with its measured device-ms column
for both engines.  Its decode launches are ``launches_resilience``.

``serve`` runs after ``resilience``: the port's ``SolveService`` drains a
spool of real jobs on the card, all on ``heisenberg_chain(32,
symmetric=True)`` (each spec carries the basis with its generators and
``n_states``), with ``DMT_OBS_DIR`` pointed at a temporary run directory,
``stream_compress`` ``lossless`` through ``update_config``, the pool budget
``SERVE_POOL_GB`` (both engines fit) and admission priced against the
card's memory: four ``eigs`` jobs on the ell engine (k = 1, tol 1e-10 /
1e-9 / 1e-10 / 1e-8: one build, one batch of 4), one ``eigs`` job on the
streamed engine (k = 2: the decode kernel runs under the service, its
launches counted from 0 around the drain as ``launches_serve``), a ``kpm``
job (128 moments × 4 vectors) and an ``evolve`` job (t = 0.25), both pool
hits, and a 40-spin spec that cannot fit (rejected, with its ``done/``
record).  Checks: every status; 2 builds, 2 hits, no eviction; each E0
within 1e-9 of the CPU value (or within its residual when that is
larger); each batched E0 within 1e-10 relative of a solo
``lanczos_block`` on the same engine from the job's ``column_seed()``;
the batch replayed from a start block drawn here (column j from job j's
``column_seed()``, job j's target on it) giving each job its record's
iteration count and E0 (1e-12 relative); the kpm job's moments within
1e-12, DOS peak within 1e-10 relative, bounds and applies equal to
``kpm_dos`` called directly;
``job_event`` sequences ``queued → running → done`` (``queued →
rejected``) and every ``job:`` span a child of a ``serve_batch`` span in
``rank_0/events.jsonl``; the decode kernel against its plain version on
one of the served engine's chunks.  Then the service process
(``python -m distributed_matvec_tpu_torch.apps.solve_service``) with two
ell jobs on chain_24_symm (cut to fit the time limit; each solver block
of this process stretched by ``DMT_FAULT=solver_block:delay=300``) gets
SIGTERM once they run: exit 75, both specs still in ``queue/``, ``done/``
empty; the same argv again, without the delay, exits 0 with E0s within
1e-10 of an in-process solve of the same operator.  Prints per-job
latency, build seconds per engine, the batch's seconds, block applies and
share outside them, the streamed apply's ms, and the seconds from SIGTERM
to exit.

``apps`` runs after ``streamed_complex``: the two command lines of the
port.  Where ``yaml`` or ``h5py`` does not import (the phase's line says
which do), ``python -m distributed_matvec_tpu_torch.apps.diagonalize`` on
chain_32_symm's YAML text must exit non-zero within 20 s with the JAX
package's message for the first one missing, before any enumeration and
without an output file; where both import, its ``main`` runs end to end
on chain_16_symm into a temporary directory (E0/4 within 1e-9 of the
anchor, the file read back).  Then a ``Config`` built from the
chain_32_symm dict through the YAML loader's ``basis_from_dict`` and
``operator_from_dict`` (the dict ``chain_config`` gives, which the CPU
tests hold to the YAML text and to ``heisenberg_chain(32,
symmetric=True)``), enumerated once, through the diagonalize solve
function: ``mode="streamed"`` (``lossless``), k = 1, tol 1e-10, E0 within
1e-10 of the ``full`` leg's, residual below 1e-8, the eigenvector in
block order, the decode kernel's launches counted from 0 around the call
equal to 72 × the columns applied; then ``mode="ell"`` on the same
``Config``, E0 within 1e-10.  The dynamics solve function: ``kpm`` (64
moments, 4 vectors) on a streamed engine of tiers' chain_30_symm with the
card's atomic receive side, its moments within 1e-12·|μ0| of
``kpm_moments`` called directly on the same engine with the same seed;
then on chain_26_symm with its moments bit-equal to the direct call (both
under ``torch.use_deterministic_algorithms``, whose receive side costs
≈ 38× the atomic one: cut from chain_30_symm to fit the time limit);
each with its decode launches counted (one per plan chunk per column
applied); ``evolve`` on
chain_16_symm equal to ``krylov_evolve`` called directly, its norm drift
below 1e-12.  Its decode launches are ``launches_apps``.

``shards`` runs after ``sharded``: chain_32_symm enumerated straight into
D = 4 hash shards at row chunk 16 384, streamed ``lossless``, on an
operator whose basis is never built.  Where ``h5py`` imports,
``enumerate_to_shards`` writes a temporary shard file and the engine is
``DistributedEngine.from_shards``; where it does not (the phase's line
says ``"h5py"`` and which ``route`` ran), the same routing loop runs into
the module-private in-memory sink and the engine builds through
``_shard_source`` — both routes make the same checks.  The enumeration's
and the routing's seconds apart; each shard's states and norms bit-equal
to ``HashedLayout``'s shards of the full leg's basis, the counts summing
to the census; the shard-native plan's words and dictionary bit-equal to
the sharded leg's global-layout D = 4 streamed engine's; 3 applies, each
held to ``local_full``'s ell apply through the layout the engine
materializes on request (atol 1e-13 / rtol 1e-12), host and device ms,
the decode launches 4 × 72 per apply; ⟨x, Hx⟩ of
``state_keyed_hashed(7)`` within 1e-12 relative of the same probe on the
full leg's D = 1 engine; the Resharder D = 4 → 1 (owner the full engine)
and 1 → 4 (owner the shard-native engine), each landing the probe
bit-equal to its owner's, with its seconds.  Where ``h5py`` imports, also
a checkpointed ``lanczos`` on chain_20_symm at D = 4 (ell), preempted at
its second safe point and resumed at D = 2 to the uninterrupted E0
within 1e-10; without it the line says the step was skipped.  Its
decode launches (the shard-native applies and both probes) are
``launches_shards``.

``local_small`` runs after ``small``: chain_16_symm through ``LocalEngine``
in ``ell``, ``compact`` and ``fused`` mode at ``batch_size=61`` (chunking
and padding engage), matvec rank-1 and ``[N, 3]`` against ``matvec_host``
(atol 1e-13 / rtol 1e-12), E0/4 against the anchor (1e-9), and a complex
k = 1 sector of the 16-ring in ``ell`` and ``fused`` mode against
``matvec_host``.

Then the kernels line ``{"kernels": [...]}`` (launches on the main paths
of ``full``, ``solvers``, ``resilience``, ``serve``, ``sharded``,
``shards``, ``pipeline``, ``tiers``, ``ranks``, ``apps`` and
``costmodel``, and apart at one shard, at four, in the pipelined applies,
in the quantized tiers, on the ranks (the served streamed job's
included), under the service, in the resilience leg, in the two apps'
solve functions, on the autotuned engines and on the shard-native
engine;
largest error against the plain version, time per launch beside its bound
and the plain version's time, at one shard and at four; then the ELL
apply kernel: its launches counted from 0 on ``local_full``'s engine
(D = 1) and on the sharded leg's ell engine (D = 4), each leg's launches
per apply as measured over one apply, its largest difference from the
plain version, and ``local_full``'s times at R = 1 and R = 4 beside
their byte bounds, the plain version's and the library's CSR product's),
the card's name
and power limit as ``nvidia-smi`` prints them, and last ``{"ok": true, "device": {...}}``.
Any failed check raises and the script exits non-zero.  It needs one CUDA
device; without one it exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import io
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
                           f"{cuda_kernels.error_string(lib, rc)}")


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
    eng = DistributedEngine(op, device=device,
                            mode="streamed", stream_compress="lossless")
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
    eng = DistributedEngine(op, device=device,
                            mode="streamed", stream_compress="lossless")
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
    copy), from ``torch.profiler`` through the port's own table
    (``obs/kernel_costs``: ``kernel_rows``, ``build_profile``): the
    ``top`` largest as ``[name, ms, calls]``, the sum over all of them,
    the device ms by phase (``classify_kernel``: plan_h2d, compute,
    exchange, accumulate, overhead), and the two extras the table does
    not keep — every fill kernel's row, and every
    ``aten::fill_``/``aten::zero_`` call grouped by the shape it filled
    as ``[op, shapes, calls]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_matvec_tpu_torch.obs import kernel_costs

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    table = kernel_costs.build_profile("apply", kernel_costs.kernel_rows(prof))
    rows = [[m["name"][:72], m["ms"], m["calls"]] for m in table["ops"]]
    fill_ops = [[e.key, e.input_shapes, e.count]
                for e in prof.key_averages(group_by_input_shape=True)
                if e.key in ("aten::fill_", "aten::zero_")]
    return {"device_ms_total": table["totals"]["ms"],
            "top": rows[:top],
            "fill_kernels": [r for r in rows if "fill" in r[0].lower()],
            "fill_ops": fill_ops,
            "phases_ms": {ph: v["ms"] for ph, v in table["phases"].items()}}


def cross_sector_phase(device, e0_symm, n=None):
    """The ring's translation-only k = 0 sector (no reflection, no spin
    inversion: other orbits, norms and plan), streamed, solved to E0; it
    must equal ``e0_symm``, the symmetric sector's E0 of the same ring
    (1e-9).  The {CUT_N}-ring (cut to fit the time limit), held to
    ``tiers``' lossless E0."""
    from distributed_matvec_tpu_torch import DistributedEngine, lanczos
    from distributed_matvec_tpu_torch.models.basis import SpinBasis
    from distributed_matvec_tpu_torch.models.lattices import (
        chain_edges, heisenberg_from_edges)

    n = n or CUT_N
    os.environ["DMT_ENUMERATION_BACKEND"] = "native"
    basis = SpinBasis(n, n // 2, None, [([(i + 1) % n for i in range(n)], 0)])
    t0 = time.perf_counter()
    basis.build()
    enum_s = time.perf_counter() - t0
    op = heisenberg_from_edges(basis, chain_edges(n))
    t0 = time.perf_counter()
    eng = DistributedEngine(op, device=device,
                            mode="streamed", stream_compress="lossless")
    engine_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = lanczos(eng.matvec, v0=eng.random_hashed(0), k=1, tol=1e-10,
                  device=device)
    _sync(device)
    lanczos_s = time.perf_counter() - t0
    e0 = float(res.eigenvalues[0])
    if not (res.converged and abs(e0 - e0_symm) < 1e-9):
        raise AssertionError(f"translation-only E0 {e0} != the symmetric "
                             f"sector's {e0_symm} (converged "
                             f"{res.converged})")
    return {"n": n, "n_states": int(basis.number_states),
            "enumeration_s": enum_s,
            "engine_init_s": engine_s,
            "plan_encode_s": eng.timings["plan_encode_s"],
            "plan_bytes": int(eng.plan_bytes), "nchunks": eng.nchunks,
            "lanczos_iters": int(res.num_iters), "lanczos_s": lanczos_s,
            "e0": e0, "e0_symm": e0_symm, "e0_minus_symm": e0 - e0_symm}


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


def apply_walls(device, eng, x, applies):
    """Host wall ms of each of ``applies`` applies, synchronized around."""
    walls = []
    for _ in range(applies):
        _sync(device)
        t0 = time.perf_counter()
        eng.matvec(x)
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def apply_times(device, eng, x, applies=7):
    walls = apply_walls(device, eng, x, applies)
    return {"apply_ms_host": walls,
            "apply_ms_host_median": statistics.median(walls),
            "apply_ms_device": device_ms(device, lambda: eng.matvec(x),
                                         reps=applies)}


def local_full_phase(device, streamed, e0_full):
    import numpy as np
    import torch

    from distributed_matvec_tpu_torch import LocalEngine, lanczos
    from distributed_matvec_tpu_torch.ops import ell_apply as EA

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
    EA.ell_apply.launches = 0
    y = eng.matvec(x)
    per_apply = EA.ell_apply.launches
    if per_apply != 1 + (eng._ell_tail is not None):
        raise AssertionError(f"{per_apply} ell_apply launches in one apply "
                             f"(tail: {eng._ell_tail is not None})")
    ell["vs_streamed_max_abs_err"] = assert_close(y, y_streamed,
                                                  "ell vs streamed apply")
    ell.update(apply_times(device, eng, x))
    ell["profile"] = profile_apply(lambda: eng.matvec(x))
    ell["ell_kernel"] = ell_kernel_times(device, eng)
    before, calls = EA.ell_apply.launches, [0]

    def matvec(v):
        calls[0] += 1
        return eng.matvec(v)

    t0 = time.perf_counter()
    res = lanczos(matvec, n, k=1, tol=1e-10, device=device)
    _sync(device)
    if EA.ell_apply.launches - before != per_apply * calls[0]:
        raise AssertionError(
            f"{EA.ell_apply.launches - before} ell_apply launches in "
            f"{calls[0]} Lanczos applies of {per_apply}")
    ell["kernel_launches"] = {"launches": EA.ell_apply.launches,
                              "launches_per_apply": per_apply}
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


def ell_columns_first(x, diag, idx, coeff, tail):
    """The ``ell`` apply as the engine ran it before the kernel: ``x``
    ``[n, R]`` transposed to ``[R, n]``, per term a gather along the state
    axis, a multiply and an add, the tail's rows alike, and ``y``
    transposed back.  For timing beside the kernel."""
    import torch

    xc = x.T.contiguous()
    y = diag.to(x.dtype) * xc[..., :idx.shape[1]]
    for t in range(idx.shape[0]):
        y += coeff[t] * torch.index_select(xc, -1, idx[t])
    if tail is not None:
        rows, t_idx, t_cf = tail
        acc = torch.zeros(xc.shape[:-1] + rows.shape, dtype=x.dtype,
                          device=x.device)
        for t in range(t_idx.shape[0]):
            acc += t_cf[t] * torch.index_select(xc, -1, t_idx[t])
        y[..., rows.long()] += acc
    return y.T.contiguous()


def ell_csr(eng):
    """``eng``'s operator as one CSR matrix built from its ``ell`` tables
    (the diagonal, the T0 terms and the tail, zero coefficients left out),
    for the library's sparse product beside the kernel."""
    import torch

    n, T0 = eng.n_states, eng.ell_split[0]
    dev = eng._ell_idx.device
    states = torch.arange(n, device=dev)
    parts = [(states, states, eng._diag[:n].to(eng._ell_coeff.dtype))]
    cf = eng._ell_coeff[:T0, :n]
    keep = cf != 0
    parts.append((states.expand(T0, n)[keep], eng._ell_idx[:T0, :n][keep],
                  cf[keep]))
    if eng._ell_tail is not None:
        rows, t_idx, t_cf = eng._ell_tail
        keep = t_cf != 0
        parts.append((rows.long().expand(t_idx.shape)[keep], t_idx[keep],
                      t_cf[keep]))
    ij = torch.stack([torch.cat([p[0].long() for p in parts]),
                      torch.cat([p[1].long() for p in parts])])
    vals = torch.cat([p[2] for p in parts])
    del parts, keep
    return torch.sparse_coo_tensor(ij, vals, (n, n)).coalesce(
    ).to_sparse_csr()


def ell_kernel_times(device, eng):
    """The ELL apply kernel (``ops/ell_apply.py``) on ``eng``'s tables at
    R = 1 and R = 4: µs per apply (its launches) by CUDA events, the byte
    bound of ``Y = H·X`` as the benchmark's yardstick counts it
    (``16·N·R + 12·nnz`` at 3.35 TB/s), the plain version's µs in the
    state-major layout the kernel takes, the columns-first plain apply's
    µs at R = 4 (the engine's apply before the kernel; at R = 1 the two
    layouts are one), and the library's sparse product (``csr @ x``, a CSR
    matrix of the same tables) with its largest difference from the
    kernel.  The kernel must equal the state-major plain version bit for
    bit; ``max_abs_err`` is its largest difference from both plain
    versions.  These launches are left out of ``ell_apply.launches``."""
    import numpy as np
    import torch

    from distributed_matvec_tpu_torch.ops import ell_apply as EA

    n, T0 = eng.n_states, eng.ell_split[0]
    tail = eng._ell_tail
    nnz = int(torch.count_nonzero(eng._ell_coeff[:T0, :n]))
    if tail is not None:
        nnz += int(torch.count_nonzero(tail[2]))
    out = {"nnz": nnz, "max_abs_err": 0.0}
    counted = EA.ell_apply.launches
    csr = ell_csr(eng)
    rng = np.random.default_rng(13)
    for R in (1, 4):
        x = torch.from_numpy(rng.standard_normal(
            (n, R) if R > 1 else n)).to(device)
        args = (x, eng._diag[:n], eng._ell_idx[:T0, :n],
                eng._ell_coeff[:T0, :n], tail)
        y, plain = EA.ell_apply(*args), EA.ell_apply_plain(*args)
        if not torch.equal(y, plain):
            raise AssertionError(f"ell_apply kernel != plain at R = {R}")
        cols = ell_columns_first(*args) if R > 1 else plain
        out["max_abs_err"] = max(
            out["max_abs_err"], float((y - plain).abs().max()),
            float((y - cols).abs().max()))
        bound_us = (16 * n * R + 12 * nnz) / HBM_BYTES_PER_S * 1e6
        us = device_ms(device, lambda: EA.ell_apply(*args), reps=15) * 1e3
        r = {"us": us,
             "plain_us": device_ms(device, lambda: EA.ell_apply_plain(*args),
                                   reps=3) * 1e3,
             "library_us": device_ms(device, lambda: csr @ x, reps=15) * 1e3,
             "library_max_abs_err": assert_close(
                 csr @ x, y, f"CSR product vs ell_apply at R = {R}"),
             "bound_us": bound_us, "bound_by": "bytes",
             "share_of_bound": bound_us / us}
        if R > 1:
            r["columns_first_plain_us"] = device_ms(
                device, lambda: ell_columns_first(*args), reps=3) * 1e3
        out[f"r{R}"] = r
        del x, args, y, plain, cols
    del csr
    EA.ell_apply.launches = counted
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def ell_kernel_line(k, launches_d1, launches_d4):
    """The ELL apply kernel's entry of the kernels line: ``local_full``'s
    ``ell_kernel`` timings (chain_32_symm, D = 1) and the launches counted
    from 0 on the main path's ell engines (``local_full``'s applies and
    Lanczos at D = 1, the sharded leg's ell engine at D = 4), each with
    its launches per apply as measured over one apply."""
    return {
        "name": "ell_apply",
        "route": "cuda",
        "source": "distributed_matvec_tpu_torch/csrc/ell_apply.cu",
        # the JAX ELL apply is XLA gathers: no Pallas kernel to replace
        "replaces": None,
        "launches": launches_d1["launches"] + launches_d4["launches"],
        "launches_d1": launches_d1["launches"],
        "launches_per_apply_d1": launches_d1["launches_per_apply"],
        "launches_d4": launches_d4["launches"],
        "launches_per_apply_d4": launches_d4["launches_per_apply"],
        # against the plain version, state-major and columns-first
        "max_abs_err": k["max_abs_err"],
        "ms": k["r1"]["us"] / 1e3, "plain_ms": k["r1"]["plain_us"] / 1e3,
        "bound_ms": k["r1"]["bound_us"] / 1e3, "bound_by": "bytes",
        # cuSPARSE through torch: csr @ x over the same tables
        "library_ms": k["r1"]["library_us"] / 1e3,
        "ms_r4": k["r4"]["us"] / 1e3,
        # the engine's apply before the kernel (columns first), and the
        # plain version in the kernel's state-major layout
        "plain_ms_r4": k["r4"]["columns_first_plain_us"] / 1e3,
        "plain_state_major_ms_r4": k["r4"]["plain_us"] / 1e3,
        "bound_ms_r4": k["r4"]["bound_us"] / 1e3,
        "library_ms_r4": k["r4"]["library_us"] / 1e3,
    }


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


# -- the solve service ----------------------------------------------------------

#: the serve phase's engine-pool budget (GB): the chain_32_symm ell tables
#: (1.17 GB) and streamed lossless plan (0.86 GB) together; the config's
#: 2.0 GB default is just below their sum and would evict one for the other
RESILIENCE_APPLIES = 7
RESILIENCE_LANCZOS_STEPS = 64
PROFILE_EVERY = 4
PROFILE_APPLIES = 16


def dispatch_walls(device, eng, x, applies):
    """Host ms of each of ``applies`` applies from the call to its return,
    the device idle before each and drained after (not timed): an apply
    that waited on the device would show its device time here."""
    walls = []
    for _ in range(applies):
        _sync(device)
        t0 = time.perf_counter()
        eng.matvec(x)
        walls.append((time.perf_counter() - t0) * 1e3)
        _sync(device)
    return walls


def _env(**kw):
    """Set (value) or clear (None) environment variables; returns the
    previous values for :func:`_env` to restore."""
    prev = {k: os.environ.get(k) for k in kw}
    for k, v in kw.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return prev


def resilience_phase(device, full_eng, ell_eng):
    """Fault tolerance and the rest of ``obs/`` on the full leg's streamed
    engine (D = 1, lossless, the decode kernel) and ``local_full``'s ell
    engine; see the module docstring.  Returns (info, launches)."""
    import tempfile

    import numpy as np
    import torch

    from distributed_matvec_tpu_torch import LocalEngine, lanczos, obs
    from distributed_matvec_tpu_torch.obs import health, memory, roofline
    from distributed_matvec_tpu_torch.obs import profile as obs_profile
    from distributed_matvec_tpu_torch.ops import cuda_kernels
    from distributed_matvec_tpu_torch.ops import plan_codec as PC
    from distributed_matvec_tpu_torch.utils import faults
    from distributed_matvec_tpu_torch.utils.config import update_config

    engines = {"streamed": full_eng, "ell": ell_eng}
    kinds = {"streamed": "distributed", "ell": "local"}
    xs = {"streamed": full_eng.random_hashed(41),
          "ell": torch.from_numpy(np.random.default_rng(41).standard_normal(
              ell_eng.n_states)).to(device)}
    cfg = update_config()
    saved = (cfg.health_every, cfg.profile_every, cfg.profile_overhead_pct)
    tmp = tempfile.mkdtemp(prefix="dmt_resilience_")
    prev = _env(DMT_HEALTH="on", DMT_FAULT=None, DMT_PROFILE="off")
    prev_obs = {k: os.environ.get(k) for k in ("DMT_OBS_DIR", "DMT_PHASES")}
    faults.reset()
    out = {"engines": {k: f"{kinds[k]}/{e.mode}" for k, e in
                       engines.items()}}
    launches0 = PC.fused_decode_gather_scatter.launches
    try:
        # -- health: every apply probed; medians with the probes off and
        #    on, in turns; the host's dispatch time shows any wait
        update_config(health_every=1)
        medians = {}
        for name, eng in engines.items():
            x = xs[name]
            walls = {"off": [], "on": []}
            disp = {"off": [], "on": []}
            for mode in ("off", "on", "off", "on"):
                os.environ["DMT_HEALTH"] = mode
                walls[mode] += apply_walls(device, eng, x,
                                           RESILIENCE_APPLIES)
                disp[mode] += dispatch_walls(device, eng, x,
                                             RESILIENCE_APPLIES)
            health.drain(block=True)
            medians[name] = {
                f"probes_{m}_ms_median": statistics.median(walls[m])
                for m in walls}
            medians[name].update({
                f"probes_{m}_dispatch_ms_median": statistics.median(disp[m])
                for m in disp})
        out["apply_ms"] = medians
        os.environ["DMT_HEALTH"] = "on"
        counters = obs.snapshot()["counters"]
        nonfinite0 = counters.get("matvec_nonfinite{engine=distributed}", 0)
        events0 = health.health_event_count()
        ledger_mid = {}
        inner = full_eng.matvec

        def spying(self, x, check=None):
            # the ledger as the solve holds it (its Krylov workspace live)
            if not ledger_mid:
                ledger_mid.update(memory.ledger_entries())
            return inner(x, check)

        full_eng.matvec = types.MethodType(spying, full_eng)
        try:
            t0 = time.perf_counter()
            res = lanczos(full_eng.matvec, v0=full_eng.random_hashed(0),
                          k=1, max_iters=RESILIENCE_LANCZOS_STEPS,
                          tol=1e-30)
            _sync(device)
            lz_s = time.perf_counter() - t0
        finally:
            del full_eng.matvec
        nonfinite = obs.snapshot()["counters"].get(
            "matvec_nonfinite{engine=distributed}", 0) - nonfinite0
        solver_events = health.health_event_count() - events0
        if res.num_iters != RESILIENCE_LANCZOS_STEPS or nonfinite \
                or solver_events:
            raise AssertionError(
                f"probed Lanczos: {res.num_iters} steps, {nonfinite} "
                f"nonfinite outputs, {solver_events} health events")
        # a NaN in x: one critical event at the next apply's drain
        x_nan = xs["ell"].clone()
        x_nan[3] = float("nan")
        seen0 = len(obs.events("health"))
        ell_eng.matvec(x_nan)
        queued = health.pending_count()
        inline = len(obs.events("health")) - seen0
        ell_eng.matvec(xs["ell"])
        evs = obs.events("health")[seen0:]
        if inline or len(evs) != 1 or evs[0]["check"] != "nonfinite_output" \
                or evs[0]["level"] != "critical":
            raise AssertionError(f"NaN probe: {inline} events inline, then "
                                 f"{[(e['check'], e['level']) for e in evs]}")
        os.environ["DMT_HEALTH"] = "strict"
        try:
            ell_eng.matvec(x_nan)
            raise AssertionError("DMT_HEALTH=strict: no HealthError")
        except health.HealthError as e:
            strict = str(e)[:120]
        os.environ["DMT_HEALTH"] = "on"
        out["health"] = {
            "lanczos_steps": int(res.num_iters), "lanczos_s": lz_s,
            "solver_health_events": solver_events,
            "matvec_nonfinite": nonfinite,
            "nan_probe": {"queued_after_apply": queued,
                          "events_inline": inline,
                          "event": {k: evs[0][k] for k in
                                    ("check", "level", "engine", "apply",
                                     "count")},
                          "strict": strict}}
        del res, x_nan

        # -- memory: the ledger the solve saw, watermarks, a real OOM, the
        #    decode kernel's attributes
        by_part = {}
        for path, ent in ledger_mid.items():
            top = "/".join(path.split("/")[:2])
            by_part[top] = by_part.get(top, 0) + ent["bytes"]
        wm = memory.sample_watermark("resilience")
        marks = [{k: e.get(k) for k in ("tag", "bytes_in_use", "peak_bytes",
                                        "bytes_free")}
                 for e in obs.events("memory_watermark")[-6:]]
        peak = torch.cuda.max_memory_allocated(device)
        if wm is None or wm["peak_bytes"] != peak:
            raise AssertionError(f"watermark {wm} against "
                                 f"max_memory_allocated {peak}")
        release(device)
        free, total = torch.cuda.mem_get_info(device)
        ballast_bytes = max(int(free) - (1 << 30), 0)
        ballast = torch.empty(ballast_bytes, dtype=torch.uint8, device=device)
        h = memory.track("ballast", ballast_bytes, device="device")
        rep = None
        t0 = time.perf_counter()
        try:
            LocalEngine(full_eng.operator, device=device)
        except memory.OomError as e:
            rep = e.report
        finally:
            oom_s = time.perf_counter() - t0
            h.release()
            del ballast
            release(device)
        if rep is None or "ballast" not in rep["ledger"]["children"] \
                or not rep["remediation"] or rep["watermark"] is None:
            raise AssertionError("LocalEngine beside the ballast: no OomError "
                                 "with a report naming the ballast")
        attrs = {f"u{b}_{'buckets' if k else 'd1'}":
                 cuda_kernels.kernel_attributes(b, k)
                 for b in (8, 16) for k in (False, True)}
        out["memory"] = {
            "ledger_during_lanczos": {p: e["bytes"]
                                      for p, e in sorted(ledger_mid.items())},
            "ledger_by_part": by_part,
            "watermarks": marks,
            "watermark_peak_vs_max_memory_allocated": [wm["peak_bytes"],
                                                       peak],
            "oom": {"ballast_bytes": ballast_bytes, "seconds": oom_s,
                    "context": rep["context"],
                    "ledger_total_bytes": rep["ledger_total_bytes"],
                    "ledger_ballast_bytes":
                        rep["ledger"]["children"]["ballast"]["bytes"],
                    "allocated_bytes": rep["watermark"]["bytes_in_use"],
                    "peak_bytes": rep["watermark"]["peak_bytes"],
                    "headroom_bytes": rep["watermark"]["bytes_free"],
                    "remediation": len(rep["remediation"]),
                    "first_remedy": rep["remediation"][0][:80]},
            "fused_decode_attributes": attrs}

        # -- faults: plan_upload heals bit-equal; exchange raises before
        #    any device work and the next apply is clean
        x = xs["streamed"]
        y_clean = deterministic(lambda: full_eng.matvec(x))
        os.environ["DMT_FAULT"] = "plan_upload:n=2"
        faults.reset()
        y = deterministic(lambda: full_eng.matvec(x))
        fired_upload = faults.fired_count("plan_upload")
        if fired_upload != 2 or not torch.equal(y, y_clean):
            raise AssertionError(f"plan_upload:n=2 fired {fired_upload}, "
                                 f"bit-equal {torch.equal(y, y_clean)}")
        os.environ["DMT_FAULT"] = "exchange:n=1"
        faults.reset()
        full_eng.pipeline_depth = 2
        n_applies = full_eng.n_applies
        try:
            full_eng.matvec(x)
            raise AssertionError("exchange:n=1 did not raise")
        except RuntimeError as e:
            if "[fault-injection]" not in str(e):
                raise
            exchange_msg = str(e)
        if full_eng.n_applies != n_applies:
            raise AssertionError("the exchange fault fired after device work")
        y = deterministic(lambda: full_eng.matvec(x))
        full_eng.pipeline_depth = 0
        if not torch.equal(y, y_clean):
            raise AssertionError("the apply after the exchange fault differs")
        os.environ.pop("DMT_FAULT")
        faults.reset()
        out["faults"] = {
            "plan_upload_fired": fired_upload,
            "plan_upload_bit_equal": True,
            "exchange_message": exchange_msg,
            "exchange_next_apply_bit_equal_depth2": True,
            "unset_apply_ms_median": statistics.median(
                apply_walls(device, full_eng, x, RESILIENCE_APPLIES))}
        del y, y_clean

        # -- profile: sampled windows, the overhead guard, kernel costs and
        #    the roofline's measured column (phases on for these applies)
        _env(DMT_OBS_DIR=tmp, DMT_PROFILE="sampled", DMT_PHASES="on")
        update_config(profile_every=PROFILE_EVERY, profile_overhead_pct=1e9)
        obs_profile.reset_profile()
        prof, tables = {}, {}
        for name, eng in engines.items():
            caps0 = len(obs.events("profile_captured"))
            for _ in range(PROFILE_APPLIES):
                eng.matvec(xs[name])
            _sync(device)
            caps = obs.events("profile_captured")[caps0:]
            table = tables[name] = obs_profile.last_sample()
            want = len([i for i in range(eng._apply_idx - PROFILE_APPLIES,
                                         eng._apply_idx)
                        if i and i % PROFILE_EVERY == 0])
            if len(caps) != want or want != PROFILE_APPLIES // PROFILE_EVERY:
                raise AssertionError(f"{name}: {len(caps)} sampled windows, "
                                     f"expected {want}")
            phases = {}
            for o in table["ops"]:
                phases.setdefault(o["phase"], []).append(o["name"])
            prof[name] = {
                "windows": len(caps),
                "traces": sorted(os.listdir(os.path.join(
                    tmp, "rank_0", "profiles"))),
                "device_ms": table["totals"]["ms"],
                "phase_ms": {p: r["ms"] for p, r in table["phases"].items()},
                "overhead_kernels": phases.get("overhead", []),
                "top": [(o["name"][:60], o["phase"], o["ms"])
                        for o in table["ops"][:6]]}
        # the streamed window's whole table: the decode kernel in compute
        # (≈ 1 % of the apply, below the event's top rows), index_add_'s
        # kernels in accumulate
        ops = tables["streamed"]["ops"]
        k8 = [(o["name"][:60], o["phase"], o["ms"], o["calls"]) for o in ops
              if "fused_decode" in o["name"]]
        acc = [(o["name"][:60], o["ms"]) for o in ops
               if o["phase"] == "accumulate"]
        if not k8 or any(k[1] != "compute" for k in k8) or not acc \
                or not any("index" in a[0].lower() for a in acc):
            raise AssertionError(
                f"kernel costs of a streamed apply: decode kernel {k8}, "
                f"accumulate {acc}")
        prof["streamed"]["decode_kernel"] = k8
        prof["streamed"]["accumulate"] = acc
        rep = roofline.roofline_report(obs.events())
        third = {g: {p: a.get("device_ms") for p, a in grp["phases"].items()}
                 for g, grp in rep["groups"].items()}
        for g in ("distributed/streamed", "local/ell"):
            if not any(v for v in third.get(g, {}).values()):
                raise AssertionError(f"roofline: no measured device ms for "
                                     f"{g}: {third.get(g)}")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            roofline.print_roofline(rep)
        snap = obs_profile.overhead_snapshot()
        out["profile"] = {
            "every": PROFILE_EVERY, "applies": PROFILE_APPLIES,
            "engines": prof,
            "overhead_pct": snap["overhead_pct"],
            "would_latch_at_2pct": snap["overhead_pct"] > 2.0,
            "roofline_device_ms": third,
            "roofline_wall_ms": {g: grp["wall_ms"]
                                 for g, grp in rep["groups"].items()},
            "roofline_report": text.getvalue().splitlines()}
    finally:
        _env(**prev)
        _env(**prev_obs)
        update_config(health_every=saved[0], profile_every=saved[1],
                      profile_overhead_pct=saved[2])
        faults.reset()
    launches = PC.fused_decode_gather_scatter.launches - launches0
    if launches == 0 or launches % full_eng.nchunks:
        raise AssertionError(f"{launches} decode launches in the phase "
                             f"({full_eng.nchunks} chunks per apply)")
    out["launches"] = launches
    return out, launches


# -- caches (after resilience) ---------------------------------------------------

#: the disk tier's RAM budget in the caches leg: below the chain_32_symm
#: plan's ≈ 0.86 GB, so a restore stays in its sidecar
CACHES_RAM_GB = 0.25


def cache_store(tmp):
    """Where the plan sidecars go: HDF5 files under ``tmp`` where ``h5py``
    imports, else the module-private in-memory store.  Returns (store or
    None, base path, route)."""
    from distributed_matvec_tpu_torch.parallel import plan_cache

    base = os.path.join(tmp, "plan")
    if importable("h5py"):
        return None, base, "file"
    return plan_cache._MemorySidecarStore(), base, "memory"


def flip_record_byte(store, sidecar, name, eng=None):
    """Flip the first byte of dataset ``name`` of a stream sidecar, in the
    memory store or (closing ``eng``'s cached handles first) the file."""
    import numpy as np

    if store is not None:
        store.files[sidecar].data[name].reshape(-1).view(np.uint8)[0] ^= 0xFF
        return
    import h5py

    from distributed_matvec_tpu_torch.parallel import plan_cache

    if eng is not None:
        plan_cache.close_plan_files(eng._plan_files)
    with h5py.File(sidecar, "r+") as f:
        ds = f["engine_structure"][name]
        a = ds[...]
        a.reshape(-1).view(np.uint8)[0] ^= 0xFF
        ds[...] = a


def caches_phase(device, full_eng):
    """The plan caches on the full leg's chain_32_symm streamed ``lossless``
    engine (D = 1, B = 65 536, 72 chunks); see the module docstring.
    Returns (info, launches, kernel error)."""
    import shutil
    import tempfile

    import torch

    from distributed_matvec_tpu_torch import DistributedEngine, obs
    from distributed_matvec_tpu_torch.ops import plan_codec as PC
    from distributed_matvec_tpu_torch.parallel import plan_cache
    from distributed_matvec_tpu_torch.utils.config import (get_config,
                                                           update_config)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_caches_")
    store, cache, route = cache_store(tmp)
    out = {"route": route, "h5py": importable("h5py"),
           "plan_bytes": int(full_eng.plan_bytes),
           "nchunks": full_eng.nchunks,
           "full_build_s": full_eng.timings["plan_build_s"]
           + full_eng.timings["plan_encode_s"]}
    op = full_eng.operator
    old_store, old_ram = full_eng._store, get_config().stream_plan_ram_gb
    kw = dict(device=device, mode="streamed", stream_compress="lossless",
              batch_size=full_eng.batch_size, structure_cache=cache,
              _sidecar_store=store)
    try:
        # 1. save the full engine's plan
        if store is not None:
            full_eng._store = store
        t0 = time.perf_counter()
        full_eng._save_stream_plan(cache)
        out["save_s"] = time.perf_counter() - t0
        sidecar = cache + f".dist{full_eng.n_devices}.stream.h5"
        out["sidecar_bytes"] = (
            sum(a.nbytes for a in store.files[sidecar].data.values())
            if store is not None else os.path.getsize(sidecar))
        x = full_eng.random_hashed(61)
        y_ref = full_eng.matvec(x)
        ram_ms = apply_walls(device, full_eng, x, 3)

        # 2. restore onto the disk tier: no build
        update_config(stream_plan_ram_gb=CACHES_RAM_GB)
        eng, restore_s, peak = build_timed(
            device, lambda: DistributedEngine(op, **kw))
        if not (eng.structure_restored and eng._plan_host is None
                and eng._plan_disk and "plan_build_s" not in eng.timings):
            raise AssertionError("the disk-tier engine did not restore "
                                 f"without a build: {eng.timings}")
        out["disk_restore"] = {"engine_s": restore_s,
                               "plan_restore_s": eng.timings[
                                   "plan_restore_s"],
                               "build_peak_bytes": peak}

        # 3. disk-tier applies, counted from 0: two at depth 0, one at 4
        PC.fused_decode_gather_scatter.launches = 0
        walls, errs = [], []
        for depth in (0, 0, 4):
            eng.pipeline_depth = depth
            _sync(device)
            t0 = time.perf_counter()
            y = eng.matvec(x)
            _sync(device)
            walls.append((time.perf_counter() - t0) * 1e3)
            errs.append(assert_close(y, y_ref, f"disk tier at depth {depth}"
                                     " vs the full engine"))
        launches = PC.fused_decode_gather_scatter.launches
        if device.type == "cuda" and launches != 3 * eng.nchunks:
            raise AssertionError(f"{launches} decode launches in 3 disk-tier "
                                 f"applies of {eng.nchunks} chunks")
        out["disk_apply_ms"] = walls
        out["ram_apply_ms"] = ram_ms
        out["disk_vs_full_max_abs_err"] = max(errs)
        out["depth4_fetch_wait_ms"] = eng.last_pipeline["fetch_wait_ms"]
        # the disk fetch's parts: read + checksum + pack, and the checksum
        # alone, over every record
        eng.pipeline_depth = 0
        t0 = time.perf_counter()
        for ci in range(eng.nchunks):
            eng._plan_chunk_host(ci)
        fetch_s = time.perf_counter() - t0
        g = (store.open(sidecar) if store is not None
             else plan_cache.Hdf5SidecarStore.open(sidecar))
        recs = [{k: g["engine_structure"][f"{k}_0_{ci}"][...]
                 for k in plan_cache.STREAM_ARRAYS + ("fill",)}
                for ci in range(eng.nchunks)]
        t0 = time.perf_counter()
        for pc in recs:
            plan_cache.plan_chunk_crc(pc)
            plan_cache.plan_chunk_crc(pc, ("fill",))
        crc_s = time.perf_counter() - t0
        g.close()
        del recs
        out["disk_fetch_s"] = fetch_s
        out["crc_s"] = crc_s
        out["crc_share_of_fetch"] = crc_s / fetch_s
        out["crc_share_of_apply"] = crc_s * 1e3 / statistics.median(walls[:2])

        # 4. one corrupt record: the next apply rebuilds it on the card
        ci = eng.nchunks // 2
        flip_record_byte(store, sidecar, f"dest_0_{ci}", eng)
        obs.reset_all()
        _sync(device)
        t0 = time.perf_counter()
        y = eng.matvec(x)
        _sync(device)
        rebuild_apply_ms = (time.perf_counter() - t0) * 1e3
        launches = PC.fused_decode_gather_scatter.launches
        rebuilt = eng._plan_repaired.get(ci)
        if rebuilt is None or not torch.equal(rebuilt,
                                              full_eng._plan_host[ci]):
            raise AssertionError(f"chunk {ci} was not rebuilt byte-equal "
                                 "to the full engine's record")
        if [e["chunk"] for e in obs.events("plan_chunk_rebuilt")] != [ci]:
            raise AssertionError("no plan_chunk_rebuilt event")
        out["rebuild"] = {
            "chunk": ci, "apply_ms": rebuild_apply_ms,
            "vs_full_max_abs_err": assert_close(y, y_ref, "the apply with "
                                                "a rebuilt chunk")}
        t0 = time.perf_counter()
        eng._rebuild_plan_chunk(ci)
        _sync(device)
        out["rebuild"]["chunk_s"] = time.perf_counter() - t0
        if device.type == "cuda" and launches != 4 * eng.nchunks:
            raise AssertionError(f"{launches} decode launches in 4 "
                                 f"disk-tier applies of {eng.nchunks}")
        # the decode kernel on the rebuilt record, against its plain version
        views = eng._chunk_views(rebuilt[0].to(device))
        xc = x[0, ci * eng.batch_size:(ci + 1) * eng.batch_size]
        kernel_err = check_kernel((eng._codec.spec, views[0], views[1],
                                   views[4], eng._cdict[0],
                                   xc.contiguous()))
        flip_record_byte(store, sidecar, f"dest_0_{ci}", eng)   # undo
        del eng, y

        # 5. restore into pinned RAM, byte-equal to the built plan
        update_config(stream_plan_ram_gb=old_ram)
        eng, ram_restore_s, _ = build_timed(
            device, lambda: DistributedEngine(op, **kw))
        if not (eng.structure_restored and eng._plan_host is not None
                and torch.equal(eng._plan_host, full_eng._plan_host)):
            raise AssertionError("the RAM restore is not byte-equal to the "
                                 "built plan")
        out["ram_restore"] = {"engine_s": ram_restore_s,
                              "plan_restore_s": eng.timings[
                                  "plan_restore_s"]}
        del eng
    finally:
        full_eng._store = old_store
        update_config(stream_plan_ram_gb=old_ram)
        if store is not None:
            store.files.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["launches"] = launches
    out["kernel_max_abs_err"] = kernel_err
    return out, launches, kernel_err


SERVE_POOL_GB = 4.0


def _chain32_basis(n=32):
    """chain_{n}_symm's basis as a job spec carries it (JSON lists)."""
    return {"number_spins": n, "hamming_weight": n // 2,
            "spin_inversion": 1,
            "symmetries": [[[*range(1, n), 0], 0],
                           [[*reversed(range(n))], 0]]}


def _read_events(run_dir):
    path = os.path.join(run_dir, "rank_0", "events.jsonl")
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _timed_engine(device, eng, log):
    """``eng.matvec`` as a bound wrapper that synchronizes around each
    apply and appends ``(start, seconds)`` to ``log`` (the solvers still
    see the engine behind it as ``matvec.__self__``)."""
    def matvec(self, x, *args, **kwargs):
        _sync(device)
        t0 = time.time()
        y = type(self).matvec(self, x, *args, **kwargs)
        _sync(device)
        log.append((t0, time.time() - t0))
        return y

    eng.matvec = types.MethodType(matvec, eng)
    return eng


def _service_argv(spool, run_dir, hbm_gb):
    return [sys.executable, "-m",
            "distributed_matvec_tpu_torch.apps.solve_service", spool,
            "--drain", "--obs-dir", run_dir, "--hbm-gb", repr(hbm_gb)]


#: the serve SIGTERM leg's ring (cut from chain_{CUT_N}_symm to fit the
#: time limit), and the delay each solver block takes in the first service
#: process, so that SIGTERM finds its jobs running
SERVE_PREEMPT_N = 24
SERVE_PREEMPT_FAULT = "solver_block:delay=300:n=100000"


def serve_preempt_leg(device, tmp, hbm_gb):
    """The service process under SIGTERM: two ell eigs jobs on
    chain_{SERVE_PREEMPT_N}_symm (cut from chain_32_symm, then from
    chain_{CUT_N}_symm, to fit the time limit: each process enumerates its
    basis), every solver block of the first process stretched by
    ``SERVE_PREEMPT_FAULT``; SIGTERM once both run, exit 75 with both still
    spooled, then the same argv again (no fault) drains them to the E0 of
    an in-process ``LocalEngine`` solve of the same operator (1e-10)."""
    import signal as _signal

    from distributed_matvec_tpu_torch import LocalEngine, lanczos
    from distributed_matvec_tpu_torch.models.lattices import heisenberg_chain
    from distributed_matvec_tpu_torch.serve import JobSpec, submit_to_spool

    op = heisenberg_chain(SERVE_PREEMPT_N, symmetric=True)
    op.basis.build()
    n_states = int(op.basis.number_states)
    ref = LocalEngine(op, device=device)
    e0_served = float(lanczos(ref.matvec, n=n_states, k=1, tol=1e-10,
                              device=device).eigenvalues[0])
    del ref, op
    release(device)
    basis = _chain32_basis(SERVE_PREEMPT_N)
    spool, run_dir = os.path.join(tmp, "spool_pre"), \
        os.path.join(tmp, "run_pre")
    for i in range(2):
        submit_to_spool(spool, JobSpec(job_id=f"pre{i}", basis=basis, k=1,
                                       tol=1e-10, n_states=n_states))
    argv = _service_argv(spool, run_dir, hbm_gb)
    # the environment's DMT_OBS_DIR would outrank --obs-dir
    env = {k: v for k, v in os.environ.items() if k != "DMT_OBS_DIR"}
    env["PYTHONPATH"] = ROOT
    events = os.path.join(run_dir, "rank_0", "events.jsonl")
    out = {}
    t0 = time.perf_counter()
    with open(os.path.join(tmp, "preempt_log.txt"), "w") as log:
        proc = subprocess.Popen(argv, cwd=ROOT,
                                env=dict(env, DMT_FAULT=SERVE_PREEMPT_FAULT),
                                stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 300
            while True:
                if os.path.exists(events):
                    with open(events) as f:
                        if '"status": "running"' in f.read():
                            break
                if proc.poll() is not None:
                    raise AssertionError(
                        f"the service exited {proc.returncode} before its "
                        "jobs ran")
                if time.monotonic() > deadline:
                    raise AssertionError("no running job within 300 s")
                time.sleep(0.05)
            out["to_running_s"] = time.perf_counter() - t0
            t_sig = time.perf_counter()
            proc.send_signal(_signal.SIGTERM)
            rc = proc.wait(timeout=300)
            out["sigterm_to_exit_s"] = time.perf_counter() - t_sig
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    queued = sorted(os.listdir(os.path.join(spool, "queue")))
    done = os.listdir(os.path.join(spool, "done"))
    out.update(exit_code=rc, queued_after=queued, done_after=done)
    if not (rc == 75 and queued == ["pre0.json", "pre1.json"]
            and done == []):
        with open(os.path.join(tmp, "preempt_log.txt")) as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"SIGTERM: exit {rc}, queue {queued}, done "
                             f"{done}\n{tail}")
    t0 = time.perf_counter()
    again = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=600)
    out["relaunch_s"] = time.perf_counter() - t0
    out["relaunch_exit_code"] = again.returncode
    if again.returncode != 0:
        raise AssertionError(f"relaunch exited {again.returncode}:\n"
                             f"{again.stdout[-2000:]}{again.stderr[-2000:]}")
    e0s = []
    for i in range(2):
        with open(os.path.join(spool, "done", f"pre{i}.json")) as f:
            rec = json.load(f)
        if rec["status"] != "done":
            raise AssertionError(f"relaunched pre{i}: {rec['status']}")
        e0s.append(rec["eigenvalues"][0])
    out["n"] = SERVE_PREEMPT_N
    out["e0"] = e0s
    out["e0_in_process"] = e0_served
    out["e0_minus_served"] = [e - e0_served for e in e0s]
    if not all(abs(e - e0_served) < 1e-10 for e in e0s):
        raise AssertionError(f"relaunched E0s {e0s} != the in-process "
                             f"{e0_served}")
    return out


def serve_phase(device, e0_full):
    """The port's ``SolveService`` draining a spool of chain_32_symm jobs
    on the card; see the module docstring for the jobs and the checks."""
    import tempfile

    import numpy as np
    import torch

    from distributed_matvec_tpu_torch import kpm_dos, lanczos_block, obs
    from distributed_matvec_tpu_torch.ops import plan_codec as PC
    from distributed_matvec_tpu_torch.serve import (EnginePool, JobSpec,
                                                    SolveService,
                                                    build_engine,
                                                    submit_to_spool)
    from distributed_matvec_tpu_torch.utils.config import (get_config,
                                                           update_config)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    spool, run_dir = os.path.join(tmp, "spool"), os.path.join(tmp, "run")
    saved_env = os.environ.get("DMT_OBS_DIR")
    saved_cfg = (get_config().stream_compress, get_config().serve_pool_gb)
    os.environ["DMT_OBS_DIR"] = run_dir
    obs.reset()
    obs.reset_trace()
    update_config(stream_compress="lossless", serve_pool_gb=SERVE_POOL_GB)
    hbm_gb = torch.cuda.get_device_properties(device).total_memory / 1e9
    basis = _chain32_basis()
    common = {"basis": basis, "n_states": CHAIN32_STATES}
    specs = [JobSpec(job_id=f"ell{i}", k=1, tol=tol, **common)
             for i, tol in enumerate((1e-10, 1e-9, 1e-10, 1e-8))]
    specs += [JobSpec(job_id="streamed", k=2, tol=1e-10, mode="streamed",
                      **common),
              JobSpec(job_id="kpm", solver="kpm", n_moments=128,
                      n_vectors=4, **common),
              JobSpec(job_id="evolve", solver="evolve", t_final=0.25,
                      tol=1e-10, **common),
              # 40 spins with no n_states: priced at C(40, 20) rows
              JobSpec(job_id="too_big", basis={"number_spins": 40,
                                               "hamming_weight": 20})]
    for s in specs:                 # stamped in this order: FIFO
        submit_to_spool(spool, s)

    builds, applies = {}, {}

    def builder(spec):
        t0 = time.perf_counter()
        eng = build_engine(spec, live_devices=1, device=device)
        _sync(device)
        builds[spec.mode] = time.perf_counter() - t0
        applies[spec.mode] = []
        return _timed_engine(device, eng, applies[spec.mode])

    pool = EnginePool(builder=builder, device=device)
    svc = SolveService(spool, pool=pool, hbm_gb=hbm_gb)
    try:
        # the main path, with the launch counts set to 0 just before it
        PC.fused_decode_gather_scatter.launches = 0
        t0 = time.perf_counter()
        rc = svc.run(drain=True)
        _sync(device)
        drain_s = time.perf_counter() - t0
        launches = PC.fused_decode_gather_scatter.launches
        obs.flush()
        if rc != 0:
            raise AssertionError(f"the service exited {rc}")
        recs = {}
        for s in specs:
            with open(os.path.join(spool, "done",
                                   f"{s.job_id}.json")) as f:
                recs[s.job_id] = json.load(f)
        status = {j: r["status"] for j, r in recs.items()}
        want = {s.job_id: "rejected" if s.job_id == "too_big" else "done"
                for s in specs}
        if status != want:
            raise AssertionError(f"job statuses {status}")
        counts = (pool.builds, pool.hits, pool.evictions)
        if counts != (2, 2, 0):
            raise AssertionError(f"pool builds/hits/evictions {counts}")
        if launches == 0:
            raise AssertionError("the streamed job launched no decode "
                                 "kernel")
        info = {"n_states": CHAIN32_STATES, "pool_gb": SERVE_POOL_GB,
                "hbm_gb": hbm_gb, "drain_s": drain_s,
                "pool": {"builds": pool.builds, "hits": pool.hits,
                         "evictions": pool.evictions,
                         "bytes": pool.total_bytes()},
                "build_s": builds, "launches_serve": launches,
                "latency_ms": {j: r.get("latency_ms")
                               for j, r in recs.items()},
                "reject_reason": recs["too_big"].get("reason")}

        # E0s: 1e-9 of the CPU value, or the residual's bound if larger
        e0s = {}
        for s in specs[:5]:
            r = recs[s.job_id]
            e0, res = r["eigenvalues"][0], r["residuals"][0]
            bound = max(1e-9, res)
            e0s[s.job_id] = {"e0": e0, "residual": res, "iters": r["iters"],
                             "minus_cpu": e0 - CHAIN32_E0_CPU,
                             "bound": bound}
            if not (r["converged"] and abs(e0 - CHAIN32_E0_CPU) <= bound):
                raise AssertionError(f"{s.job_id}: E0 {e0} vs "
                                     f"{CHAIN32_E0_CPU} (bound {bound})")
        info["eigs"] = e0s
        info["streamed_eigenvalues"] = recs["streamed"]["eigenvalues"]

        # the batch, from the trace: serve_batch spans and job spans
        evs = _read_events(run_dir)
        spans = [e for e in evs if e["kind"] == "span"]
        batches = {e["span_id"]: e for e in spans if e["cat"] == "batch"}
        jobs = [e for e in spans if e["cat"] == "job"]
        if sorted(e["name"] for e in jobs) != sorted(
                f"job:{s.job_id}" for s in specs[:7]):
            raise AssertionError(f"job spans {[e['name'] for e in jobs]}")
        for e in jobs:
            if e["parent_span_id"] not in batches:
                raise AssertionError(f"{e['name']} is no child of a "
                                     "serve_batch span")
        for s in specs:
            seq = [e["status"] for e in evs if e["kind"] == "job_event"
                   and e.get("job_id") == s.job_id]
            want_seq = ["queued", "rejected"] if s.job_id == "too_big" \
                else ["queued", "running", "done"]
            if seq != want_seq:
                raise AssertionError(f"{s.job_id} events {seq}")
        # each batch span holds its engine's build (a pool miss): the
        # solve is the span less the build
        def batch_info(span, mode):
            t0, span_s = span["t0"], span["dur_ms"] / 1e3
            inside = [d for t, d in applies[mode] if t0 <= t <= t0 + span_s]
            solve_s = span_s - builds[mode]
            return {"span_s": span_s, "build_s": builds[mode],
                    "solve_s": solve_s, "block_applies": len(inside),
                    "apply_seconds": sum(inside),
                    "share_outside_applies": 1.0 - sum(inside) / solve_s}

        ell_batch = next(b for b in batches.values() if b["jobs"] == 4)
        info["batch4"] = dict(batch_info(ell_batch, "ell"), columns=max(
            r["iters"] for j, r in recs.items() if j.startswith("ell")))
        st_batch = next(b for b in batches.values()
                        if b["engine_key"] == specs[4].engine_key())
        info["streamed_batch"] = dict(batch_info(st_batch, "streamed"),
                                      columns=recs["streamed"]["iters"])
        info["batches"] = sorted(
            ({"jobs": b["jobs"], "seconds": b["dur_ms"] / 1e3}
             for b in batches.values()), key=lambda b: -b["jobs"])
        st = [d for _, d in applies["streamed"]]
        info["streamed_apply_ms"] = {
            "applies": len(st), "median": statistics.median(st) * 1e3,
            "mean": sum(st) / len(st) * 1e3}

        # each batched job against a solo lanczos_block on the same engine
        ell_eng = pool._engines[specs[0].engine_key()]
        solo = {}
        for s in specs[:4]:
            r = lanczos_block(ell_eng.matvec, n=ell_eng.n_states, k=s.k,
                              tol=s.tol, max_iters=s.max_iters,
                              seed=s.column_seed(), device=device)
            w_b = recs[s.job_id]["eigenvalues"][0]
            w_s = float(r.eigenvalues[0])
            solo[s.job_id] = w_b - w_s
            if not abs(w_b - w_s) <= 1e-10 * abs(w_s):
                raise AssertionError(f"{s.job_id}: batched {w_b} vs solo "
                                     f"{w_s}")
        info["batched_minus_solo"] = solo
        # the batch replayed with its start block drawn here, column j from
        # job j's column_seed, and job j's target on column j: every job's
        # eigenvalue and iteration count must come out as its record says,
        # so a batch whose seeds or targets were out of order would fail
        V0 = np.stack([np.random.default_rng(s.column_seed()).standard_normal(
            ell_eng.n_states) for s in specs[:4]], axis=1)
        V0 /= np.linalg.norm(V0, axis=0, keepdims=True)
        rep = lanczos_block(
            ell_eng.matvec, k=1, block_size=4, V0=V0,
            max_iters=max(s.max_iters for s in specs[:4]),
            tol=min(s.tol for s in specs[:4]),
            column_targets=[{"k": s.k, "tol": s.tol,
                             "max_iters": s.max_iters, "job_id": s.job_id}
                            for s in specs[:4]], device=device)
        info["replay_iters"] = {}
        for s, cr in zip(specs[:4], rep.column_results):
            rec = recs[s.job_id]
            w = float(np.atleast_1d(cr["eigenvalues"])[0])
            info["replay_iters"][s.job_id] = int(cr["iters"])
            if int(cr["iters"]) != rec["iters"] or not abs(
                    w - rec["eigenvalues"][0]) <= 1e-12 * abs(w):
                raise AssertionError(
                    f"{s.job_id}: replay {w} after {cr['iters']} columns, "
                    f"record {rec['eigenvalues'][0]} after {rec['iters']}")

        # the kpm job against kpm_dos called directly with its seed
        kspec = specs[5]
        _, rho, kres = kpm_dos(ell_eng.matvec, n_moments=128,
                               n=ell_eng.n_states, n_vectors=4,
                               seed=kspec.column_seed(), device=device)
        krec = recs["kpm"]
        dmu = float(np.abs(np.asarray(krec["moments_head"])
                           - kres.moments[:8]).max())
        # the record keeps 8 moments; its DOS peak depends on all 128
        dpeak = abs(krec["dos_peak"] - float(np.max(rho)))
        info["kpm"] = {"moments_max_abs_diff": dmu,
                       "dos_peak_abs_diff": dpeak,
                       "moments_per_s": krec["moments_per_s"],
                       "bounds": krec["bounds"]}
        if not (dmu < 1e-12 and dpeak <= 1e-10 * abs(krec["dos_peak"])
                and krec["iters"] == kres.num_applies
                and np.allclose(krec["bounds"], kres.bounds, rtol=1e-12,
                                atol=0)):
            raise AssertionError(f"kpm job: moments differ by {dmu}, DOS "
                                 f"peak by {dpeak}, record {krec} against "
                                 f"{kres.num_applies} applies, bounds "
                                 f"{kres.bounds}")
        info["evolve"] = {k: recs["evolve"][k] for k in
                          ("steps", "norm_drift", "energy_drift",
                           "energy_final", "converged")}

        # the decode kernel against its plain version on one of the
        # served streamed engine's own chunks
        st_eng = pool._engines[specs[4].engine_key()]
        ci = st_eng.nchunks // 3
        views = st_eng._chunk_views(st_eng._plan_host[ci, 0].to(device))
        x_c = torch.from_numpy(np.random.default_rng(19).standard_normal(
            st_eng.batch_size)).to(device)
        info["kernel_max_abs_err"] = check_kernel(
            (st_eng._codec.spec, views[0], views[1], views[4],
             st_eng._cdict[0], x_c))
        info["streamed_kernel"] = st_eng.stream_kernel

        del ell_eng, st_eng
        pool._engines.clear()
        release(device)
        info["preempt"] = serve_preempt_leg(device, tmp, hbm_gb)
    finally:
        update_config(stream_compress=saved_cfg[0],
                      serve_pool_gb=saved_cfg[1])
        if saved_env is None:
            os.environ.pop("DMT_OBS_DIR", None)
        else:
            os.environ["DMT_OBS_DIR"] = saved_env
        obs.reset()
        obs.reset_trace()
    return info, launches, info["kernel_max_abs_err"]


#: the sharded leg: shards on the one card, and the row chunk that keeps a
#: chunk's ~85 k live entries per bucket under the 150 000 default (the
#: default B = 65 536 would put ~339 k in each and overflow)
SHARDS = 4
SHARDED_BATCH = 16384


def sharded_phase(device, op, ell_ref, D=SHARDS, B=SHARDED_BATCH,
                  applies=7):
    """``DistributedEngine(op, n_devices=D, mode=m)`` in every ported mode
    on the one card; see the module docstring for the checks."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from distributed_matvec_tpu_torch import DistributedEngine
    from distributed_matvec_tpu_torch.ops import ell_apply as EA
    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    n = op.basis.number_states
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(n)).to(
        device)
    y_ref = ell_ref.matvec(x)
    x_np = x.cpu().numpy()
    out = {"n_states": n, "n_shards": D, "batch_size": B}
    kernel = {"engines": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    store, cache, route = cache_store(tmp)
    out["cache_route"] = route

    def make(mode):
        # the ell engine saves its routing plan (and a second restores it)
        cached = dict(structure_cache=cache, _sidecar_store=store) \
            if mode == "ell" else {}
        return DistributedEngine(op, n_devices=D, mode=mode, batch_size=B,
                                 device=device, stream_compress="lossless",
                                 **cached)

    # compact runs on chain_{COMPACT_N}_symm below (cut to fit the limit)
    for mode in ("streamed", "ell", "fused"):
        eng, build_s, peak = build_timed(device, lambda: make(mode))
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
        if mode == "ell":
            EA.ell_apply.launches = 0
        t0 = time.perf_counter()
        y = torch.from_numpy(eng.matvec_global(x_np)).to(device)
        _sync(device)
        info["first_apply_s"] = time.perf_counter() - t0
        info["vs_local_ell_max_abs_err"] = assert_close(
            y, y_ref, f"D = {D} {mode} vs LocalEngine ell apply")
        xh = eng.to_hashed(x_np)
        if mode != "fused":
            # a fused apply takes ≈ 11 s: its first apply's seconds are
            # its time (to fit the time limit)
            info.update(apply_times(device, eng, xh, applies=applies))
        if mode in ("streamed", "ell") and device.type == "cuda":
            info["profile"] = profile_apply(lambda: eng.matvec(xh))
        if mode == "ell":
            before = EA.ell_apply.launches
            eng.matvec(xh)
            per_apply = EA.ell_apply.launches - before
            live = sum(1 for s in (eng._ell_tail_live or []) if s)
            if per_apply != eng.n_devices + live:
                raise AssertionError(
                    f"{per_apply} ell_apply launches in one D = {D} apply "
                    f"({live} shards with a tail)")
            # the Lanczos solves here are cut (time limit): the applies are
            # held to the LocalEngine ell apply above, whose E0 is the
            # full leg's; the saved routing plan restores with no build
            info["cache"] = structure_roundtrip(device, eng,
                                                lambda: make(mode), y)
            kernel["ell_launches"] = {"launches": EA.ell_apply.launches,
                                      "launches_per_apply": per_apply}
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
    if store is not None:
        store.files.clear()
    out["compact"] = sharded_compact_leg(device, D, B, applies, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    return out, kernel


def structure_roundtrip(device, eng, make, y):
    """A second engine from ``make()`` must restore ``eng``'s saved routing
    plan with no build, its ``structure_arrays()`` equal and one apply
    within atol 1e-13 / rtol 1e-12 of ``y`` (``eng``'s apply, block
    order).  Returns the build's and the restore's seconds."""
    import numpy as np
    import torch

    again, restore_s, peak = build_timed(device, make)
    if not again.structure_restored or "plan_build_s" in again.timings:
        raise AssertionError(f"the {eng.mode} engine did not restore its "
                             "routing plan without a build")
    want = eng.structure_arrays()
    got = again.structure_arrays()
    if set(got) != set(want) or not all(torch.equal(got[k], want[k])
                                        for k in want):
        raise AssertionError(f"the restored {eng.mode} tables differ")
    x_np = np.random.default_rng(13).standard_normal(eng.n_states)
    err = assert_close(torch.from_numpy(again.matvec_global(x_np)).to(
        device), y, f"restored {eng.mode} apply")
    return {"built_s": eng.timings["plan_build_s"],
            "restore_engine_s": restore_s, "restore_peak_bytes": peak,
            "restored": True, "vs_built_max_abs_err": err}


#: the sharded leg's compact engine runs on this ring's symmetric sector
#: (its chain_32_symm build took ≈ 43 s: cut to fit the time limit)
COMPACT_N = 24


def sharded_compact_leg(device, D, B, applies, tmp):
    """``DistributedEngine(op, n_devices=D, mode="compact")`` on
    chain_{COMPACT_N}_symm: build seconds, peak memory and table bytes,
    its apply against a ``LocalEngine`` ell apply of the same operator
    (atol 1e-13 / rtol 1e-12), timed applies; its routing plan saved under
    ``tmp`` and restored by a second engine (:func:`structure_roundtrip`)."""
    import numpy as np
    import torch

    from distributed_matvec_tpu_torch import DistributedEngine, LocalEngine

    cfg, enum_s = chain_cfg(COMPACT_N)
    op = cfg.hamiltonian
    n = op.basis.number_states
    x_np = np.random.default_rng(13).standard_normal(n)
    ell = LocalEngine(op, mode="ell", device=device)
    y_ref = ell.matvec(torch.from_numpy(x_np).to(device))
    del ell
    store, cache, route = cache_store(tmp)

    def make():
        return DistributedEngine(op, n_devices=D, mode="compact",
                                 batch_size=B, device=device,
                                 structure_cache=cache, _sidecar_store=store)

    eng, build_s, peak = build_timed(device, make)
    info = {"chain": COMPACT_N, "n_states": n, "enumerate_s": enum_s,
            "build_s": build_s, "build_peak_bytes": peak,
            "timings": eng.timings, "shard_size": eng.shard_size,
            "counts": [int(c) for c in eng.counts],
            "table_bytes": eng.ell_nbytes, "ell_split": eng.ell_split,
            "query_capacity": eng.query_capacity}
    y = torch.from_numpy(eng.matvec_global(x_np)).to(device)
    info["vs_local_ell_max_abs_err"] = assert_close(
        y, y_ref, f"D = {D} compact vs LocalEngine ell apply "
        f"(chain_{COMPACT_N}_symm)")
    info.update(apply_times(device, eng, eng.to_hashed(x_np),
                            applies=applies))
    info["cache"] = structure_roundtrip(device, eng, make, y)
    del eng
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return info


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


# -- shards (after sharded) ---------------------------------------------------

#: the resume leg's ring (where h5py imports) and its two shard counts
SHARDS_RESUME_N = 20


def shards_phase(device, op, ell_ref, full_eng, sharded_streamed, n=32,
                 expect_states=CHAIN32_STATES, D=SHARDS, B=SHARDED_BATCH,
                 applies=3):
    """The sharded enumeration and the shard-native engine at full width;
    see the module docstring.  ``op`` is the full leg's operator (its
    basis built), ``ell_ref`` local_full's ell engine, ``full_eng`` the
    full leg's D = 1 streamed engine and ``sharded_streamed`` the sharded
    leg's D = 4 global-layout streamed engine.  Returns (info, the decode
    launches of the leg's main path)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from distributed_matvec_tpu_torch import DistributedEngine
    from distributed_matvec_tpu_torch.enumeration import sharded
    from distributed_matvec_tpu_torch.enumeration.host import shard_index
    from distributed_matvec_tpu_torch.models.yaml_io import (
        basis_from_dict, operator_from_dict)
    from distributed_matvec_tpu_torch.ops import plan_codec as PC
    from distributed_matvec_tpu_torch.parallel.reshard import Resharder

    has_h5 = importable("h5py")
    out = {"h5py": has_h5, "n_shards": D, "batch_size": B}
    cfg = chain_config(n)
    basis = basis_from_dict(cfg["basis"])
    op_s = operator_from_dict(cfg["hamiltonian"], basis)
    kw = dict(n_devices=D, mode="streamed", stream_compress="lossless",
              batch_size=B, device=device)
    tmp = tempfile.mkdtemp(prefix="dmt_shards_")
    try:
        # 1. the enumeration routed into D shards: into the HDF5 file where
        #    h5py imports, else into the in-memory sink (the line says which)
        timings = {}
        t0 = time.perf_counter()
        if has_h5:
            path = os.path.join(tmp, "shards.h5")
            man = sharded.enumerate_to_shards(
                n, basis.hamming_weight, basis.group, D, path,
                _timings=timings)

            def load(d):
                return sharded.load_shard(path, d)

            def make():
                return DistributedEngine.from_shards(op_s, path, **kw)
        else:
            sink, timings = sharded._enumerate_in_memory(
                n, basis.hamming_weight, basis.group, D)
            man, load = sink.manifest, sink.load

            def make():
                return DistributedEngine(op_s, _shard_source=(man, load),
                                         **kw)
        out.update(route="file" if has_h5 else "memory",
                   enumerate_s=timings["enumerate_s"],
                   route_s=timings["route_s"],
                   enumerate_and_route_s=time.perf_counter() - t0)

        # 2. per-shard states and norms against the full leg's basis
        t0 = time.perf_counter()
        reps = np.asarray(op.basis.representatives, np.uint64)
        norms = np.asarray(op.basis.norms)
        owner = shard_index(reps, D)
        counts = [int(c) for c in man["counts"]]
        for d in range(D):
            s, w = load(d)
            if not (np.array_equal(s, reps[owner == d])
                    and np.array_equal(w, norms[owner == d])):
                raise AssertionError(f"shard {d}'s states or norms differ "
                                     "from HashedLayout's of the full leg")
        if sum(counts) != expect_states or man["total"] != expect_states:
            raise AssertionError(f"the shards hold {sum(counts)} states, "
                                 f"the census {expect_states}")
        del reps, norms, owner
        out.update(counts=counts, total=int(man["total"]),
                   shards_checked_s=time.perf_counter() - t0)

        # 3. the shard-native build, and its plan against the sharded leg's
        #    global-layout engine's
        eng, build_s, peak = build_timed(device, make)
        if basis.is_built:
            raise AssertionError("the shard-native build built the basis")
        ref = sharded_streamed
        if not (eng.nchunks == ref.nchunks
                and torch.equal(eng._plan_host, ref._plan_host)
                and torch.equal(eng._cdict, ref._cdict)):
            raise AssertionError("the shard-native plan differs from the "
                                 "global-layout engine's")
        out.update(build_s=build_s, build_peak_bytes=peak,
                   timings=eng.timings, nchunks=eng.nchunks,
                   plan_bytes=int(eng.plan_bytes), plan_bit_equal=True,
                   stream_kernel=eng.stream_kernel)

        # 4. applies, each held to local_full's ell apply through the
        #    layout the engine materializes on request
        x_np = np.random.default_rng(13).standard_normal(eng.n_states)
        y_ref = ell_ref.matvec(torch.from_numpy(x_np).to(device))
        t0 = time.perf_counter()
        xh = eng.to_hashed(x_np)
        out["layout_s"] = time.perf_counter() - t0
        PC.fused_decode_gather_scatter.launches = 0
        eng.n_applies = 0
        full_eng.n_applies = 0
        host, dev_ms, errs = [], [], []
        for _ in range(applies):
            _sync(device)
            t0 = time.perf_counter()
            if device.type == "cuda":
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            yh = eng.matvec(xh)
            if device.type == "cuda":
                e1.record()
            _sync(device)
            host.append((time.perf_counter() - t0) * 1e3)
            if device.type == "cuda":
                dev_ms.append(e0.elapsed_time(e1))
            errs.append(assert_close(
                torch.from_numpy(eng.from_hashed(yh)).to(device), y_ref,
                f"D = {D} shard-native apply vs LocalEngine ell apply"))
        per_apply = D * eng.nchunks
        launches = PC.fused_decode_gather_scatter.launches
        if device.type == "cuda" and launches != per_apply * applies:
            raise AssertionError(f"{launches} decode launches for {applies} "
                                 f"applies of {D} × {eng.nchunks} chunks")
        out.update(applies=applies, launches_per_apply=per_apply,
                   apply_ms_host=host, apply_ms_device=dev_ms,
                   vs_local_ell_max_abs_err=max(errs))

        # 5. the state-keyed probe: <x, Hx> at D = 4 and at D = 1
        p4 = eng.state_keyed_hashed(7)
        p1 = full_eng.state_keyed_hashed(7)
        v4 = float(eng.dot(p4, eng.matvec(p4)))
        v1 = float(full_eng.dot(p1, full_eng.matvec(p1)))
        rel = abs(v4 - v1) / abs(v1)
        if rel > 1e-12:
            raise AssertionError(f"<x, Hx> of the state-keyed probe: "
                                 f"{v4} at D = {D}, {v1} at D = 1")
        launches = PC.fused_decode_gather_scatter.launches
        want = per_apply * (applies + 1) + full_eng.nchunks
        if device.type == "cuda" and launches != want:
            raise AssertionError(f"{launches} decode launches, {want} "
                                 "expected on the leg's main path")
        out.update(probe_d4=v4, probe_d1=v1, probe_rel_err=rel,
                   launches=launches)

        # 6. the Resharder both ways, each landing bit-equal on the probe
        #    of its owner engine
        for src, dst, x_src, want in ((eng, full_eng, p4, p1),
                                      (full_eng, eng, p1, p4)):
            t0 = time.perf_counter()
            plan = Resharder(dst, src.n_devices, src.counts)
            host_rows = x_src.cpu().numpy()
            cnt = np.asarray(src.counts)
            rows = plan.reshard_rows(
                lambda i, s: host_rows[s, : cnt[s]], 1, dtype=np.float64)
            _sync(device)
            secs = time.perf_counter() - t0
            if not torch.equal(rows[0], want):
                raise AssertionError(
                    f"reshard {src.n_devices} → {dst.n_devices}: the probe "
                    "does not land bit-equal")
            out[f"reshard_{src.n_devices}_to_{dst.n_devices}_s"] = secs
        del rows, plan, eng, xh, yh, p4, p1
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # 7. a checkpointed solve resumed on another D (files: h5py only)
        out["resume"] = shards_resume_leg(device, tmp) if has_h5 else \
            "skipped: h5py does not import on this machine (the solvers' " \
            "checkpoints are HDF5 files)"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, out["launches"]


def shards_resume_leg(device, tmp, n=SHARDS_RESUME_N, D=4, Dp=2):
    """A checkpointed ``lanczos`` on chain_{n}_symm at D shards (ell),
    stopped by a preemption at its second safe point, resumed at D′ to
    the uninterrupted solve's E0 within 1e-10."""
    from distributed_matvec_tpu_torch import DistributedEngine, lanczos
    from distributed_matvec_tpu_torch.utils import preempt

    cfg, _ = chain_cfg(n)
    op = cfg.hamiltonian
    ck = os.path.join(tmp, "lanczos_ck.h5")
    kw = dict(k=1, tol=1e-12, check_every=8)
    src = DistributedEngine(op, n_devices=D, mode="ell", device=device)
    dst = DistributedEngine(op, n_devices=Dp, mode="ell", device=device)
    full = lanczos(src.matvec, v0=src.random_hashed(42), **kw)
    agreed, calls = preempt.agreed, [0]

    def second(group):
        calls[0] += 1
        return calls[0] == 2

    preempt.agreed = second
    try:
        lanczos(src.matvec, v0=src.random_hashed(42), checkpoint_path=ck,
                checkpoint_every=100, **kw)
        raise AssertionError("the checkpointed solve was not preempted")
    except preempt.Preempted as e:
        stopped = e.iters
    finally:
        preempt.agreed = agreed
    t0 = time.perf_counter()
    res = lanczos(dst.matvec, v0=dst.random_hashed(42), checkpoint_path=ck,
                  **kw)
    secs = time.perf_counter() - t0
    e0, want = float(res.eigenvalues[0]), float(full.eigenvalues[0])
    if res.resumed_from != stopped or abs(e0 - want) > 1e-10:
        raise AssertionError(f"resumed from {res.resumed_from} of {stopped} "
                             f"iterations at D = {Dp}: E0 {e0}, {want} "
                             "uninterrupted")
    return {"chain": n, "d_from": D, "d_to": Dp, "stopped_at": stopped,
            "resumed_from": res.resumed_from, "e0": e0,
            "e0_minus_uninterrupted": e0 - want, "resumed_solve_s": secs}



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
    engine at 0 and 2, and one D = 4 fused apply at 2.  Every
    pipelined streamed apply must equal its engine's depth-0 apply bit for
    bit (both under deterministic algorithms); the fused apply at depth 2
    must equal the D = 4 streamed apply within atol 1e-13 / rtol 1e-12
    (the card's atomic ``index_add_``: a deterministic fused apply takes
    ≈ 30 s here, so the card tests hold fused bit for bit at
    chain_16_symm); the decode kernel
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

    # timing: depth 0 first (not counted; D = 4 is cut, the sharded leg
    # times the same engine at depth 0), then the pipelined applies with
    # the counts set to 0 just before them
    timing = {"d1_streamed": {}, "d4_streamed": {}, "d4_fused": {}}
    full_eng.pipeline_depth = 0
    timing["d1_streamed"][0] = pipeline_timing(device, full_eng, x1)
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
    # one fused apply at depth 2, timed, against the D = 4 streamed
    # engine's apply of the same vector (the sharded leg times fused at
    # depth 0; no second fused apply here, to fit the time limit)
    s4.pipeline_depth = 0
    y_s4 = s4.matvec(x4)
    f4.pipeline_depth = 2
    _sync(device)
    t0 = time.perf_counter()
    yf = f4.matvec(x4)
    _sync(device)
    timing["d4_fused"][2] = {
        "apply_ms_host": (time.perf_counter() - t0) * 1e3,
        "depth": f4.pipeline_depth, "last_pipeline": f4.last_pipeline}
    out["checks"]["d4_fused"] = {
        "reported_depth": {2: timing["d4_fused"][2]["depth"]},
        "vs_d4_streamed_max_abs_err": assert_close(
            yf, y_s4, "D = 4 fused at depth 2 vs D = 4 streamed")}
    del yf, y_s4
    out["timing"] = timing
    out["launches"] = launches
    for eng in (full_eng, s4, f4):
        eng.pipeline_depth = 0
    return out, launches


# -- phase 13: tiers -------------------------------------------------------------

#: the quantized tiers' documented bounds on an apply's largest error
#: relative to the largest lossless value (tests/test_plan_codec.py), and
#: on their Lanczos E0 relative to the lossless E0
TIER_BOUNDS = {"f32": 1e-6, "bf16": 1e-2}
#: the ring of the legs cut to fit the script's time limit (``tiers`` and
#: the gloo ranks of ``ranks``): chain_30_symm, about 3.6× fewer states
#: than chain_32_symm, held to references of its own size
CUT_N = 30


def cut_operator():
    """chain_{CUT_N}_symm, enumerated by the native enumerator."""
    from distributed_matvec_tpu_torch.models.lattices import heisenberg_chain

    os.environ["DMT_ENUMERATION_BACKEND"] = "native"
    op = heisenberg_chain(CUT_N, symmetric=True)
    t0 = time.perf_counter()
    op.basis.build()
    return op, time.perf_counter() - t0


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


def tiers_phase(device, batch_size):
    """The streamed engine's other tiers and forms on chain_{CUT_N}_symm,
    against a lossless D = 1 engine of the same operator; see the module
    docstring.  Returns the operator too, for ``ranks``."""
    import torch

    from distributed_matvec_tpu_torch import DistributedEngine, lanczos, obs
    from distributed_matvec_tpu_torch.obs import health
    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    op, enum_s = cut_operator()

    def build(**kw):
        kw = {"mode": "streamed", "stream_compress": "lossless", **kw}
        eng, build_s, peak = build_timed(device, lambda: DistributedEngine(
            op, batch_size=batch_size, device=device, **kw))
        return eng, {"build_s": build_s, "build_peak_bytes": peak,
                     "timings": eng.timings, "spec": eng._codec.spec,
                     "plan_bytes": int(eng.plan_bytes),
                     "plan_bytes_raw": int(eng.plan_bytes_raw),
                     "stream_kernel": eng.stream_kernel}

    ref_eng, ref = build()
    xh = ref_eng.random_hashed(19)
    y_ref = deterministic(lambda: ref_eng.matvec(xh))
    ref_scale = float(y_ref.abs().max())
    ci = ref_eng.nchunks // 2
    x_c = xh[0, ci * batch_size:(ci + 1) * batch_size]
    send_ref = send_buffer(ref_eng, ci, x_c)
    res = lanczos(ref_eng.matvec, v0=ref_eng.random_hashed(0), k=1,
                  tol=1e-10, device=device)
    e0_ref = float(res.eigenvalues[0])
    if not res.converged:
        raise AssertionError(f"chain_{CUT_N}_symm lossless Lanczos did not "
                             "converge")
    ref.update(nchunks=ref_eng.nchunks, e0=e0_ref,
               lanczos_iters=int(res.num_iters))
    num_terms = ref_eng.num_terms
    del ref_eng, res
    release(device)
    out = {"n_states": int(op.basis.number_states), "n": CUT_N,
           "enumeration_s": enum_s,
           "reference": f"a lossless D = 1 engine of chain_{CUT_N}_symm",
           "lossless": ref}

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
        drift0 = len(obs.events("compress_drift"))
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
        # lanczos' default on a quantized tier is the full sweep
        if not (res.converged and abs(e0 - e0_ref)
                <= TIER_BOUNDS[tier] * abs(e0_ref)):
            raise AssertionError(f"{tier}: E0 {e0} against lossless "
                                 f"{e0_ref} (bound {TIER_BOUNDS[tier]}"
                                 f"·|E0|, converged {res.converged})")
        # the health layer's drift probe on the same applies (every
        # health_every-th, input-weighted, one chunk), beside the error
        health.drain(block=True)
        drift = [e["rel_err"] for e in obs.events("compress_drift")[drift0:]
                 if e["tier"] == tier]
        if not drift:
            raise AssertionError(f"{tier}: no compress_drift sample")
        info.update(rel_err_vs_lossless=rel, bound=TIER_BOUNDS[tier],
                    compress_rel_err=drift[0],
                    compress_rel_err_samples=len(drift),
                    launches=n, applies=eng.n_applies,
                    lanczos_s=time.perf_counter() - t0,
                    lanczos_iters=int(res.num_iters),
                    lanczos_full_sweeps=int(res.full_sweeps), e0=e0,
                    e0_lossless=e0_ref, e0_minus_lossless=e0 - e0_ref)
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
    even = "stream:" + ",".join(map(str, range(0, num_terms, 2)))
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
    return out, launches, op


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
#: k and block width of the ranks' block solvers (cut from 4 to fit the
#: time limit; the one-process references use the same)
RANKS_BLOCK_K = 2


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
    """One rank of the ranks leg: chain_n_symm on the parent's basis
    (``representatives.npy``/``norms.npy`` in ``tmp``), then ``ell``
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
    # the parent's basis (its enumeration is the full leg's), not one
    # enumeration per rank
    op.basis.unchecked_set_representatives(
        np.load(os.path.join(tmp, "representatives.npy")),
        np.load(os.path.join(tmp, "norms.npy")))
    out["basis_load_s"] = time.perf_counter() - t0
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
                mv, k=RANKS_BLOCK_K, block_size=RANKS_BLOCK_K,
                max_iters=800, tol=1e-10)),
            ("lobpcg", lambda mv: lobpcg(mv, N, k=RANKS_BLOCK_K, tol=1e-15,
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
        remote_buffer_size=remote_buffer, group=g, stream_compress="lossless"))
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
    # depth 2: one apply bit-equal to depth 0, its launches counted (the
    # timed depth-2 applies are cut to fit the time limit)
    y0 = deterministic(lambda: eng.matvec(xh))
    eng.pipeline_depth = 2
    PC.fused_decode_gather_scatter.launches = 0
    eng.n_applies = 0
    y2 = deterministic(lambda: eng.matvec(xh))
    launches2 = PC.fused_decode_gather_scatter.launches
    if not torch.equal(y0, y2):
        raise AssertionError(f"rank {rank}: the depth-2 streamed apply "
                             "differs from depth 0")
    del y0, y2
    if device.type == "cuda" and launches2 != eng.nchunks * eng.n_applies:
        raise AssertionError(f"rank {rank}: {launches2} decode launches for "
                             f"{eng.n_applies} depth-2 applies of "
                             f"{eng.nchunks} chunks")
    info["depth2"] = {"depth": eng.pipeline_depth,
                      "applies": eng.n_applies, "launches": launches2,
                      "bit_equal_to_depth_0": True}
    info["launches"] = launches + launches2
    if rank == 0:
        np.save(os.path.join(tmp, f"y_streamed_{backend}.npy"), y)
    out["streamed"] = info
    del eng
    if backend == "gloo":
        out["serve"] = rank_serve_leg(g, device, n, op.basis.number_states,
                                      remote_buffer)
    with open(os.path.join(tmp, f"rank{rank}_{backend}.json"), "w") as fh:
        json.dump(out, fh)
    import torch.distributed as dist

    dist.destroy_process_group()


def rank_serve_leg(g, device, n, n_states, remote_buffer):
    """The solve service over the rank group (JAX ``EnginePool(mesh=)``):
    ``EnginePool(group=g)`` drains two ell ``eigs`` jobs one per batch
    (``block_width=1``: one build, one hit) and a streamed lossless job
    whose decode launches on this rank are counted from 0 around the
    drain; every spec carries chain_{n}_symm's basis and ``n_states``.
    Returns the counts, statuses, E0s and this rank's ``engine_init``
    events."""
    from distributed_matvec_tpu_torch import obs
    from distributed_matvec_tpu_torch.ops import plan_codec as PC
    from distributed_matvec_tpu_torch.serve import (EnginePool, JobQueue,
                                                    JobSpec, Scheduler)
    from distributed_matvec_tpu_torch.utils.config import update_config

    update_config(stream_compress="lossless",
                  remote_buffer_size=remote_buffer,
                  serve_pool_gb=SERVE_POOL_GB)
    common = {"basis": _chain32_basis(n), "n_states": int(n_states),
              "n_devices": g.world_size}
    specs = [JobSpec(job_id=f"ell{i}", k=1, tol=1e-10, max_iters=400,
                     **common) for i in range(2)]
    specs.append(JobSpec(job_id="streamed", k=1, tol=1e-5, max_iters=200,
                         mode="streamed", **common))
    inits0 = len(obs.events("engine_init"))
    pool = EnginePool(group=g)
    sched = Scheduler(queue=JobQueue(), pool=pool, rates=None,
                      block_width=1)
    for s in specs:
        sched.submit(s)
    PC.fused_decode_gather_scatter.launches = 0
    t0 = time.perf_counter()
    done = sched.drain(scan_spool=False)
    _sync(device)
    drain_s = time.perf_counter() - t0
    launches = PC.fused_decode_gather_scatter.launches
    recs = {s.job_id: sched.queue.result(s.job_id) for s in specs}
    out = {"drain_s": drain_s, "done": done, "builds": pool.builds,
           "hits": pool.hits, "evictions": pool.evictions,
           "live_devices": pool.live_device_count(),
           "engine_init": len(obs.events("engine_init")) - inits0,
           "status": {j: r["status"] for j, r in recs.items()},
           "e0": {j: r["eigenvalues"][0] for j, r in recs.items()},
           "iters": {j: r.get("iters") for j, r in recs.items()},
           "launches": launches}
    del pool, sched
    if device.type == "cuda":
        import torch
        torch.cuda.empty_cache()
    return out


HB_INTERVAL_S = 0.5
HB_TIMEOUT_S = 5.0
HB_DELAY_MS = 200
HB_STOP_AFTER_S = 1.0


def heartbeat_worker(rank, world, tmp, n):
    """One rank of the heartbeat leg: a gloo rank sharing the card, the
    heartbeat watchdog on the shared run directory (``HB_INTERVAL_S``,
    ``HB_TIMEOUT_S``), and a Lanczos on a chain_{n}_symm ell rank engine
    that never converges (tol 0), each check block stretched by
    ``DMT_FAULT=solver_block:delay=HB_DELAY_MS``.  Rank 0 is expected to
    leave through the watchdog (exit 76) once the parent stops rank 1."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    os.environ["DMT_OBS_DIR"] = os.path.join(tmp, "hb_run")
    os.environ["DMT_FAULT"] = f"solver_block:delay={HB_DELAY_MS}:n=1000000"
    from distributed_matvec_tpu_torch import DistributedEngine, lanczos
    from distributed_matvec_tpu_torch.models.lattices import heisenberg_chain
    from distributed_matvec_tpu_torch.parallel.heartbeat import \
        HeartbeatWatchdog
    from distributed_matvec_tpu_torch.parallel.mesh import init_distributed

    device = torch.device("cuda", 0)
    g = init_distributed("gloo", f"file://{tmp}/rendezvous_hb", world, rank,
                         device=device, timeout_s=RANKS_COLLECTIVE_TIMEOUT_S)
    op = heisenberg_chain(n, symmetric=True)
    op.basis.unchecked_set_representatives(
        np.load(os.path.join(tmp, "representatives.npy")),
        np.load(os.path.join(tmp, "norms.npy")))
    eng = DistributedEngine(op, mode="ell", group=g)
    HeartbeatWatchdog(os.environ["DMT_OBS_DIR"], interval_s=HB_INTERVAL_S,
                      timeout_s=HB_TIMEOUT_S).start()
    with open(os.path.join(tmp, f"hb_solving{rank}"), "w") as fh:
        fh.write(f"{time.time()}\n")
    lanczos(eng.matvec, v0=eng.random_hashed(0), k=1, tol=0.0,
            max_iters=10 ** 7)
    raise AssertionError("the never-converging Lanczos returned")


def heartbeat_leg(tmp, n, world=2):
    """Both ranks solve with the watchdog on; once both run, the parent
    stops rank 1 (SIGSTOP) mid-solve.  Rank 0 must exit 76 within
    ``HB_TIMEOUT_S + 2·HB_INTERVAL_S + 5`` s of the stop, with a
    ``stall_report`` naming rank 1 in its events and a ``stall`` flight
    bundle on disk; then rank 1 is killed."""
    import signal

    import torch.multiprocessing as mp

    ctx = mp.start_processes(heartbeat_worker, args=(world, tmp, n),
                             nprocs=world, join=False, start_method="spawn")
    procs = ctx.processes
    out = {"interval_s": HB_INTERVAL_S, "timeout_s": HB_TIMEOUT_S,
           "solver_block_delay_ms": HB_DELAY_MS}
    try:
        deadline = time.monotonic() + RANKS_JOIN_TIMEOUT_S
        while not all(os.path.exists(os.path.join(tmp, f"hb_solving{r}"))
                      for r in range(world)):
            if time.monotonic() > deadline or any(
                    p.exitcode is not None for p in procs):
                raise AssertionError(
                    "heartbeat ranks did not start solving: exit codes "
                    f"{[p.exitcode for p in procs]}")
            time.sleep(0.1)
        time.sleep(HB_STOP_AFTER_S)
        if any(p.exitcode is not None for p in procs):
            raise AssertionError(f"a heartbeat rank left early: "
                                 f"{[p.exitcode for p in procs]}")
        os.kill(procs[1].pid, signal.SIGSTOP)
        t_stop = time.monotonic()
        limit = HB_TIMEOUT_S + 2 * HB_INTERVAL_S + 5.0
        procs[0].join(limit + 10.0)
        waited = time.monotonic() - t_stop
        code = procs[0].exitcode
        out.update(rank0_exit_code=code, seconds_to_exit=waited,
                   limit_s=limit)
        if code != 76 or waited > limit:
            raise AssertionError(f"rank 0 exit {code} after {waited:.1f} s "
                                 f"(expected 76 within {limit} s)")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    run = os.path.join(tmp, "hb_run")
    with open(os.path.join(run, "rank_0", "events.jsonl")) as fh:
        evs = [json.loads(ln) for ln in fh if ln.strip()]
    stall = [e for e in evs if e["kind"] == "stall_report"]
    bundles = sorted(f for f in os.listdir(os.path.join(run, "rank_0",
                                                        "postmortem"))
                     if f.startswith("stall-"))
    if len(stall) != 1 or stall[0]["stalled"] != [1] or not bundles:
        raise AssertionError(f"stall reports {stall}, bundles {bundles}")
    out.update(stall_report={k: stall[0].get(k) for k in
                             ("stalled", "ages_s", "span_path")},
               health_events=[e["check"] for e in evs
                              if e["kind"] == "health"],
               flight_bundle=bundles[0])
    return out


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


def check_ranks(tmp, backend, outs, y_ref, e0_ref, block_ref):
    """Rank 0's gathered applies against ``y_ref`` (atol 1e-13 / rtol
    1e-12), every rank's E0 against the one-process one (1e-10), and the
    block solvers' eigenvalues the same bits on every rank and within 1e-10
    of the one-process solves' (``block_ref``: solver → eigenvalues)."""
    import numpy as np

    errs = {}
    for mode in ("ell", "streamed"):
        y = np.load(os.path.join(tmp, f"y_{mode}_{backend}.npy"))
        errs[mode] = assert_close(y, y_ref, f"{backend} ranks {mode} apply "
                                            "vs LocalEngine ell apply")
    e0s = [o["ell"]["e0"] for o in outs]
    if len(set(e0s)) != 1 or not all(o["ell"]["lanczos_converged"]
                                     for o in outs) \
            or abs(e0s[0] - e0_ref) > 1e-10:
        raise AssertionError(f"{backend} ranks E0 {e0s}, one process "
                             f"{e0_ref}")
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
            "e0_minus_ref": e0s[0] - e0_ref, "block_solvers": block}


def check_rank_serve(serves, e0_ref):
    """Every rank's service drain: all three jobs done, one build and one
    hit of the ell engine plus the streamed engine's build (builds 2,
    hits 1, no eviction), one ``engine_init`` per build, the ell jobs' E0
    within 1e-10 of the one-process E0 and the same bits on every rank,
    the streamed job within its tolerance, and the decode kernel launched
    on every rank a whole number of times per chunk."""
    for r, s in enumerate(serves):
        if set(s["status"].values()) != {"done"} or s["done"] != 3:
            raise AssertionError(f"rank {r} service: {s['status']}")
        if (s["builds"], s["hits"], s["evictions"], s["engine_init"]) \
                != (2, 1, 0, 2):
            raise AssertionError(
                f"rank {r} pool: builds {s['builds']}, hits {s['hits']}, "
                f"evictions {s['evictions']}, engine_init "
                f"{s['engine_init']}")
        for j in ("ell0", "ell1"):
            if abs(s["e0"][j] - e0_ref) > 1e-10:
                raise AssertionError(f"rank {r} {j} E0 {s['e0'][j]} against "
                                     f"{e0_ref}")
        if abs(s["e0"]["streamed"] - e0_ref) > 1e-6 * abs(e0_ref):
            raise AssertionError(f"rank {r} streamed job E0 "
                                 f"{s['e0']['streamed']} against {e0_ref}")
        if s["launches"] == 0:
            raise AssertionError(f"rank {r}: no decode launch under the "
                                 "service")
    if any(s["e0"] != serves[0]["e0"] for s in serves):
        raise AssertionError(f"the ranks' E0s differ: "
                             f"{[s['e0'] for s in serves]}")
    return {"ranks": serves, "e0_ref": e0_ref,
            "ell_e0_minus_ref": serves[0]["e0"]["ell0"] - e0_ref,
            "launches": sum(s["launches"] for s in serves)}


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
            full_eng.operator, batch_size=full_eng.batch_size, group=g,
            mode="streamed", stream_compress="lossless"))
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
            launches_d2 = PC.fused_decode_gather_scatter.launches
        finally:
            torch.use_deterministic_algorithms(False)
        if launches_d2 != 2 * eng.nchunks:
            raise AssertionError(f"{launches_d2} decode launches for the "
                                 f"depth-0 and depth-2 applies of "
                                 f"{eng.nchunks} chunks")
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
        # the depth-2 apply above is the leg's one at depth 2 (its timed
        # applies are cut to fit the time limit)
        info.update(rank_apply_times(device, eng, xh))
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


def ranks_phase(device, op, full_eng):
    """The rank engine on the card; see the module docstring.  ``op`` is
    ``tiers``' chain_{CUT_N}_symm: its one-process references (the ell
    apply, E0 and the block solvers as ``solvers`` runs them) are made
    here; the one-rank NCCL leg runs on the full leg's engine."""
    import tempfile

    import numpy as np
    import torch

    from distributed_matvec_tpu_torch import (LocalEngine, lanczos,
                                              lanczos_block, lobpcg)

    n = op.basis.number_states
    ell_ref = LocalEngine(op, mode="ell", device=device)
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(n)).to(
        device)
    y_ref = ell_ref.matvec(x).cpu().numpy()
    t0 = time.perf_counter()
    res = lanczos(ell_ref.matvec, n, k=1, tol=1e-10, device=device)
    e0_ref = float(res.eigenvalues[0])
    rb = lanczos_block(ell_ref.matvec, n, k=RANKS_BLOCK_K,
                       block_size=RANKS_BLOCK_K, max_iters=800, tol=1e-10,
                       device=device)
    ev, _, _ = lobpcg(ell_ref.matvec, n, k=RANKS_BLOCK_K, tol=1e-15,
                      max_iters=400, device=device)
    if not (res.converged and rb.converged):
        raise AssertionError(f"chain_{CUT_N}_symm references did not "
                             "converge")
    block_ref = {"lanczos_block": rb.eigenvalues.tolist(),
                 "lobpcg": ev.tolist()}
    out = {"n_states": n, "n": CUT_N, "world_size": RANKS,
           "batch_size": RANKS_BATCH,
           "remote_buffer_size": RANKS_REMOTE_BUFFER,
           "references_s": time.perf_counter() - t0, "e0_ref": e0_ref,
           "note": "two ranks sharing one card over gloo: not a two-card "
                   "result"}
    del ell_ref, res, rb
    release(device)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "representatives.npy"),
                op.basis.representatives)
        np.save(os.path.join(tmp, "norms.npy"), op.basis.norms)
        t0 = time.perf_counter()
        outs = spawn_ranks("gloo", RANKS, tmp, CUT_N)
        out["gloo"] = {"seconds": time.perf_counter() - t0, "ranks": outs,
                       **check_ranks(tmp, "gloo", outs, y_ref, e0_ref,
                                     block_ref)}
        launches = sum(o["streamed"]["launches"] for o in outs)
        out["serve"] = check_rank_serve([o["serve"] for o in outs], e0_ref)
        launches += out["serve"]["launches"]
        t0 = time.perf_counter()
        out["heartbeat"] = heartbeat_leg(tmp, CUT_N)
        out["heartbeat"]["seconds"] = time.perf_counter() - t0
        cards = torch.cuda.device_count()
        if cards >= RANKS:
            t0 = time.perf_counter()
            outs = spawn_ranks("nccl", RANKS, tmp, CUT_N)
            out["nccl"] = {"seconds": time.perf_counter() - t0,
                           "ranks": outs,
                           **check_ranks(tmp, "nccl", outs, y_ref, e0_ref,
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
    return info


#: the steps of the Lanczos that holds streamed_complex to local_complex
#: (full reorthogonalization, no convergence test): the lowest Ritz value
#: of both, from the same state, within 1e-10 relative
COMPLEX_HELD_STEPS = 32


def streamed_complex_phase(device, n=None):
    """The k = 1 sector of the {CUT_N}-ring through the streamed engine,
    held to an ell ``LocalEngine`` of the same sector built here (not the
    32-ring's, ``local_complex``'s: cut to fit the time limit); see the
    module docstring."""
    import numpy as np
    import torch

    from distributed_matvec_tpu_torch import (DistributedEngine, LocalEngine,
                                              lanczos)
    from distributed_matvec_tpu_torch.models.basis import SpinBasis
    from distributed_matvec_tpu_torch.models.lattices import (
        chain_edges, heisenberg_from_edges)
    from distributed_matvec_tpu_torch.ops import plan_codec as PC

    n = n or CUT_N
    os.environ["DMT_ENUMERATION_BACKEND"] = "native"
    basis = SpinBasis(n, n // 2, None, [([(i + 1) % n for i in range(n)], 1)])
    t0 = time.perf_counter()
    basis.build()
    enum_s = time.perf_counter() - t0
    op = heisenberg_from_edges(basis, chain_edges(n))
    # the reference: an ell apply of a seeded state, and the lowest Ritz
    # value of a COMPLEX_HELD_STEPS-step Lanczos from it
    ref, ref_build = timed_build(device, lambda: LocalEngine(op,
                                                             device=device))
    rng = np.random.default_rng(12)
    N = basis.number_states
    x_t = torch.from_numpy(rng.standard_normal(N)
                           + 1j * rng.standard_normal(N)).to(device)
    r_held = lanczos(ref.matvec, v0=x_t, k=1, max_iters=COMPLEX_HELD_STEPS,
                     tol=0.0, reorth="full", device=device)
    x, y_ell = x_t.cpu().numpy(), ref.matvec(x_t).cpu().numpy()
    ritz_ell = float(r_held.eigenvalues[0])
    del ref, r_held, x_t
    release(device)
    eng, build_s, peak = build_timed(device, lambda: DistributedEngine(
        op, device=device, mode="streamed", stream_compress="lossless"))
    spec = eng._codec.spec
    if eng.real or eng.stream_kernel != "torch" or spec["ckind"] != \
            "complex":
        raise AssertionError(f"k = 1 streamed: real {eng.real}, decode path "
                             f"{eng.stream_kernel}, ckind {spec['ckind']}")
    info = {"n": n, "n_states": int(op.basis.number_states),
            "enumeration_s": enum_s, "ell_reference": ref_build,
            "build_s": build_s,
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
    info["ritz_ell"] = ritz_ell
    del y, y_ell
    xh = eng.to_hashed(x)
    info.update(apply_times(device, eng, xh, applies=3))
    prof = profile_apply(lambda: eng.matvec(xh), top=12)
    info["profile"] = {k: prof[k] for k in ("device_ms_total", "top",
                                             "phases_ms")}
    t0 = time.perf_counter()
    res = lanczos(eng.matvec, v0=xh, k=1, max_iters=COMPLEX_HELD_STEPS,
                  tol=0.0, reorth="full", device=device)
    _sync(device)
    ritz = float(res.eigenvalues[0])
    info.update(lanczos_s=time.perf_counter() - t0,
                lanczos_iters=int(res.num_iters), ritz=ritz,
                ritz_minus_ell=ritz - ritz_ell)
    if not (int(res.num_iters) == COMPLEX_HELD_STEPS
            and abs(ritz - ritz_ell) <= 1e-10 * abs(ritz_ell)):
        raise AssertionError(
            f"k = 1 streamed Ritz value {ritz} after {res.num_iters} steps "
            f"!= the ell engine's {ritz_ell}")
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


# -- the apps phase ----------------------------------------------------------------

#: the dynamics leg's sizes: KPM on tiers' chain_{CUT_N}_symm with the
#: card's atomic receive side, its moments held to a direct call within
#: APPS_KPM_RTOL·|μ0|, and again bit for bit on chain_26_symm (that check
#: runs under deterministic algorithms, whose receive-side sums cost
#: ≈ 0.77 s per apply at chain_{CUT_N}_symm); evolve on chain_16_symm
APPS_KPM_N = 26
APPS_KPM_RTOL = 1e-12
APPS_KPM_MOMENTS = 64
APPS_KPM_VECTORS = 4
APPS_EVOLVE_N = 16
APPS_EVOLVE_T = 0.5
#: the CLI's refusal where yaml or h5py is missing must come within this,
#: with the message the JAX package gives
APPS_REFUSAL_S = 20.0
APPS_MISSING_MESSAGE = {"yaml": "No module named 'yaml'",
                        "h5py": "h5py is required for HDF5 I/O"}


def chain_config(n):
    """``heisenberg_chain(n, symmetric=True)`` as the dict its YAML config
    loads to (the ``*_symm`` schema: translation and reflection generators
    in sector 0, spin inversion 1, σσ terms on the ring's edges)."""
    edges = [[i, (i + 1) % n] for i in range(n)]
    return {"basis": {"number_spins": n, "hamming_weight": n // 2,
                      "spin_inversion": 1,
                      "symmetries": [
                          {"permutation": [(i + 1) % n for i in range(n)],
                           "sector": 0},
                          {"permutation": [n - 1 - i for i in range(n)],
                           "sector": 0}]},
            "hamiltonian": {"name": "H", "terms": [
                {"expression": f"σ{a}₀ σ{a}₁", "sites": edges}
                for a in "ˣʸᶻ"]}}


def chain_yaml(n) -> str:
    """:func:`chain_config` as YAML text (JSON is YAML: no ``yaml``
    package is needed to write it)."""
    return json.dumps(chain_config(n), ensure_ascii=False, indent=1)


def chain_cfg(n):
    """A port ``Config`` from :func:`chain_config` through the YAML
    loader's dict builders, its basis enumerated; (cfg, seconds)."""
    from distributed_matvec_tpu_torch.models.yaml_io import (
        Config, basis_from_dict, operator_from_dict)

    d = chain_config(n)
    basis = basis_from_dict(d["basis"])
    cfg = Config(basis=basis,
                 hamiltonian=operator_from_dict(d["hamiltonian"], basis))
    t0 = time.perf_counter()
    basis.build()
    return cfg, time.perf_counter() - t0


def importable(name) -> bool:
    import importlib.util

    return importlib.util.find_spec(name) is not None


def app_refusal_leg(device, tmp, missing):
    """The diagonalize CLI in a subprocess on a YAML file where ``missing``
    (yaml first, as the app reads it first) cannot be imported: a nonzero
    exit naming it, before any enumeration, within APPS_REFUSAL_S."""
    path = os.path.join(tmp, "chain32.yaml")
    with open(path, "w", encoding="utf-8") as f:
        f.write(chain_yaml(32))
    out = os.path.join(tmp, "refused.h5")
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "distributed_matvec_tpu_torch.apps.diagonalize",
         path, "-o", out, "--device", device.type], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    secs = time.perf_counter() - t0
    last = (p.stderr.strip().splitlines() or [""])[-1]
    if p.returncode == 0 or APPS_MISSING_MESSAGE[missing] not in p.stderr \
            or "basis:" in p.stdout or os.path.exists(out) \
            or secs > APPS_REFUSAL_S:
        raise AssertionError(
            f"diagonalize without {missing}: rc {p.returncode} in "
            f"{secs:.1f} s, stdout {p.stdout[-400:]!r}, stderr "
            f"{p.stderr[-400:]!r}")
    return {"missing": missing, "rc": p.returncode, "seconds": secs,
            "stderr_last_line": last}


def apps_main_leg(device, tmp):
    """Where yaml and h5py both import: the diagonalize CLI's ``main`` end
    to end on chain_16_symm into ``tmp``, the file read back."""
    import h5py
    import numpy as np

    from distributed_matvec_tpu_torch.apps import diagonalize

    path = os.path.join(tmp, "chain16.yaml")
    with open(path, "w", encoding="utf-8") as f:
        f.write(chain_yaml(16))
    out = os.path.join(tmp, "chain16.h5")
    t0 = time.perf_counter()
    rc = diagonalize.main([path, "-o", out, "--device", device.type,
                           "--mode", "streamed"])
    secs = time.perf_counter() - t0
    with h5py.File(out, "r") as f:
        e0 = float(f["hamiltonian/eigenvalues"][0])
        vec = f["hamiltonian/eigenvectors"][...]
        n_reps = int(f["basis/representatives"].shape[0])
    if rc != 0 or abs(e0 / 4 - N16_E0_OVER_4) > 1e-9 \
            or vec.shape != (1, n_reps):
        raise AssertionError(f"diagonalize main: rc {rc}, E0/4 {e0 / 4}, "
                             f"eigenvectors {vec.shape} over {n_reps}")
    return {"rc": rc, "seconds": secs, "e0": e0,
            "eigenvectors_shape": list(vec.shape)}


def apps_phase(device, e0_full, op_cut, n=32, kpm_n=APPS_KPM_N,
               evolve_n=APPS_EVOLVE_N):
    """The two CLIs' solve functions on the card; see the module
    docstring."""
    import shutil
    import tempfile

    import numpy as np

    from distributed_matvec_tpu_torch.apps import diagonalize, dynamics
    from distributed_matvec_tpu_torch.models.yaml_io import Config
    from distributed_matvec_tpu_torch.ops import plan_codec as PC
    from distributed_matvec_tpu_torch.solve import (krylov_evolve,
                                                    kpm_moments)
    from distributed_matvec_tpu_torch.utils.config import (get_config,
                                                           update_config)

    out = {"packages": {m: importable(m) for m in ("yaml", "h5py")}}
    tmp = tempfile.mkdtemp(prefix="dmt_apps_")
    saved = get_config().stream_compress
    os.environ["DMT_ENUMERATION_BACKEND"] = "native"
    try:
        missing = [m for m in ("yaml", "h5py") if not out["packages"][m]]
        if missing:
            out["refusal"] = app_refusal_leg(device, tmp, missing[0])
        else:
            out["main"] = apps_main_leg(device, tmp)
        update_config(stream_compress="lossless")

        # diagonalize: one Config, enumerated once, streamed then ell
        cfg, enum_s = chain_cfg(n)
        out["n_states"] = int(cfg.basis.number_states)
        out["enumeration_s"] = enum_s
        PC.fused_decode_gather_scatter.launches = 0
        rs = diagonalize.solve(cfg, k=1, tol=1e-10, mode="streamed",
                               device=device)
        launches = PC.fused_decode_gather_scatter.launches
        eng = rs.engine
        e0 = float(rs.eigenvalues[0])
        out["streamed"] = {
            "engine_s": rs.engine_s, "solve_s": rs.solve_s, "e0": e0,
            "e0_minus_full": e0 - e0_full,
            "residual": float(rs.residuals[0]),
            "columns": rs.iterations, "applies": eng.n_applies,
            "nchunks": eng.nchunks, "launches": launches,
            "eigenvector_shape": list(rs.eigenvectors.shape)}
        if not (rs.converged and abs(e0 - e0_full) < 1e-10
                and rs.residuals[0] < 1e-8
                and rs.eigenvectors.shape == (1, out["n_states"])
                and launches == eng.nchunks * rs.iterations > 0):
            raise AssertionError(f"diagonalize streamed: {out['streamed']}")
        del rs, eng
        release(device)
        rl = diagonalize.solve(cfg, k=1, tol=1e-10, mode="ell",
                               device=device)
        e0l = float(rl.eigenvalues[0])
        out["ell"] = {"engine_s": rl.engine_s, "solve_s": rl.solve_s,
                      "e0": e0l, "e0_minus_full": e0l - e0_full,
                      "residual": float(rl.residuals[0]),
                      "iterations": rl.iterations}
        if not (rl.converged and abs(e0l - e0_full) < 1e-10):
            raise AssertionError(f"diagonalize ell: {out['ell']}")
        del rl, cfg
        release(device)

        # dynamics: KPM, the app's run against a direct kpm_moments call
        # on the same engine with the same seed — on chain_{CUT_N}_symm
        # with the atomic receive side (within APPS_KPM_RTOL·|μ0|), then
        # on the cut ring under deterministic sums (bit for bit)
        kpm_launches = 0
        legs = ((CUT_N, "kpm", lambda f: f()), (kpm_n, "kpm_bit_equal",
                                                deterministic))
        for ring, name, run in legs:
            if ring == CUT_N:
                cfg, kpm_enum_s = Config(basis=op_cut.basis,
                                         hamiltonian=op_cut), 0.0
            else:
                cfg, kpm_enum_s = chain_cfg(ring)
            PC.fused_decode_gather_scatter.launches = 0
            payload, kres, keng, kpm_s = run(lambda: dynamics.run(
                cfg, solver="kpm", mode="streamed", device=device,
                moments=APPS_KPM_MOMENTS, vectors=APPS_KPM_VECTORS))
            n_launch = PC.fused_decode_gather_scatter.launches
            t0 = time.perf_counter()
            direct = run(lambda: kpm_moments(
                keng.matvec, n_moments=APPS_KPM_MOMENTS,
                n_vectors=APPS_KPM_VECTORS, seed=42, bounds_iters=64))
            direct_s = time.perf_counter() - t0
            columns = 64 + APPS_KPM_MOMENTS // 2 * APPS_KPM_VECTORS
            diff = float(np.abs(payload["moments"] - direct.moments).max())
            bar = (0.0 if run is deterministic
                   else APPS_KPM_RTOL * abs(float(direct.moments[0])))
            out[name] = {"n": cfg.basis.number_spins,
                         "n_states": int(cfg.basis.number_states),
                         "enumeration_s": kpm_enum_s, "seconds": kpm_s,
                         "direct_s": direct_s,
                         "applies": kres.num_applies, "launches": n_launch,
                         "nchunks": keng.nchunks,
                         "bounds": list(kres.bounds),
                         "max_abs_diff_vs_direct": diff, "bound": bar,
                         "moments_bit_equal": diff == 0.0}
            if not (np.all(np.isfinite(payload["moments"])) and diff <= bar
                    and n_launch == keng.nchunks * columns):
                raise AssertionError(f"dynamics {name}: {out[name]}")
            kpm_launches += n_launch
            del payload, kres, keng, direct, cfg
            release(device)

        # dynamics: evolve on chain_16_symm against a direct krylov_evolve
        cfg, _ = chain_cfg(evolve_n)
        payload, eres, eeng, evo_s = deterministic(lambda: dynamics.run(
            cfg, solver="evolve", mode="streamed", device=device,
            t_final=APPS_EVOLVE_T))
        direct = deterministic(lambda: krylov_evolve(
            eeng.matvec, t_final=APPS_EVOLVE_T, seed=42))
        same = all(np.array_equal(payload[k], getattr(direct, k))
                   for k in ("times", "energies"))
        out["evolve"] = {"n_states": int(cfg.basis.number_states),
                         "seconds": evo_s, "steps": eres.num_steps,
                         "norm_drift": eres.norm_drift,
                         "energy_drift": eres.energy_drift,
                         "equal_to_direct": same}
        if not (same and eres.norm_drift < 1e-12
                and abs(eres.times[-1] - APPS_EVOLVE_T) < 1e-12):
            raise AssertionError(f"dynamics evolve: {out['evolve']}")
        del payload, eres, eeng, direct, cfg
        release(device)
        out["launches"] = launches + kpm_launches
    finally:
        update_config(stream_compress=saved)
        shutil.rmtree(tmp, ignore_errors=True)
    return out, out["launches"]


# -- phase 15: costmodel ----------------------------------------------------------

#: applies per engine of the phase-attribution leg, and windows of the live
#: tuner (DMT_TUNE_WINDOW applies each; the first apply after a build is
#: not counted)
COSTMODEL_APPLIES = 7
COSTMODEL_WINDOW = 8
COSTMODEL_WINDOWS = 1


def costmodel_phase(device, full_eng, ell_eng, op_cut, e0_cpu=CHAIN32_E0_CPU):
    """The cost model on the card at chain_32_symm's full width, on the
    engines of earlier legs (nothing enumerated), with ``DMT_ARTIFACT_DIR``
    and ``DMT_OBS_DIR`` in a fresh temporary directory (no earlier tuned
    artifact or sidecar can hide a search): the calibration, phase
    attribution with phases on (and the apply median with them off), the
    auto depth, a ``tune="static"`` and a ``tune="live"`` engine, and the
    auto hybrid split on ``op_cut``.  Returns (info, K8 launches on the
    tuned engines' main path, the kernel's largest error on a tuned
    chunk)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from distributed_matvec_tpu_torch import (DistributedEngine, lanczos,
                                              lanczos_block, obs, tune)
    from distributed_matvec_tpu_torch.obs import calibrate, roofline
    from distributed_matvec_tpu_torch.ops import plan_codec as PC
    from distributed_matvec_tpu_torch.utils.config import update_config

    tmp = tempfile.mkdtemp(prefix="dmt_costmodel_")
    knobs = {"DMT_ARTIFACT_DIR": os.path.join(tmp, "artifacts"),
             "DMT_OBS_DIR": os.path.join(tmp, "run"),
             "DMT_ARTIFACT_CACHE": "on", "DMT_PHASES": "on",
             "DMT_TUNE_WINDOW": str(COSTMODEL_WINDOW)}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    obs.reset_all()
    out = {}
    try:
        # -- the calibration, saved where the engines and the tuner look
        t0 = time.perf_counter()
        cal = calibrate.calibrate(device)
        cal["sidecar"] = roofline.save_calibration(cal)
        cal["seconds"] = time.perf_counter() - t0
        got = roofline.resolve_calibration(device=device)
        if got.get("source") != "measured" or not all(
                float(got[k]) > 0 for k in roofline.RATE_FIELDS):
            raise AssertionError(f"the calibration did not resolve as "
                                 f"measured: {got}")
        out["calibration"] = cal

        # -- phase attribution: 7 applies each with phases on, then off
        xh = full_eng.random_hashed(31)
        x_ell = torch.from_numpy(np.random.default_rng(31).standard_normal(
            ell_eng.n_states)).to(device)
        out["phases"] = {}
        for name, eng, x in (("streamed", full_eng, xh),
                             ("ell", ell_eng, x_ell)):
            engine = "local" if name == "ell" else "distributed"
            n0 = len(obs.events("apply_phases"))
            on = apply_walls(device, eng, x, COSTMODEL_APPLIES)
            evs = [e for e in obs.events("apply_phases")[n0:]
                   if e["engine"] == engine]
            if len(evs) != COSTMODEL_APPLIES:
                raise AssertionError(f"{name}: {len(evs)} apply_phases "
                                     f"events for {COSTMODEL_APPLIES} "
                                     "applies")
            report = roofline.roofline_report(evs, cal)
            err = roofline.reconcile_error(report)
            if err > 1e-3:
                raise AssertionError(f"{name}: phase walls reconcile to "
                                     f"{err} of the apply wall")
            os.environ["DMT_PHASES"] = "off"
            n1 = len(obs.events("apply_phases"))
            off = apply_walls(device, eng, x, COSTMODEL_APPLIES)
            if len(obs.events("apply_phases")) != n1:
                raise AssertionError("apply_phases emitted with phases off")
            os.environ["DMT_PHASES"] = "on"
            grp = next(iter(report["groups"].values()))
            out["phases"][name] = {
                "group": grp, "reconcile_error": err,
                "counts": evs[-1]["phases"],
                "apply_ms_median_phases_on": statistics.median(on),
                "apply_ms_median_phases_off": statistics.median(off),
                "apply_ms_phases_on": on, "apply_ms_phases_off": off}
            roofline.print_roofline(report)

        # -- pipeline_depth="auto" on the full leg's engine
        full_eng.pipeline_depth = "auto"
        depth = full_eng.pipeline_depth
        y_auto = deterministic(lambda: full_eng.matvec(xh))
        full_eng.pipeline_depth = 0
        y0 = deterministic(lambda: full_eng.matvec(xh))
        if not torch.equal(y_auto, y0):
            raise AssertionError(f"auto depth {depth} differs from depth 0")
        out["auto_depth"] = {"resolved": depth, "bit_equal_to_depth_0": True,
                             "nchunks": full_eng.nchunks}
        del y_auto, y0

        # -- one tuned build (cut from two, for the time limit): a
        #    tune="live" lossless streamed engine from the full leg's
        #    basis, whose first config is the static search's choice —
        #    checked against choose_config on the same stats and rates —
        #    beside a hand-set twin at the same knobs; the live windows
        #    below run on the same engine
        op = full_eng.operator
        update_config(tune="live")
        tuned, build_s, peak = build_timed(device, lambda: DistributedEngine(
            op, device=device, mode="streamed"))
        t = tuned._tuned
        update_config(tune="off")
        static = tune.choose_config(tuned._tune_stats(), tuned._tune_cal,
                                    "streamed")
        if static.token() != t.token():
            raise AssertionError(f"live engine's first config {t.token()} "
                                 f"is not the static choice {static.token()}")
        twin, twin_s, _ = build_timed(device, lambda: DistributedEngine(
            op, device=device, mode="streamed", batch_size=t.batch_size,
            stream_compress=t.stream_compress,
            pipeline_depth=t.pipeline_depth))
        if tuned.stream_kernel != "cuda":
            raise AssertionError(f"tuned engine {t.token()}: decode path "
                                 f"{tuned.stream_kernel}, not the kernel")
        xt = tuned.random_hashed(33)
        if not torch.equal(deterministic(lambda: tuned.matvec(xt)),
                           deterministic(lambda: twin.matvec(xt))):
            raise AssertionError(f"tuned {t.token()} differs from the "
                                 "hand-set engine")
        ci = tuned.nchunks // 2
        views = tuned._chunk_views(tuned._plan_host[ci, 0].to(device))
        x_c = xt[0, ci * tuned.batch_size:(ci + 1) * tuned.batch_size]
        if x_c.shape[0] < tuned.batch_size:
            x_c = torch.nn.functional.pad(
                x_c, (0, tuned.batch_size - x_c.shape[0]))
        chunk_err = check_kernel((tuned._codec.spec, views[0], views[1],
                                  views[4], tuned._cdict[0],
                                  x_c.contiguous()))
        del views
        # the main path, counted from 0: lanczos_block on the tuned engine,
        # its start block the ell engine's ground state beside a seeded
        # column (a solve to the residual bound on the tuned applies, in
        # few block steps: each 575-chunk apply costs ≈ 0.5 s)
        gs = lanczos(ell_eng.matvec, n=ell_eng.n_states, k=1, tol=1e-12,
                     compute_eigenvectors=True,
                     device=device).eigenvectors[0]
        V0 = tuned.random_hashed(0, cols=2)
        V0[..., 0] = tuned.to_hashed(gs.cpu().numpy())
        del gs
        PC.fused_decode_gather_scatter.launches = 0
        t0 = time.perf_counter()
        res = lanczos_block(tuned.matvec, k=1, V0=V0, tol=1e-11,
                            max_iters=600)
        _sync(device)
        solve_s = time.perf_counter() - t0
        launches = PC.fused_decode_gather_scatter.launches
        e0 = float(res.eigenvalues[0])
        if not (res.converged and abs(e0 - e0_cpu) <= 1e-10):
            raise AssertionError(f"tuned engine E0 {e0} against {e0_cpu} "
                                 f"(converged {res.converged})")
        if device.type == "cuda" and (launches == 0
                                      or launches % tuned.nchunks):
            raise AssertionError(f"{launches} decode launches on the tuned "
                                 f"engine ({tuned.nchunks} chunks)")
        out["static"] = {
            "token": t.token(), "source": t.source,
            "static_choice": static.token(),
            "priced_ms": t.priced_ms, "search_s": tuned.tune_search_s,
            "build_s": build_s, "build_peak_bytes": peak,
            "twin_build_s": twin_s, "nchunks": tuned.nchunks,
            "plan_bytes": int(tuned.plan_bytes),
            "bit_equal_to_hand_set": True, "chunk_max_abs_err": chunk_err,
            "lanczos_block_s": solve_s,
            "lanczos_block_columns": int(res.num_iters), "e0": e0,
            "e0_minus_cpu": e0 - e0_cpu, "launches": launches,
            **apply_times(device, tuned, xt, applies=3)}
        del res

        # -- tune="live": windows of COSTMODEL_WINDOW applies on the same
        #    engine
        live, live_s = tuned, build_s
        del tuned
        first = t
        xl = live.random_hashed(35)
        windows, rekeys = [], []
        PC.fused_decode_gather_scatter.launches = 0
        for _ in range(1 + COSTMODEL_WINDOW * COSTMODEL_WINDOWS):
            prop = live._retune_pending
            if prop is None:
                live.matvec(xl)
            else:
                y = deterministic(lambda: live.matvec(xl))   # re-keys here
                same_plan = (live.batch_size == twin.batch_size
                             and prop.stream_compress == twin.stream_compress)
                hand = twin if same_plan else DistributedEngine(
                    op, device=device, mode="streamed",
                    batch_size=prop.batch_size,
                    stream_compress=prop.stream_compress)
                hand.pipeline_depth = prop.pipeline_depth
                if not torch.equal(y, deterministic(
                        lambda: hand.matvec(xl))):
                    raise AssertionError(f"re-keyed {prop.token()} differs "
                                         "from the hand-set engine")
                rekeys.append({"token": prop.token(),
                               "rebuilt_plan": not same_plan,
                               "bit_equal_to_hand_set": True})
                del y, hand
            tuner = live._tuner
            if tuner.window_closed:
                windows.append({
                    "measured_over_priced": tuner.last_ratio,
                    "proposal": (live._retune_pending.token()
                                 if live._retune_pending is not None
                                 else None),
                    "rates": {k: tuner.posterior.rates()[k]
                              for k in roofline.RATE_FIELDS}})
        launches += PC.fused_decode_gather_scatter.launches
        out["live"] = {"first_token": first.token(),
                       "first_source": first.source, "build_s": live_s,
                       "windows": windows, "rekeys": rekeys,
                       "token": live._tuned.token(),
                       "retune_events": [e for e in obs.events("retune")]}
        del live, twin
        release(device)

        # -- hybrid_split="auto" on tiers' operator
        hyb, hyb_s, _ = build_timed(device, lambda: DistributedEngine(
            op_cut, device=device, mode="hybrid", stream_compress="lossless"))
        hand = DistributedEngine(op_cut, device=device, mode="hybrid",
                                 stream_compress="lossless",
                                 hybrid_split=hyb.hybrid_split)
        xc = hyb.random_hashed(37)
        if not torch.equal(deterministic(lambda: hyb.matvec(xc)),
                           deterministic(lambda: hand.matvec(xc))):
            raise AssertionError(f"auto split {hyb.hybrid_split} differs "
                                 "from the hand-set split")
        out["auto_split"] = {
            "mask": hyb.hybrid_split, "num_terms": hyb.num_terms,
            "hybrid_stream_fraction": hyb.hybrid_stream_fraction,
            "build_s": hyb_s, "bit_equal_to_hand_set": True,
            **apply_times(device, hyb, xc, applies=3)}
        del hyb, hand
        release(device)
        out["launches"] = launches
    finally:
        update_config(tune="off")
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        full_eng.pipeline_depth = 0
        shutil.rmtree(tmp, ignore_errors=True)
    return out, launches, chunk_err


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
    # per-apply phase attribution (one synchronization per apply) is the
    # costmodel phase's subject; the earlier legs time their applies as
    # before, with it off
    os.environ["DMT_PHASES"] = "off"
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    run_phase("build", build_phase)
    _, synth_err = run_phase("kernel_check", kernel_check_phase, device)
    run_phase("small", small_phase, device)
    run_phase("local_small", local_small_phase, device)
    full, eng, launches, chunk_err = run_phase("full", full_phase, device)
    split = run_phase("split", split_phase, device, eng)
    local_full, ell = run_phase("local_full", local_full_phase, device, eng,
                                full["e0"])
    solvers, solver_launches = run_phase("solvers", solvers_phase, device,
                                         eng, ell, full["e0"])
    _, resil_launches = run_phase("resilience", resilience_phase, device,
                                  eng, ell)
    _, cache_launches, cache_err = run_phase("caches", caches_phase, device,
                                             eng)
    _, serve_launches, serve_err = run_phase("serve", serve_phase, device,
                                             full["e0"])
    op = eng.operator
    torch.cuda.empty_cache()
    _, sharded = run_phase("sharded", sharded_phase, device, op, ell)
    torch.cuda.empty_cache()
    _, shards_launches = run_phase("shards", shards_phase, device, op, ell,
                                   eng, sharded["engines"]["streamed"])
    torch.cuda.empty_cache()
    pipe, pipe_launches = run_phase("pipeline", pipeline_phase, device, eng,
                                    sharded.pop("engines"))
    torch.cuda.empty_cache()
    tiers, tier_launches, op_cut = run_phase("tiers", tiers_phase, device,
                                             eng.batch_size)
    ranks = run_phase("ranks", ranks_phase, device, op_cut, eng)
    del op
    torch.cuda.empty_cache()
    run_phase("cross_sector", cross_sector_phase, device,
              tiers["lossless"]["e0"])
    torch.cuda.empty_cache()
    run_phase("local_complex", local_complex_phase, device, full["e0"])
    torch.cuda.empty_cache()
    run_phase("streamed_complex", streamed_complex_phase, device)
    torch.cuda.empty_cache()
    _, apps_launches = run_phase("apps", apps_phase, device, full["e0"],
                                 op_cut)
    torch.cuda.empty_cache()
    _, cost_launches, cost_err = run_phase("costmodel", costmodel_phase,
                                           device, eng, ell, op_cut)
    del ell, eng, op_cut
    emit({"kernels": [{
        "name": "fused_decode_gather_scatter",
        "route": "cuda",
        "source": "distributed_matvec_tpu_torch/csrc/fused_decode.cu",
        "replaces": "distributed_matvec_tpu/ops/plan_codec.py:651",
        "launches": launches + solver_launches + sharded["launches"]
        + pipe_launches + tier_launches + ranks["launches"]
        + serve_launches + cost_launches + resil_launches + apps_launches
        + shards_launches + cache_launches,
        "max_abs_err": max(synth_err, chunk_err, split["plan_max_abs_err"],
                           sharded["max_abs_err"], pipe["kernel_max_abs_err"],
                           tiers["kernel_max_abs_err"],
                           ranks["kernel_max_abs_err"], serve_err, cost_err,
                           cache_err),
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
        # the served streamed job's applies under the solve service (D = 1)
        "launches_serve": serve_launches,
        # the resilience leg's streamed applies (probes, faults, profiled
        # windows; D = 1)
        "launches_resilience": resil_launches,
        # the autotuned engines' applies (static: lanczos_block; live: the
        # tuner's windows), chain_32_symm at D = 1
        "launches_costmodel": cost_launches,
        # the apps leg: the diagonalize solve function's streamed solve at
        # chain_32_symm and the dynamics KPM run (D = 1)
        "launches_apps": apps_launches,
        # the shards leg: the shard-native D = 4 engine's applies and
        # probe, and the full leg's probe apply (D = 1)
        "launches_shards": shards_launches,
        # the caches leg: the disk-tier engine's applies restored from the
        # full engine's saved plan (depth 0, 4, and a rebuilt chunk; D = 1)
        "launches_caches": cache_launches,
        "ms_d4": sharded["ms"], "plain_ms_d4": sharded["plain_ms"],
        "bound_ms_d4": sharded["bound_ms"],
        "bound_by_d4": sharded["bound_by"],
    }, ell_kernel_line(local_full["ell"]["ell_kernel"],
                       local_full["ell"]["kernel_launches"],
                       sharded["ell_launches"])]})
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
