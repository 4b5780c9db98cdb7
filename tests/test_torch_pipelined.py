"""The port's pipelined distributed applies against its sequential ones and
the JAX engine, in one process on the CPU: the counterpart of
``tests/test_engine_pipelined.py``.

A ``pipeline_depth >= 2`` apply keeps several chunks' exchanges in flight
and retires them strictly in chunk order, so it changes the schedule and
never the arithmetic.  Tolerances:

* pipelined y (depth 2, 3, 4 and past the chunk count) against the port's
  sequential y: bit for bit, streamed and fused, real and complex sectors;
* against the JAX ``DistributedEngine`` at the same D with
  ``pipeline_depth=4``: atol 1e-14 / rtol 1e-12 (the reference's matvec
  tolerance, TestMatrixVectorProduct.chpl:15-16);
* a streamed block of R > 4 columns runs in column groups of 4, each
  streaming the plan once; R = 6 equals R = 3 + 3 bit for bit in both
  schedules.

The complex-character config runs in fused mode only: the port's streamed
engine refuses complex sectors until the rest of the streamed engine is
ported (ROADMAP Queue 1).
"""

import warnings

import numpy as np
import pytest
import torch

from distributed_matvec_tpu.parallel.distributed import \
    DistributedEngine as JaxEngine
from distributed_matvec_tpu_torch import DistributedEngine
from distributed_matvec_tpu_torch.convert import (operator_arrays,
                                                  operator_from_reference)

from test_operator import build_heisenberg

ATOL, RTOL = 1e-14, 1e-12

#: (n, hw, inv, syms, D) — test_engine_pipelined.PIPE_CONFIGS: a |G| > 1
#: sector, a trivial group on a wider mesh (D − 1 = 3 staged rounds), and a
#: complex-character sector
PIPE_CONFIGS = [
    (12, 6, 1, [([*range(1, 12), 0], 0)], 2),
    (10, 5, None, (), 4),
    (10, 5, None, [([*range(1, 10), 0], 1)], 4),
]
PIPE_CASES = [(mode, i) for i in range(len(PIPE_CONFIGS))
              for mode in ("streamed", "fused")
              if mode == "fused" or i != 2]
B = 32                        # several row chunks per shard


class Config:
    def __init__(self, n, hw, inv, syms):
        self.op_j = build_heisenberg(n, hw, inv, list(syms))
        self.op_j.basis.build()
        self.op_t = operator_from_reference(operator_arrays(self.op_j),
                                            device="cpu")
        self.N = self.op_j.basis.number_states
        self.real = self.op_j.effective_is_real

    def x(self, seed, cols=None):
        rng = np.random.default_rng(seed)
        shape = (self.N,) + ((cols,) if cols else ())
        x = rng.random(shape) - 0.5
        return x if self.real else x + 1j * (rng.random(shape) - 0.5)

    def engine(self, D, mode, depth=None, **kw):
        return DistributedEngine(self.op_t, n_devices=D, mode=mode,
                                 batch_size=B, device="cpu",
                                 pipeline_depth=depth, **kw)


@pytest.fixture(scope="module")
def configs():
    return [Config(*c[:4]) for c in PIPE_CONFIGS]


@pytest.fixture(scope="module")
def chain10(configs):
    return configs[1]


@pytest.mark.parametrize("mode,i", PIPE_CASES,
                         ids=[f"{m}-{i}" for m, i in PIPE_CASES])
def test_pipelined_bit_identical_and_matches_jax(configs, mode, i):
    c, D = configs[i], PIPE_CONFIGS[i][4]
    x = c.x(7)
    seq = c.engine(D, mode, depth=0)
    pipe = c.engine(D, mode, depth=4)
    assert seq.pipeline_depth == 0
    assert pipe.pipeline_depth == (2 if mode == "fused" else 4)
    ys = seq.matvec(seq.to_hashed(x))
    yp = pipe.matvec(pipe.to_hashed(x))
    assert seq.last_pipeline is None
    assert pipe.last_pipeline["chunks"] == pipe.nchunks
    assert torch.equal(ys, yp)
    jax_eng = JaxEngine(c.op_j, n_devices=D, mode=mode, batch_size=B,
                        pipeline_depth=4)
    want = np.asarray(jax_eng.matvec_global(x))
    np.testing.assert_allclose(pipe.from_hashed(yp), want, atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("k", [3, 6])
def test_pipelined_wide_batches(configs, k):
    """Blocks of 3 and 6 columns at D = 8: pipelined = sequential bit for
    bit; R = 6 streams the plan twice (columns 0–3, 4–5) and equals the
    two halves of 3 applied apart."""
    c = configs[1]
    X = c.x(9, cols=k)
    out = {}
    for depth in (0, 2):
        eng = c.engine(8, "streamed", depth=depth)
        streams = []
        orig = eng._stream_chunks

        def counted(*a, **kw):
            streams.append(1)
            return orig(*a, **kw)

        eng._stream_chunks = counted
        Xh = eng.to_hashed(X)
        out[depth] = eng.matvec(Xh)
        assert len(streams) == (k + 3) // 4
        halves = torch.cat([eng.matvec(Xh[:, :, s:s + 3].contiguous())
                            for s in range(0, k, 3)], dim=2)
        assert torch.equal(out[depth], halves)
    assert torch.equal(out[0], out[2])


def test_depth_sweep_and_clamp(chain10):
    """Every depth ≥ 2 gives the same bits; the depth is clamped to the
    chunk count (streamed) and to 2 (fused: JAX's in-program pipeline is
    one exchange deep, reported honestly); the streamed and fused applies
    agree."""
    c = chain10
    x = c.x(11)
    eng = c.engine(4, "streamed")
    assert eng.pipeline_depth == 0
    xh = eng.to_hashed(x)
    ys = eng.matvec(xh)
    nchunks = eng.nchunks
    assert nchunks >= 2
    for depth in (2, 3, nchunks + 7):
        eng.pipeline_depth = depth
        assert eng.pipeline_depth == min(depth, nchunks)
        assert torch.equal(eng.matvec(xh), ys)
        assert eng.last_pipeline["depth"] == min(depth, nchunks)
    fp = c.engine(4, "fused", depth=6)
    assert fp.pipeline_depth == 2
    yf = fp.matvec(xh)
    fp.pipeline_depth = 0
    assert torch.equal(fp.matvec(xh), yf)
    np.testing.assert_allclose(yf, ys, atol=ATOL, rtol=RTOL)


def test_counters_preserved_and_overflow_still_raises(chain10):
    """The fused apply's overflow and out-of-basis counts are the same in
    both schedules, and a capacity too small still raises through the
    pipelined fused apply."""
    c = chain10
    x = c.x(13)
    with pytest.warns(RuntimeWarning, match="capacity"):
        eng = c.engine(4, "fused", depth=2, remote_buffer_size=8)
    xh = eng.to_hashed(x).reshape(4, eng.shard_size, 1)
    counts = {}
    for depth in (0, 2):
        eng.pipeline_depth = depth
        _, overflow, invalid = eng._apply_fused(xh, eng.batch_size,
                                                eng._capacity)
        counts[depth] = (int(overflow), int(invalid))
    assert counts[0] == counts[2] and counts[0][0] > 0
    assert eng.pipeline_depth == 2
    with pytest.raises(RuntimeError, match="overflowed"):
        eng.matvec(eng.to_hashed(x))


def test_depth_refusals_and_modes(chain10):
    """Junk depths raise ``ValueError`` with the JAX message, ``"auto"``
    raises ``NotImplementedError``; off-like values are 0; ell and compact
    always resolve 0; a clamp to one chunk is 0, not a depth-1 pipeline."""
    c = chain10
    eng = c.engine(2, "streamed")
    for bad in ("sideways", -1, "-3"):
        with pytest.raises(ValueError, match="pipeline depth"):
            eng.pipeline_depth = bad
    with pytest.raises(NotImplementedError, match="auto"):
        eng.pipeline_depth = "auto"
    with pytest.raises(ValueError, match="pipeline depth"):
        c.engine(2, "fused", depth="sideways")
    for off in (None, 0, 1, "off", "0", "1", " OFF ", "none"):
        eng.pipeline_depth = off
        assert eng.pipeline_depth == 0
    eng.pipeline_depth = "3"
    assert eng.pipeline_depth == 3
    for mode in ("ell", "compact"):
        assert c.engine(2, mode, depth=3).pipeline_depth == 0
    one = DistributedEngine(c.op_t, n_devices=2, mode="streamed",
                            batch_size=4096, device="cpu", pipeline_depth=4)
    assert one.nchunks == 1 and one.pipeline_depth == 0


def test_last_pipeline_record(chain10):
    """A pipelined apply leaves its record (depth, chunks retired, host ms
    at the barrier); a sequential apply clears it."""
    c = chain10
    eng = c.engine(4, "streamed", depth=3)
    xh = eng.to_hashed(c.x(15))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng.matvec(xh)
    rec = eng.last_pipeline
    assert rec["depth"] == 3 and rec["chunks"] == eng.nchunks
    assert rec["barrier_ms"] >= 0.0
    eng.pipeline_depth = 0
    eng.matvec(xh)
    assert eng.last_pipeline is None
    eng.pipeline_depth = 2
    eng.matvec(eng.to_hashed(c.x(16, cols=6)))
    # two column groups, each retiring every chunk
    assert eng.last_pipeline["chunks"] == 2 * eng.nchunks
