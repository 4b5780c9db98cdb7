"""Share of its byte bound that one ``eng.matvec`` call reaches: the bytes
``Y = H·X`` needs whatever implements it (``yardstick.apply_bytes``) at the
card's peak, over the call's median device time from CUDA events."""

import statistics

import yardstick


def read(ctx):
    times = ctx.loop.call_device_ms() if hasattr(ctx.loop,
                                                 "call_device_ms") else []
    nnz = int(ctx.facts.get("nnz_offdiag", -1))
    if not times or nnz < 0:
        return None
    nbytes = yardstick.apply_bytes(int(ctx.facts["n_states"]), nnz,
                                   ctx.columns)
    return 100.0 * yardstick.bound_s(nbytes) / (
        statistics.median(times) * 1e-3)
