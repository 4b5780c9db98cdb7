"""Share of its byte bound that one launch of the decode kernel reaches:
``yardstick.decode_bytes`` of the engine's plan spec at the card's peak,
over the kernel's mean device time in the profiled segment."""

import yardstick


def read(ctx):
    codec = getattr(ctx.engine, "_codec", None)
    spec = getattr(codec, "spec", None)
    if ctx.profile is None or not spec:
        return None
    times = [s for name, s, _ in ctx.profile["kernels"]
             if yardstick.DECODE_KERNEL in name]
    if not times:
        return None
    nbytes = yardstick.decode_bytes(spec, int(ctx.engine.batch_size))
    return 100.0 * yardstick.bound_s(nbytes) / (sum(times) / len(times))
