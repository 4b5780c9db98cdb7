"""Mean host milliseconds of the program's own ``apply`` span (its
``dur_ms``) over the window's applies, the profiled segment left out."""


def read(ctx):
    if not ctx.apply_ms:
        return None
    return sum(ctx.apply_ms) / len(ctx.apply_ms)
