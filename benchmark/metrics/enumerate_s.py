"""Seconds of ``basis.build()``: the enumeration of the sector's
representatives (host C++), on the harness's clock."""


def read(ctx):
    return ctx.timings.get("enumerate_s")
