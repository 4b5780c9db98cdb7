"""Seconds of the engine's constructor, ending in a synchronize: the ell
tables' build, or the streamed plan's build and host encode."""


def read(ctx):
    return ctx.timings.get("build_s")
