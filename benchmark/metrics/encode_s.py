"""Seconds of the streamed plan's host encode inside the engine's build:
the program's own stopwatch of it, ``timings["plan_encode_s"]``."""


def read(ctx):
    return getattr(ctx.engine, "timings", {}).get("plan_encode_s")
