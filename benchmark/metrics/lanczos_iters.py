"""Mean iterations per solve of the window (``LanczosResult.num_iters``)."""


def read(ctx):
    solves = getattr(ctx.loop, "solves", None)
    if not solves:
        return None
    return sum(s["iters"] for s in solves) / len(solves)
