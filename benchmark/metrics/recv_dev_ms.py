"""Device milliseconds per column of the streamed receive side: the
kernels the frozen name table puts in ``accumulate`` (``index_add_``) in
the profiled segment, over the columns it applied."""


def read(ctx):
    p = ctx.profile
    if p is None or not p["columns"]:
        return None
    hits = [s for _, s, ph in p["kernels"] if ph == "accumulate"]
    if not hits:
        return None
    return 1e3 * sum(hits) / p["columns"]
