"""Device milliseconds per column of host-to-device copies (the plan ring)
in the profiled segment, over the columns it applied."""


def read(ctx):
    p = ctx.profile
    if p is None or not p["columns"]:
        return None
    hits = [s for _, s, ph in p["kernels"] if ph == "plan_h2d"]
    if not hits:
        return None
    return 1e3 * sum(hits) / p["columns"]
