"""Percent of the segment's work in which no kernel or copy ran on the
device: one less the device's busy seconds in the profiled segment over
the seconds the same work takes untraced (``Loop.untraced_s``).

The profiler adds some microseconds of host time to every launch and no
device time; where the host launches as fast as it can, as in the streamed
apply, that time would show as idle gaps which an untraced run does not
have.  The traced segment's own length stays in ``device.window_s``."""


def read(ctx):
    p = ctx.profile
    untraced = ctx.loop.untraced_s() if p is not None else None
    if not untraced:
        return None
    return 100.0 * (1.0 - p["busy_s"] / untraced)
