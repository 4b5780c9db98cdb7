"""Device-idle milliseconds per column of the profiled segment in which
the host was inside the program's ``apply`` span or any span below it
(``spans.py``): the engine's own host time that leaves the device idle."""

import spans


def read(ctx):
    return spans.per_column_ms(ctx, "apply_us", "n_apply")
