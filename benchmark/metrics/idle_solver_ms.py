"""Device-idle milliseconds per column of the profiled segment in which
the host was inside the program's ``solve`` span but in no ``apply``
(``spans.py``): the solver's own host work — its algebra's dispatch, the
convergence checks and the glue."""

import spans


def read(ctx):
    return spans.per_column_ms(ctx, "solver_us", "n_solve")
