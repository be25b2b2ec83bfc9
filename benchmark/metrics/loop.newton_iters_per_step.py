"""Newton iterations a time step over the window: the "newton" records of
the solver's RunLog (one a residual evaluation)."""


def read(run):
    return run["newton"] / run["steps"]
