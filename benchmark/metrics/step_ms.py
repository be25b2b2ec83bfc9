"""Wall time of the window over the whole time steps it completed (host clock,
the window closed by a device synchronisation)."""


def read(run):
    return run["step_ms"]
