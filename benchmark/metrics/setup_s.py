"""Process start to the window's first step: imports, kernel load, mesh,
solver set-up, the start state and the warm-up steps (host clock)."""


def read(run):
    return run["setup_s"]
