"""The steady Stokes solution at the inflow of t = 0, the program's
designed start (``stokes_initial_guess``), made in set-up.  The reference
judges it by itself (check "stokes"): the steps after it are judged from
the program's own states."""


def make(solver, traffic: dict):
    return solver.stokes_initial_guess(0.0)


def check(judge, state) -> float:
    return judge.stokes_residual(state)
