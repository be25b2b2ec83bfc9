"""Outer FGMRES iterations a tangent solve over the window: the solver's
RunLog "gmres" records of the tangent system."""


def read(run):
    return run["fgmres_iters"] / run["solves"] if run["solves"] else None
