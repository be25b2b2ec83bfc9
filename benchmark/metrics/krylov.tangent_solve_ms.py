"""Mean device-timeline span of an outer tangent solve: CUDA events around
each outermost call of fgmres by the solver, over the traced segment."""


def read(run):
    spans = (run["trace"] or {}).get("spans", {}).get("tangent_solve")
    return sum(spans) / len(spans) if spans else None
