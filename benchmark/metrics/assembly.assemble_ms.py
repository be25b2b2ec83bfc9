"""Mean device-timeline span of a Newton assembly: CUDA events around each
call of assemble_windowed by the solver (K3, the einsums, K4), over the
traced segment."""


def read(run):
    spans = (run["trace"] or {}).get("spans", {}).get("assemble")
    return sum(spans) / len(spans) if spans else None
