"""Share of the bandwidth roofline reached by the windowed kernels over the
traced segment: the bytes their calls must move (benchmark/bytes.py, from
the layout) over the card's peak, against the profiler's device time of
every kernel of the windowed operator (products and merges, by name)."""


def read(run):
    tr = run["trace"]
    if not tr or not tr.get("windowed_s"):
        return None
    return 100.0 * tr["bytes"] / tr["peak_bytes_per_s"] / tr["windowed_s"]
