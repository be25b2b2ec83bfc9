"""Share of the traced segment in which no operation ran on the card: one
less the union of the profiler's device intervals over the segment."""


def read(run):
    tr = run["trace"]
    if not tr or not tr.get("segment_s") or tr.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["segment_s"])
