"""Windowed kernel wrapper calls (K1-K4, ops.windowed.launch_counts) a time
step over the window."""


def read(run):
    return run["launches"] / run["steps"]
