"""Spans the benchmark puts around the program's calls, and the readings it
takes from a torch.profiler trace of one segment: the device's busy time,
the windowed kernels' device time, and the breakdown of device time by
operation and of idle gaps by what the host was doing."""

from __future__ import annotations

import time

import numpy as np
import torch

SEGMENT = "bench.segment"


class Span:
    """The duration of each outermost call of a wrapped function, closed by
    CUDA events on the card (host clock elsewhere), under a profiler label."""

    def __init__(self, name: str, device):
        self.name, self.cuda = name, torch.device(device).type == "cuda"
        self.depth, self.marks = 0, []

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def wrap(self, fn):
        def inner(*a, **k):
            if self.depth:
                return fn(*a, **k)
            self.depth += 1
            m0 = self._mark()
            try:
                with torch.profiler.record_function(self.name):
                    return fn(*a, **k)
            finally:
                self.marks.append((m0, self._mark()))
                self.depth -= 1
        return inner

    def durations_ms(self) -> list:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]


def _events(prof):
    """(device [(name, start_us, end_us)], host [(name, start_us, end_us)])
    from the profiler's kineto events."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            t0, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
        else:
            t0, dur = float(e.start_us()), float(e.duration_us())
        rec = (e.name(), t0, t0 + dur)
        (dev if e.device_type() == torch.autograd.DeviceType.CUDA else host).append(rec)
    return dev, host


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged [start, end] intervals of [n, 2] sorted by start."""
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out).reshape(-1, 2)


def read_trace(prof, kernel_re, top: int = 10) -> dict:
    """Readings of the profiled segment (the host span ``SEGMENT``):
    ``busy_s`` (union of device operations), ``windowed_s`` (device time of
    the kernels whose names ``kernel_re`` finds), ``segment_s`` and the
    ``breakdown`` (at most ``top`` entries each)."""
    dev, host = _events(prof)
    # the profiler repeats host labels (record_function) on the device's
    # timeline: they are no device operations
    labels = {h[0] for h in host}
    dev = [d for d in dev if d[0] not in labels]
    seg = [h for h in host if h[0] == SEGMENT]
    if not seg:
        return {"busy_s": None, "windowed_s": None, "segment_s": None,
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    lo, hi = seg[0][1], seg[0][2]
    dev = [d for d in dev if d[2] > lo and d[1] < hi]
    iv = np.array(sorted((max(s, lo), min(e, hi)) for _, s, e in dev)).reshape(-1, 2)
    busy = _union(iv)
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e6
    by_name = {}
    windowed = 0.0
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        if kernel_re.search(name):
            windowed += (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # idle gaps inside the segment (the longest 3,000), each put to the
    # innermost host operation of 10 us or more running at its middle
    edges = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])[:3000]]
    hs = [h for h in host if h[0] != SEGMENT and h[2] - h[1] >= 10.0]
    names = np.array([h[0] for h in hs], dtype=object)
    hst = np.array([h[1] for h in hs]).reshape(-1)
    hen = np.array([h[2] for h in hs]).reshape(-1)
    idle = {}
    for s, e in gaps:
        mid = (s + e) / 2
        inside = np.nonzero((hst <= mid) & (hen >= mid))[0]
        name = names[inside[np.argmax(hst[inside])]] if len(inside) else "host, no operation"
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e6
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_s, "windowed_s": windowed, "segment_s": (hi - lo) / 1e6,
            "breakdown": {"device_ops": [[n[:160], v] for n, v in ops],
                          "idle_gaps": [[n[:160], v] for n, v in gaps_top]}}
