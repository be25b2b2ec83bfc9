"""Phase timing with device synchronization, and a profiler trace.

Port of ``navier_stokes_tpu/utils/timers.py``: a phase closes with
``torch.cuda.synchronize()`` (the counterpart of ``jax.block_until_ready``)
when the timer was made for a CUDA device, so asynchronous kernel launches do
not under-report.  ``trace`` is the counterpart of ``jax.profiler``'s
start_trace / stop_trace: a ``torch.profiler`` run written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

__all__ = ["PhaseTimers", "trace"]


@dataclass
class PhaseTimers:
    """Accumulating named wall-clock timers (device-synchronized)."""

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["phase timings:"]
        width = max((len(k) for k in self.totals), default=0)
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"  {name:<{width}}  total {total * 1e3:9.1f} ms   "
                f"calls {n:5d}   mean {total / n * 1e3:8.2f} ms"
            )
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            k: {"total_s": self.totals[k], "calls": self.counts[k]} for k in self.totals
        }


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler``: host activity, and the
    card's kernels when CUDA is available.  On exit the trace is written
    into ``logdir`` (made if missing) as ``<host>.<pid>.<time>.pt.trace.json``,
    a Chrome trace that TensorBoard and chrome://tracing read.  Yields the
    profiler (``key_averages()`` and the like)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        yield prof
