"""Timing utilities (port of ``ctpn_tpu.utils.timer``).

``Stopwatch`` is the JAX package's accumulating wall-clock stopwatch, as it
is. ``profile_trace`` records a ``torch.profiler`` trace of the host and the
card, written as a Chrome trace (open it in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import math
import os
import time


class Stopwatch:
    """Accumulating wall-clock stopwatch.

    Wrap each timed section in a ``with`` block; per-lap and aggregate
    timings are exposed as properties::

        sw = Stopwatch()
        for batch in loader:
            with sw:
                step(batch)
        print(sw.mean, sw.last)
    """

    def __init__(self) -> None:
        self.laps: list[float] = []
        self._t0: float | None = None

    def __enter__(self) -> "Stopwatch":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        assert self._t0 is not None, "Stopwatch exited without entering"
        self.laps.append(time.perf_counter() - self._t0)
        self._t0 = None
        return False

    @property
    def count(self) -> int:
        return len(self.laps)

    @property
    def last(self) -> float:
        return self.laps[-1] if self.laps else 0.0

    @property
    def total(self) -> float:
        return math.fsum(self.laps)

    @property
    def mean(self) -> float:
        return self.total / len(self.laps) if self.laps else 0.0


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Record a ``torch.profiler`` trace (CPU, and CUDA when the card is
    present) around a code block; writes ``<log_dir>/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
