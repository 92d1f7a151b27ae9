"""The device trace of a ``--trace 1`` run, taken with ``torch.profiler``.

The profiler runs over a part of the window, its last ``TRACE_S`` seconds,
so that the trace's size and the time to read it do not grow with the
window; it is stopped, and the trace read out, once the window has
closed, so that the read-out (seconds on four cards) holds up no work of
the window. The traced window is the span that the harness's own spans
(``bench.*``) cover on the trace's clock, device work clipped to it. From
it come, per card: the seconds in which
a kernel, copy or set ran (the union of their intervals, so overlapping
work counts once),
the device operations by total time, the longest idle gaps, named by the
harness span the host was in (``bench.*``, recorded with
``record_function``) or else by the kernel the gap follows, and the time and count of named kernels.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

TRACE_S = 3.0
ACTIVITIES = (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)


class Tracer:
    """Starts the profiler inside the window (:meth:`tick`, called from
    the driver's loop), stops it after the window and reads it
    (:meth:`finish`)."""

    def __init__(self, run):
        self.run = run
        self.enabled = run.trace and run.device != "cpu"
        self.length = min(TRACE_S, run.seconds)
        self.prof = None
        self.t_on: Optional[float] = None
        self.t_off: Optional[float] = None

    def prime(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        loads and sets up CUPTI, which takes seconds."""
        if not self.enabled:
            return
        with torch.profiler.profile(activities=ACTIVITIES):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def tick(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        if time.perf_counter() >= self.run.window_end() - self.length:
            self.prof = torch.profiler.profile(activities=ACTIVITIES)
            self.prof.start()
            self.t_on = time.perf_counter()

    def finish(self, cards: List[int]) -> None:
        """Stop the profiler (the window has closed) and read the trace
        into ``run.readings['trace']`` and ``run.breakdown``."""
        if not self.enabled:
            return
        if self.prof is None:
            raise RuntimeError("the window ended before the trace started")
        torch.cuda.synchronize()
        self.t_off = time.perf_counter()  # before stop(), which reads the trace out
        self.prof.stop()
        self.run.readings["trace"] = summarize(self.prof.events(), self.t_off - self.t_on,
                                               cards)
        self.run.breakdown = self.run.readings["trace"].pop("breakdown")


def _is_device(e) -> bool:
    return getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA


def summarize(events, window_s: float, cards: List[int]) -> Dict:
    dev = defaultdict(list)
    host = []
    for e in events:
        tr = e.time_range
        if e.name.startswith("bench."):  # a harness span (and its device-side copy)
            if not _is_device(e):
                host.append((tr.start, tr.end, e.name))
        elif _is_device(e):
            dev[int(e.device_index)].append((tr.start, tr.end, e.name))
    if host:  # the window is what the harness's spans cover, on the trace's clock
        w0, w1 = min(h[0] for h in host), max(h[1] for h in host)
        window_s = (w1 - w0) / 1e6
        dev = {c: [(max(s, w0), min(e, w1), n) for s, e, n in ivs if e > w0 and s < w1]
               for c, ivs in dev.items()}
    busy, by_name, gaps = {}, defaultdict(float), []
    kernels: Dict[str, Dict[str, float]] = defaultdict(lambda: {"s": 0.0, "n": 0})
    for card in cards:
        ivs = sorted(dev.get(card, []))
        total, cur_s, cur_e, cur_name = 0.0, None, None, None
        for s, e, name in ivs:
            by_name[name] += (e - s) / 1e6
            k = kernels[name]
            k["s"] += (e - s) / 1e6
            k["n"] += 1
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                    gaps.append((s - cur_e, cur_e, s, cur_name))
                cur_s, cur_e, cur_name = s, e, name
            elif e > cur_e:
                cur_e, cur_name = e, name
        if cur_e is not None:
            total += cur_e - cur_s
        busy[card] = total / 1e6
    gaps.sort(reverse=True)
    named_gaps = []
    for length, g0, g1, before in gaps[:10]:
        mid = (g0 + g1) / 2
        spans = [h for h in host if h[0] <= mid <= h[1]]
        label = (min(spans, key=lambda h: h[1] - h[0])[2] if spans
                 else f"after {before[:80]}")
        named_gaps.append([label, length / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(busy.values()) / max(len(cards), 1),
        "busy_s_by_card": busy,
        "window_s": window_s,
        "kernels": dict(kernels),
        "breakdown": {"device_ops": [[n[:120], s] for n, s in top],
                      "idle_gaps": named_gaps},
    }
