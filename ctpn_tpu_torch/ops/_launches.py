"""Launch accounting of the hand-written kernels, safe under threads.

Each kernel's wrapper carries ``LAUNCHES``, the total that callers read and
reset, and ``LAUNCHES_BY_DEVICE``, a ``Counter`` keyed by the CUDA device
index the kernel ran on. The launchers add to both under one lock shared by
the four ops: with a worker thread per card (``parallel/dp.py``), a plain
``+=`` on an attribute could lose counts, and a caller checks exact counts.
"""

from __future__ import annotations

import threading
from collections import Counter

import torch

_LOCK = threading.Lock()


def init(*wrappers) -> None:
    """Set the counts of ``wrappers`` to zero (both the total and the
    counts per device)."""
    with _LOCK:
        for w in wrappers:
            w.LAUNCHES = 0
            w.LAUNCHES_BY_DEVICE = Counter()


def count(wrapper, device: torch.device) -> None:
    """One launch of ``wrapper``'s kernel on the CUDA ``device``."""
    with _LOCK:
        wrapper.LAUNCHES += 1
        wrapper.LAUNCHES_BY_DEVICE[device.index] += 1
