"""Launch accounting of the hand-written kernels, safe under threads.

Each kernel's wrapper carries ``LAUNCHES``, the total that callers read and
reset, and ``LAUNCHES_BY_DEVICE``, a ``Counter`` keyed by the CUDA device
index the kernel ran on. The launchers add to both under one lock shared by
the ops: with a worker thread per card (``parallel/dp.py``), a plain
``+=`` on an attribute could lose counts, and a caller checks exact counts.

A launch made while a CUDA graph is being captured runs nothing: inside
:func:`recording` it goes to the thread's :class:`Recording` instead of the
counts, and ``inference/graphs.py`` adds the recorded launches to the counts
(:func:`add`) each time it replays the graph. A launcher also hands the
recording any tensor of its own that the captured kernel reads and that
nothing else keeps alive (:func:`hold`; the stem's packed weights), so that
the graph's owner can keep it.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Iterator, List

import torch

_LOCK = threading.Lock()
_local = threading.local()


class Recording:
    """What the launches of one capture recorded: ``launches`` counts
    (wrapper, CUDA index) pairs; ``held`` keeps the tensors handed to
    :func:`hold`."""

    def __init__(self) -> None:
        self.launches: Counter = Counter()
        self.held: List[torch.Tensor] = []


def init(*wrappers) -> None:
    """Set the counts of ``wrappers`` to zero (both the total and the
    counts per device)."""
    with _LOCK:
        for w in wrappers:
            w.LAUNCHES = 0
            w.LAUNCHES_BY_DEVICE = Counter()


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Launches of this thread go to the yielded :class:`Recording` (and
    not to the counts) until the context ends."""
    rec, prev = Recording(), getattr(_local, "rec", None)
    _local.rec = rec
    try:
        yield rec
    finally:
        _local.rec = prev


def count(wrapper, device: torch.device) -> None:
    """One launch of ``wrapper``'s kernel on the CUDA ``device``."""
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.launches[(wrapper, device.index)] += 1
        return
    with _LOCK:
        wrapper.LAUNCHES += 1
        wrapper.LAUNCHES_BY_DEVICE[device.index] += 1


def hold(*tensors: torch.Tensor) -> None:
    """Inside :func:`recording`, keep ``tensors`` in the recording."""
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.held.extend(tensors)


def add(launches: Counter) -> None:
    """Add recorded launches (``Recording.launches``) to the counts: one
    replay of a captured graph."""
    with _LOCK:
        for (wrapper, index), n in launches.items():
            wrapper.LAUNCHES += n
            wrapper.LAUNCHES_BY_DEVICE[index] += n

