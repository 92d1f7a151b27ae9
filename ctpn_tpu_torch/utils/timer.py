"""Timing and tracing (port of ``ctpn_tpu.utils.timer``, and the port's one
tracing system).

``Stopwatch`` is the JAX package's accumulating wall-clock stopwatch, as it
is.

Tracing is off by default; :func:`enable` switches it for the process.

* :func:`span` marks a step of the program where it runs. Off, it is a
  shared ``nullcontext`` (one flag test per span site). On, it enters
  ``torch.profiler.record_function("ctpn." + name)``, so that a profiler
  run shows the span on the clock of the card's events, and adds its host
  seconds to a table of count, total and max per name. :func:`add` records
  an interval measured across threads (a request's wait in a queue).
  :func:`totals` and :func:`reset` read and clear the table.
* :class:`StageClock` times the stages of a program on the card from
  inside it, captured CUDA graph included: the op
  ``ctpn_torch::stage_stamp(ring, slot)`` writes the card's
  ``%globaltimer`` (``ops/csrc/stage_clock.cu``; the plain version on the
  CPU writes ``time.perf_counter_ns()``) into a ring of rows, one row per
  run of the program. A CUDA event captured into a graph would be recorded
  again by the next replay before it could be read; a stamp stays in its
  row until the ring comes round. A stage named ``<parent>.<child>`` is a
  child of the top-level stage ``<parent>``: it stands between the stamps
  before its parent and the parent itself, and is timed from the stamp
  just before it, while a top-level stage is timed from the top-level
  stamp before it, so that adding children never moves a parent.

Spans, all host seconds: ``graphs.upload``, ``graphs.replay``,
``graphs.clone``, ``graphs.capture`` and ``graphs.finish``
(``inference/graphs.py``); ``predict.pad`` (``inference/pipeline.py``);
``serve.decode``, ``serve.gather``, ``serve.dispatch``, ``serve.fetch``,
``serve.unscale`` and, added, ``serve.queue_wait`` and
``serve.accept_wait`` (``serving.py``); ``stream.prep``, ``stream.wait``
and ``stream.fetch`` (``inference/streaming.py``); ``east.pad``,
``east.run``, ``east.fetch`` and ``east.unscale``, the host calls of the
predictor's EAST path, ``craft.pad``, ``craft.run``, ``craft.fetch``
and ``craft.unscale``, those of its CRAFT path, and ``db.pad``, ``db.run``,
``db.fetch`` and ``db.unscale``, those of its DB path
(``inference/pipeline.py``).

The stage clock's stages are :data:`STAGES` for CTPN's program and
:data:`EAST_STAGES` for EAST's: ``trunk`` (the VGG16 taps), ``merge`` (the
merge branch and the heads), ``decode`` (threshold, raster compaction,
RBOX restore), ``lanms`` (the locality-aware walk) and ``quad_nms`` (sort,
bitmask, resolve, records); and :data:`CRAFT_STAGES` for CRAFT's:
``trunk`` (the normalisation and the taps), ``decoder`` (slice5, the
U-net blocks and ``conv_cls``), ``label`` (the connected components) and
``boxes`` (the minimum-area boxes); and :data:`DB_STAGES` for DB's:
``dcnNN_in`` and ``dcnNN_out`` around each deformable site NN of the trunk
(a stage from the stamp before it, so ``dcnNN_out`` is the site's time:
the offset conv, the sampling and the product), ``trunk`` (to the trunk's
end), ``neck`` (the FPN), ``head`` (the binarize head), ``label`` and
``boxes``; and the children of ``neck``: ``neck.lateral`` (the 1x1
lateral convs), ``neck.topdown`` (the upsample-and-add passes),
``neck.smooth`` (the 3x3 convs) and ``neck.fuse`` (the upsamples to
stride 4 and the concat), and of ``head``: ``head.conv`` (the 3x3 conv
and the first transposed conv) and ``head.map`` (the float32 transposed
conv to stride 1 and the sigmoid).
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ctpn_tpu_torch.ops import _kernel
from ctpn_tpu_torch.ops._kernel import INT, PTR


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


# --------------------------------------------------------------- spans
_on = False
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_table: Dict[str, list] = {}  # name -> [count, total s, max s]


def enable(on: bool = True) -> None:
    """Switch tracing on or off for the process. A predictor built while it
    is on times its program's stages (:class:`StageClock`)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def add(name: str, seconds: float) -> None:
    """Add one interval of ``seconds`` to ``name``'s totals (tracing on or
    off: callers test :func:`enabled` before they measure)."""
    with _lock:
        row = _table.get(name)
        if row is None:
            _table[name] = [1, seconds, seconds]
        else:
            row[0] += 1
            row[1] += seconds
            row[2] = max(row[2], seconds)


def totals() -> Dict[str, Dict[str, float]]:
    """``{name: {"n": count, "s": total seconds, "max_s": longest}}``."""
    with _lock:
        return {k: {"n": n, "s": s, "max_s": m} for k, (n, s, m) in _table.items()}


def reset() -> None:
    with _lock:
        _table.clear()


class _Span:
    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function("ctpn." + self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        add(self.name, time.perf_counter() - self._t0)
        self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one step of the program: ``ctpn.<name>``
    on the profiler's clock and in :func:`totals` when tracing is on,
    nothing when it is off."""
    return _Span(name) if _on else _NULL


# --------------------------------------------------------- stage clock
STAGES = ("start", "forward", "proposal_layer", "detect_lines")
EAST_STAGES = ("start", "trunk", "merge", "decode", "lanms", "quad_nms")
CRAFT_STAGES = ("start", "trunk", "decoder", "label", "boxes")
# DB's: a stamp before and after each of the 13 deformable sites of the
# trunk (dcn01_in, dcn01_out, ...), then the trunk's end and the rest, the
# decoder's stages each after its children
DB_SITES = 13
DB_STAGES = ("start", *(f"dcn{k:02d}_{side}" for k in range(1, DB_SITES + 1)
                        for side in ("in", "out")), "trunk",
             "neck.lateral", "neck.topdown", "neck.smooth", "neck.fuse", "neck",
             "head.conv", "head.map", "head", "label", "boxes")
ROWS = 256


def _slots(ring: torch.Tensor) -> int:
    return (ring.numel() - 1) // ROWS


def _stamp_ref(ring: torch.Tensor, slot: int) -> None:
    """The plain version: the host's clock in ns into the current row;
    the last slot advances the row counter (the ring's last element)."""
    slots = _slots(ring)
    row = int(ring[-1]) % ROWS
    ring[row * slots + slot] = time.perf_counter_ns()
    if slot == slots - 1:
        ring[-1] += 1


# not counted: a stamp is the clock's, not one of the program's kernels,
# and the launch gates count the program's exactly
_STAMP = _kernel.Entry("stage_stamp", [PTR, INT, INT, INT], source="stage_clock")


def _stamp_launch(ring: torch.Tensor, slot: int) -> None:
    """The op's CUDA implementation: one thread writes ``%globaltimer``."""
    _STAMP(ring.device, ring, ROWS, _slots(ring), int(slot))


_kernel.op("stage_stamp(Tensor(a!) ring, int slot) -> ()", cpu=_stamp_ref, cuda=_stamp_launch)


def _parents(stages) -> list:
    """For each stage after the first, the index of the stamp it is timed
    from: a top-level stage's from the top-level stamp before it, a child's
    (``<parent>.<child>``) from the stamp just before it. Raises
    ``ValueError`` where a child stands at either end or anywhere but
    before its own parent, as the next top-level stage."""
    if "." in stages[0] or "." in stages[-1]:
        raise ValueError(f"a child stage at an end of {stages}")
    out, top = [], 0
    for i, name in enumerate(stages[1:], start=1):
        if "." in name:
            parent = next(s for s in stages[i + 1:] if "." not in s)
            if name.split(".", 1)[0] != parent:
                raise ValueError(f"child stage {name!r} comes before {parent!r}, not its parent")
            out.append(i - 1)
        else:
            out.append(top)
            top = i
    return out


class StageClock:
    """A ring of ``ROWS`` rows of stamps in ns, one per stage of
    ``stages`` (:data:`STAGES`, :data:`EAST_STAGES`, :data:`CRAFT_STAGES`
    or :data:`DB_STAGES`), on ``device``; the row counter (runs stamped in
    full) is the ring's last element, kept on the device.

    ``stamp(name)`` queues the stamp of stage ``name`` on the current
    stream: a program calls ``stamp("start")`` first and passes ``stamp``
    as ``build_detect_fn(on_stage=)``. :meth:`row` and :meth:`read` wait
    for the device.

    Stages nest one level: ``<parent>.<child>`` is a child of the top-level
    stage ``<parent>`` and is stamped after the stamps before its parent
    and before the parent's own, its siblings in the order they run. A
    top-level stage is timed from the top-level stamp before it, so its
    time is the same with or without children; a child from the stamp
    just before it. The constructor raises ``ValueError`` on a child out of
    that place (or first or last)."""

    def __init__(self, device, stages=STAGES):
        self.device = torch.device(device)
        self.stages = tuple(stages)
        self._from = np.array(_parents(self.stages))
        self.ring = torch.zeros(ROWS * len(self.stages) + 1, dtype=torch.int64,
                                device=self.device)
        self._slot = {name: i for i, name in enumerate(self.stages)}

    def stamp(self, name: str) -> None:
        torch.ops.ctpn_torch.stage_stamp(self.ring, self._slot[name])

    def _host(self) -> np.ndarray:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.ring.cpu().numpy()

    def row(self) -> int:
        """Runs stamped in full so far."""
        return int(self._host()[-1])

    def read(self, since_row: int = 0) -> Optional[Dict[str, float]]:
        """Median ms per run of each stage (a top-level stage from the
        top-level stamp before it, a child from the stamp before it) over
        the complete rows from ``since_row`` on that the ring still holds,
        and ``between``: the median ms from one run's last stamp to the
        next run's first. ``rows`` is the count of rows read. None without
        a complete row."""
        host = self._host()
        done = int(host[-1])
        slots = len(self.stages)
        # the oldest held row may be half overwritten by a run stamped later
        first = max(int(since_row), done - ROWS + 1, 0)
        if first >= done:
            return None
        idx = np.arange(first, done) % ROWS
        t = host[:-1].reshape(ROWS, slots)[idx].astype(np.float64)
        steps = (t[:, 1:] - t[:, self._from]) / 1e6
        out = {name: float(np.median(steps[:, i]))
               for i, name in enumerate(self.stages[1:])}
        if len(t) > 1:
            out["between"] = float(np.median(t[1:, 0] - t[:-1, -1]) / 1e6)
        out["rows"] = len(t)
        return out
