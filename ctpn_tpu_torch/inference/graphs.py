"""Compiled detect programs: one captured CUDA graph per shape, replayed.

The counterpart of the JAX package's compiled programs: ``ONE jit program
per bucket shape`` (``ctpn_tpu/inference/pipeline.py``), kept per shape in
``CTPNPredictor._fns`` and in the persistent compilation cache of
``ctpn_tpu/utils/compilation.py``. PyTorch issues the same program one op
at a time from Python (the BiLSTM alone is a loop of 57 steps per
direction), so on the card the host sets the pace. Here the program is
captured once into a ``torch.cuda.CUDAGraph`` and replayed: one launch of
the whole graph per batch. A graph lives in its process only: there is no
counterpart of the persistent cache.

:class:`DetectGraphs` wraps a detect callable ``(images, im_info) ->``
outputs (``(Proposals, TextLines)``, or the frozen program's flat tuple).
Its machinery, :class:`CapturedPrograms` (static inputs per key, warm-up,
capture, replay, launch accounting), is shared with the captured train
step (``training/graphs.py::TrainGraphs``).

* On a CUDA device, the first call for a key (device, batch, height,
  width, input dtype and the caller's ``variant``: the mode and the NMS
  route) copies the inputs into static input tensors, runs the program
  once on the wrapper's own stream (the warm-up: kernel builds, their
  ``cudaFuncSetAttribute``, cuDNN's plans, the stem's packed weights, the
  device constants) and answers the call with that run's outputs; then it
  captures the program on the same stream into the wrapper's memory pool
  and keeps the graph, its static inputs and outputs, and the kernel
  launches the capture recorded (``ops/_launches.py``).
* Each later call copies the inputs into the static inputs (host arrays
  through pinned memory, tensors already on the card directly, both
  ``non_blocking``), replays the graph, adds the recorded launches to the
  kernels' counts, and clones the outputs, so that the next replay cannot
  overwrite a result still held.

Nothing in a call waits for the card: the caller's stream waits for the
wrapper's stream, and results are fetched with ``.cpu()`` as before. The
warm-up and the capture run with TF32 matmuls off
(``utils/device.py::full_f32_matmul``), so the graph keeps full-f32 matmuls
whatever another thread sets later. A capture or replay that fails raises:
no call falls back to the eager program. Like the JAX package's traced
programs, a graph keeps the cfg it was captured under; ``variant`` names
what the caller may change between calls.

With tracing on (``utils/timer.py``), the steps of a call are spans:
``graphs.upload``, ``graphs.replay``, ``graphs.clone``, ``graphs.capture``
and ``graphs.finish``.

On the CPU the wrapper runs the program eagerly. ``backend`` replaces the
CUDA graph machinery (the tests inject a fake one).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from ctpn_tpu_torch.ops import _launches
from ctpn_tpu_torch.utils import timer
from ctpn_tpu_torch.utils.device import full_f32_matmul

# one warm-up and capture at a time in the process: entering a capture
# synchronizes the card and empties the allocator's cache of every card,
# which must not happen while another thread (a replica) is capturing
_CAPTURE_LOCK = threading.Lock()


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x)


class CudaGraphBackend:
    """Warm-up, capture and replay on one card, on a stream of the
    wrapper's own, into a memory pool of its own."""

    def __init__(self, device: torch.device):
        self.device = device
        with torch.cuda.device(device):
            self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()

    def upload(self, static: torch.Tensor, x: torch.Tensor) -> None:
        """Copy ``x`` into ``static`` on the wrapper's stream without
        waiting for the card: a host tensor through pinned memory, a tensor
        on the card device to device (the caller's stream is followed
        first, :meth:`follow_caller`; :meth:`finish` orders the caller's
        later work, which may reuse ``x``'s memory, after the copy)."""
        with torch.cuda.stream(self.stream):
            static.copy_(x if x.is_cuda else x.pin_memory(), non_blocking=True)

    def run(self, fn: Callable[[], Any]) -> Any:
        with torch.cuda.stream(self.stream):
            return fn()

    def follow_caller(self) -> None:
        """Order the wrapper's stream after the work the caller's stream
        holds so far (a program that reads what the caller wrote: the
        train step reads the parameters)."""
        self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def capture(self, fn: Callable[[], Any]) -> Tuple[torch.cuda.CUDAGraph, Any]:
        graph = torch.cuda.CUDAGraph()
        # thread_local: the other replicas' threads keep running while one
        # captures; this thread may make no host sync inside
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            out = fn()
        return graph, out

    def replay(self, graph: torch.cuda.CUDAGraph) -> None:
        with torch.cuda.stream(self.stream):
            graph.replay()

    def finish(self, out) -> Any:
        """Make the caller's stream wait for the outputs and keep their
        memory until that stream is done with them."""
        caller = torch.cuda.current_stream(self.device)
        caller.wait_stream(self.stream)
        for t in tree_leaves(out):
            t.record_stream(caller)
        return out

    def pool_bytes(self) -> int:
        """Bytes reserved in the pool (the segments of its capture(s))."""
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == tuple(self.pool))


class Captured:
    """One captured program: the graph, its static inputs and outputs, the
    kernel launches its capture recorded (and the tensors the kernels read
    that it keeps alive), the seconds the capture took."""

    def __init__(self, graph, inputs, outputs, recording, capture_s: float):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = recording.launches
        self.held = recording.held
        self.capture_s = capture_s


class CapturedPrograms:
    """One captured program per key on ``device``, replayed; eager on the
    CPU. The shared part of :class:`DetectGraphs` and the train step's
    ``training/graphs.py::TrainGraphs``: a subclass forms the key and the
    program and calls :meth:`_run`. ``graphs`` maps each key to its
    :class:`Captured`; ``warmup_context`` is entered around each warm-up
    run and capture."""

    def __init__(self, device: torch.device, backend: Optional[Any] = None,
                 warmup_context: Callable[[], Any] = contextlib.nullcontext):
        self.device = torch.device(device)
        if backend is None and self.device.type == "cuda":
            backend = CudaGraphBackend(self.device)
        self.backend = backend
        self.warmup_context = warmup_context
        self.graphs: Dict[tuple, Captured] = {}
        self._staged: Dict[tuple, Tuple[torch.Tensor, ...]] = {}
        self._lock = threading.Lock()

    def _guard(self):
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    def _run(self, key: tuple, host: Tuple[torch.Tensor, ...],
             program: Callable[..., Any], capture: bool = True) -> Any:
        """``program(*static inputs)`` for the host tensors ``host``: a
        replay of the key's graph once it has one (outputs cloned), else an
        eager run on the wrapper's stream that answers the call, followed,
        when ``capture``, by the capture of ``program``. A key's static
        inputs are allocated at its first call."""
        entry = self.graphs.get(key)
        if entry is not None:
            with timer.span("graphs.upload"):
                for static, x in zip(entry.inputs, host):
                    self.backend.upload(static, x)
            with timer.span("graphs.replay"):
                self.backend.replay(entry.graph)
            _launches.add(entry.launches)
            # the next replay writes the same memory: hand out copies
            with timer.span("graphs.clone"):
                return self.backend.run(lambda: tree_map(torch.clone, entry.outputs))
        inputs = self._staged.get(key)
        if inputs is None:
            inputs = tuple(torch.empty(x.shape, dtype=x.dtype, device=self.device)
                           for x in host)
            self._staged[key] = inputs
        with timer.span("graphs.upload"):
            for static, x in zip(inputs, host):
                self.backend.upload(static, x)

        def run():
            return program(*inputs)

        with _CAPTURE_LOCK, self.warmup_context():
            out = self.backend.run(run)  # the warm-up answers this call
            if capture:
                t0 = time.perf_counter()
                with _launches.recording() as rec, timer.span("graphs.capture"):
                    graph, static_out = self.backend.capture(run)
                self.graphs[key] = Captured(graph, self._staged.pop(key), static_out,
                                            rec, time.perf_counter() - t0)
        return out

    def pool_mib(self) -> Optional[float]:
        """MiB of the wrapper's graph memory pool (None off the card)."""
        if not isinstance(self.backend, CudaGraphBackend):
            return None
        return self.backend.pool_bytes() / 2**20


class DetectGraphs(CapturedPrograms):
    """``detect(images, im_info)`` captured per shape on ``device`` and
    replayed (see the module's docstring); eager on the CPU.

    ``images`` and ``im_info`` are host arrays (numpy or CPU tensors) or
    tensors already on ``device`` (a bench that times the program without
    the upload); either gives the same key, and so the same program.
    ``variant()``, if given, is called on each call
    and its value joins the key (e.g. the mode and ``cfg.TPU.NMS_FUSED``).
    ``graphs`` maps each key to its :class:`Captured`.
    """

    def __init__(self, detect: Callable, device: torch.device,
                 variant: Optional[Callable[[], Hashable]] = None,
                 backend: Optional[Any] = None):
        super().__init__(device, backend, warmup_context=full_f32_matmul)
        self.detect = detect
        self.variant = variant

    def key(self, images: torch.Tensor) -> tuple:
        extra = self.variant() if self.variant is not None else ()
        return (self.device, *images.shape, images.dtype, extra)

    def _card(self) -> torch.device:
        """The wrapper's device with its index (``cuda`` alone is the
        current card)."""
        if self.device.type != "cuda" or self.device.index is not None:
            return self.device
        return torch.device("cuda", torch.cuda.current_device())

    def __call__(self, images, im_info):
        x, info = _as_tensor(images), _as_tensor(im_info)
        on_card = {t.device for t in (x, info) if t.device.type != "cpu"}
        if on_card and on_card != {self._card()}:
            raise ValueError(f"DetectGraphs takes host arrays (numpy or CPU tensors) "
                             f"or tensors on {self.device}")
        if self.backend is None:  # the CPU: the eager program
            return self.detect(x, info)
        with self._lock, self._guard(), torch.inference_mode():
            if on_card:  # the copies read what the caller's stream wrote
                self.backend.follow_caller()
            out = self._run(self.key(x), (x, info), self.detect)
            with timer.span("graphs.finish"):
                return self.backend.finish(out)
