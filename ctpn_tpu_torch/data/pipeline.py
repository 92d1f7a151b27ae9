"""Async host input pipeline: threaded prefetch (port of
``ctpn_tpu.data.pipeline``).

The reference stubs prefetch off entirely (`config.py:87-89`:
"Use horizontal... prefetch was never useful"; `layer.py:45-53` documents a
blob queue that does not exist). This is the real thing:

* N worker threads decode/resize/pad batches ahead of the training loop
  (image IO is the reference's host bottleneck — SURVEY.md §3.1);
* a bounded queue (depth cfg.TPU.PREFETCH_DEPTH) keeps memory flat;
* a worker's exception reaches the consumer's next ``get``.

The workers build pinned CPU tensors (``assemble_batch(..., pin=True)``);
the train loop uploads them with ``non_blocking=True``, so the copy
overlaps the step before it. Batches reach the consumer in the order they
were sampled, whatever order the workers finish them in: data-parallel
ranks each run a loader over the same seeded layer and slice the batch
they get, so they must get the same batch at every step.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional

from ctpn_tpu_torch.config import cfg


class PrefetchLoader:
    """Wrap a blocking batch source with background prefetch threads."""

    def __init__(
        self,
        next_batch: Callable[[], object] = None,
        depth: Optional[int] = None,
        workers: int = 2,
        sample_fn: Callable[[], object] = None,
        build_fn: Callable[[object], object] = None,
    ):
        """Either pass ``next_batch`` (whole produce step, serialized under a
        lock because samplers like RoIDataLayer keep a shuffle cursor), or
        split it into ``sample_fn`` (cheap, runs under the lock) +
        ``build_fn`` (heavy decode/pad work, runs in parallel workers)."""
        if next_batch is not None:
            self._sample = next_batch
            self._build = lambda x: x
        else:
            if sample_fn is None or build_fn is None:
                raise ValueError("pass next_batch, or both sample_fn and build_fn")
            self._sample = sample_fn
            self._build = build_fn
        self._q: "queue.Queue" = queue.Queue(
            maxsize=depth or cfg.TPU.PREFETCH_DEPTH
        )
        self._lock = threading.Lock()
        self._issued = 0  # sequence number of the next sample (under _lock)
        self._next = 0  # sequence number the consumer takes next
        self._ready: dict = {}  # finished out of order, by sequence number
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(workers)
        ]
        for t in self._threads:
            t.start()

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                with self._lock:
                    seq = self._issued
                    self._issued += 1
                    item = self._sample()
                batch = self._build(item)
            except Exception as e:  # surface errors to the consumer, in order
                self._q.put((seq, e))
                return
            while not self._stop.is_set():
                try:
                    self._q.put((seq, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get(self):
        while self._next not in self._ready:
            seq, item = self._q.get()
            self._ready[seq] = item
        item = self._ready.pop(self._next)
        self._next += 1
        if isinstance(item, Exception):
            raise item
        return item

    def close(self, timeout: float = 60.0) -> None:
        """Stop the workers and wait up to ``timeout`` s for them: a daemon
        thread still inside a torch call when the interpreter exits aborts
        the process."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            while t.is_alive() and time.monotonic() < deadline:
                # drain so a worker blocked on put can exit
                try:
                    while True:
                        self._q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.1)

    def __iter__(self) -> Iterator:
        while True:
            yield self.get()
