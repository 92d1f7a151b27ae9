"""HTTP detection service with micro-batching on one CUDA card (the port of
``ctpn_tpu.serving``).

The unit of throughput on the card is the batch, so the server coalesces
concurrent requests into bucket-keyed micro-batches:

* requests decode, resize and pad on the handler thread (parallel under
  the ThreadingHTTPServer);
* a dispatcher thread gathers pending items for the SAME bucket within a
  short window, pads the batch to a fixed size and queues it on the device
  (one input shape per bucket);
* a completer thread fetches finished batches with ``.cpu()`` and wakes the
  handlers, so the card runs batch k while batch k-1's results stream out
  and batch k+1 (possibly another bucket) is gathered;
* responses carry line records mapped back to original image coordinates.

Endpoints:
  POST /detect        body = image bytes (JPEG/PNG);
                      optional ?mode=H|O is fixed per server (400 if it
                      disagrees with the server's mode)
  GET  /healthz       liveness, device and the buckets run so far; with
                      tracing on (``ctpn-torch-serve --trace``), the
                      span totals of ``utils/timer.py`` under "spans"

Spans (tracing on): ``serve.decode`` (the handler's read, decode, resize
and prep), ``serve.gather``, ``serve.dispatch``, ``serve.fetch`` (the
completer's ``.cpu()``), ``serve.unscale``; added intervals:
``serve.queue_wait`` (submit until the dispatcher takes the item) and
``serve.accept_wait`` (the accept until the handler thread starts).

Protocol (JSON response):
  {"boxes": [[x0,y0,x1,y1,x2,y2,x3,y3,score], ...], "count": N,
   "mode": "H", "image_shape": [h, w]}
"""

from __future__ import annotations

import io
import json
import queue as queue_mod
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Union

import numpy as np
import torch

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.inference.frozen import FrozenCTPN, FrozenPredictor, is_frozen
from ctpn_tpu_torch.inference.pipeline import CTPNPredictor, unscale_records
from ctpn_tpu_torch.utils import timer
from ctpn_tpu_torch.utils.image import prep_image, resize_im, rgb_to_bgr


def _host(x) -> np.ndarray:
    """A result array on the host: tensors (CUDA or CPU) through ``.cpu()``,
    which waits for the device; ``np.asarray`` refuses a CUDA tensor."""
    return np.asarray(x.cpu()) if hasattr(x, "cpu") else np.asarray(x)


class _Pending:
    __slots__ = ("image", "info", "f1", "orig_shape", "pad", "deadline",
                 "event", "result", "error", "submitted")

    def __init__(self, image, info, f1, orig_shape, pad=0,
                 deadline=float("inf")):
        self.image = image
        self.info = info
        self.f1 = f1
        self.orig_shape = orig_shape
        self.pad = pad
        self.deadline = deadline  # monotonic time; expired items are shed
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        self.submitted = 0.0  # perf_counter at submit (tracing on)


class MicroBatcher(threading.Thread):
    """Gathers same-bucket requests into fixed-size padded batches.

    Padding to ``max_batch`` keeps one input shape per bucket, so the
    kernels and cuDNN's algorithm choices see the same shapes every time.
    """

    def __init__(self, predictor: CTPNPredictor, max_batch: int = 8,
                 window_ms: float = 5.0):
        super().__init__(daemon=True)
        self.predictor = predictor
        # the predictor's host finishing (CTPN's line union or EAST's
        # quads); a predictor without its own finishes as CTPN's
        self._unscale = getattr(predictor, "unscale", unscale_records)
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self.queue: "queue_mod.Queue[_Pending]" = queue_mod.Queue()
        self._leftover: List[_Pending] = []  # other-bucket items, next round
        # not named _stop: Thread.join() calls a private self._stop()
        self._stop_event = threading.Event()
        self.batches_run = 0
        self.images_run = 0
        self.shed = 0  # expired-before-dispatch requests
        # dispatched-but-unfetched batches: the card runs batch k while the
        # completer thread blocks on batch k-1's results and this thread
        # gathers batch k+1. maxsize bounds the device queue depth (two in
        # flight, as in inference/streaming.py).
        self._done: "queue_mod.Queue" = queue_mod.Queue(maxsize=2)
        self._completer = threading.Thread(
            target=self._complete_loop, daemon=True
        )
        self._completer.start()

    def submit(self, item: _Pending) -> None:
        if timer.enabled():
            item.submitted = time.perf_counter()
        self.queue.put(item)

    def stop(self) -> None:
        self._stop_event.set()
        self.queue.put(None)  # unblock gather
        # The completer sentinel must trail every dispatched batch: if it
        # were enqueued here it could overtake a batch this thread's run()
        # is about to _done.put(), and that batch's handlers would hang
        # until request_timeout_s. run() puts the sentinel when it exits;
        # only put it here if the thread never started.
        if not self.is_alive():
            self._done.put(None)

    def _gather(self) -> List[_Pending]:
        # leftovers (other-bucket items from the previous round) seed this
        # round FIRST: re-queueing them behind new arrivals would starve a
        # minority bucket under sustained majority-bucket load
        if self._leftover:
            first = self._leftover.pop(0)
        else:
            first = self.queue.get()
            if first is None:
                return []
            _taken(first)
        batch = [first]
        bucket = first.image.shape[:2]
        keep = []
        for item in self._leftover:
            if item.image.shape[:2] == bucket and len(batch) < self.max_batch:
                batch.append(item)
            else:
                keep.append(item)
        self._leftover = keep
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            budget = deadline - time.monotonic()
            if budget <= 0:
                break
            try:
                item = self.queue.get(timeout=budget)
            except queue_mod.Empty:
                break
            if item is None:
                break
            _taken(item)
            if item.image.shape[:2] == bucket:
                batch.append(item)
            else:
                self._leftover.append(item)
        return batch

    def run(self) -> None:
        try:
            while not self._stop_event.is_set():
                with timer.span("serve.gather"):
                    batch = self._gather()
                if not batch:
                    continue
                with timer.span("serve.dispatch"):
                    self._dispatch(batch)
        finally:
            # the dispatcher has exited: no further batches can be queued,
            # so the sentinel is the last _done entry
            self._done.put(None)

    def _dispatch(self, batch: List[_Pending]) -> None:
        # shed requests whose client already gave up (504 sent): running
        # them anyway burns device time nobody reads
        now = time.monotonic()
        live = [it for it in batch if it.deadline > now]
        self.shed += len(batch) - len(live)
        for it in batch:
            if it.deadline <= now:
                it.error = TimeoutError("expired before dispatch")
                it.event.set()
        if not live:
            return
        try:
            # queued on the device; the completer thread fetches the values
            _, lines = self.predictor.run_padded(
                [it.image for it in live], [it.info for it in live],
                self.max_batch,
            )
        except Exception as e:  # surfaced to every waiting handler
            for it in live:
                it.error = e
                it.event.set()
            return
        self._done.put((live, lines))  # blocks when 2 batches are in flight

    def _complete_loop(self) -> None:
        """Fetch finished batches and wake their waiting handlers."""
        while True:
            job = self._done.get()
            if job is None:
                return
            live, lines = job
            done = 0  # items whose result is set and event fired
            try:
                with timer.span("serve.fetch"):
                    counts = _host(lines.count)
                    recs_all = _host(lines.recs)
                self.batches_run += 1
                self.images_run += len(live)
                for b, it in enumerate(live):
                    with timer.span("serve.unscale"):
                        it.result = self._unscale(
                            recs_all[b], int(counts[b]), it.f1, it.info,
                            y_off=it.pad,
                        )
                    it.event.set()
                    done = b + 1
            except Exception as e:
                # fail only the UNDELIVERED items: earlier ones already
                # fired their event, and their handler may be mid-response
                for it in live[done:]:
                    it.error = e
                    it.event.set()


def _taken(item: _Pending) -> None:
    """The dispatcher took ``item`` from the queue: its wait there."""
    if timer.enabled() and item.submitted:
        timer.add("serve.queue_wait", time.perf_counter() - item.submitted)


def _decode_image(body: bytes) -> np.ndarray:
    from PIL import Image, ImageOps

    with Image.open(io.BytesIO(body)) as im:
        # camera uploads are commonly stored rotated; honor EXIF like the
        # file loader (utils/image.py::load_image_bgr)
        return rgb_to_bgr(np.asarray(ImageOps.exif_transpose(im).convert("RGB")))


# Largest accepted request body. Past this the request is rejected with
# 413 before any read: an unauthenticated client must not be able to make
# the server allocate unbounded RAM by lying in Content-Length.
MAX_BODY_BYTES = 32 * 1024 * 1024


class _Handler(BaseHTTPRequestHandler):
    server: "DetectionServer"
    # socket-level read timeout: a client that opens a connection and
    # trickles (or never sends) the body holds a handler thread for at
    # most this long
    timeout = 30.0

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.verbose:
            super().log_message(fmt, *args)

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.split("?")[0] != "/healthz":
            return self._json(404, {"error": "not found"})
        srv = self.server
        try:  # snapshot: the batcher thread may be adding a new bucket
            buckets = [list(k) for k in list(srv.predictor.buckets_run)]
        except RuntimeError:  # tiny race window
            buckets = []
        health = {
            "status": "ok",
            "mode": srv.mode,
            "device": str(srv.predictor.device),
            "max_batch": srv.batcher.max_batch,
            "batches_run": srv.batcher.batches_run,
            "images_run": srv.batcher.images_run,
            "requests_shed": srv.batcher.shed,
            "buckets_compiled": buckets,
        }
        if timer.enabled():
            health["spans"] = timer.totals()
        self._json(200, health)

    def do_POST(self):
        path, _, query = self.path.partition("?")
        if path != "/detect":
            return self._json(404, {"error": "not found"})
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            return self._json(400, {"error": "bad Content-Length"})
        # size cap FIRST: every drain/read below is bounded by it, on every
        # error path (the mode-mismatch drain included)
        if length > MAX_BODY_BYTES:
            self.close_connection = True  # don't drain a deliberately huge body
            return self._json(413, {
                "error": f"body exceeds {MAX_BODY_BYTES} bytes",
            })
        want_mode = None
        for kv in query.split("&"):
            if kv.startswith("mode="):
                want_mode = kv[5:].upper()
        if want_mode and want_mode != self.server.mode:
            # drain the (cap-bounded) body so mid-upload clients get the
            # JSON error instead of a connection reset
            if length > 0:
                self.rfile.read(length)
            return self._json(400, {
                "error": f"server runs mode={self.server.mode}",
            })
        if length <= 0:
            return self._json(400, {"error": "empty body"})
        with timer.span("serve.decode"):
            body = self.rfile.read(length)
            try:
                im = _decode_image(body)
            except Exception:
                return self._json(400, {"error": "undecodable image"})
            resized, f1 = resize_im(im, cfg.TEXT.SCALE, cfg.TEXT.MAX_SCALE)
            data, info, pad = prep_image(resized)
        item = _Pending(
            data, info, f1, im.shape[:2], pad=pad,
            deadline=time.monotonic() + self.server.request_timeout_s,
        )
        self.server.batcher.submit(item)
        if not item.event.wait(timeout=self.server.request_timeout_s):
            return self._json(504, {"error": "detection timed out"})
        if item.error is not None:
            return self._json(500, {"error": str(item.error)})
        self._json(200, {
            "boxes": [[round(v, 2) for v in rec] for rec in item.result],
            "count": len(item.result),
            "mode": self.server.mode,
            "image_shape": list(item.orig_shape),
        })


class DetectionServer(ThreadingHTTPServer):
    """Threaded HTTP server wrapping a CTPNPredictor + MicroBatcher."""

    daemon_threads = True
    # socketserver's default listen backlog is 5: a burst of concurrent
    # clients beyond that gets TCP connection resets before a handler
    # thread ever sees them. Detection requests wait for a device batch,
    # so bursts well past the batch size are normal.
    request_queue_size = 128

    def __init__(self, predictor: CTPNPredictor, host: str = "127.0.0.1",
                 port: int = 0, max_batch: int = 8, window_ms: float = 5.0,
                 request_timeout_s: float = 120.0, verbose: bool = False):
        super().__init__((host, port), _Handler)
        self.predictor = predictor
        self.mode = predictor.mode
        self.request_timeout_s = request_timeout_s
        self.verbose = verbose
        self.batcher = MicroBatcher(predictor, max_batch, window_ms)
        self.batcher.start()
        self._accepted = {}  # request socket -> perf_counter at accept

    def get_request(self):
        request, address = super().get_request()
        if timer.enabled():
            self._accepted[request] = time.perf_counter()
        return request, address

    def process_request_thread(self, request, client_address):
        t = self._accepted.pop(request, None)
        if t is not None:  # the handler thread has started
            timer.add("serve.accept_wait", time.perf_counter() - t)
        super().process_request_thread(request, client_address)

    def shutdown(self):
        self.batcher.stop()
        super().shutdown()


def serve(artifact: str, host: str = "127.0.0.1", port: int = 8000,
          mode: Optional[str] = None, max_batch: int = 8,
          window_ms: float = 5.0, warmup_buckets: bool = True,
          request_timeout_s: float = 120.0, verbose: bool = True,
          device: Union[str, torch.device] = "cuda") -> None:
    """Build the predictor on ``device``, optionally warm up at
    ``max_batch``, and serve until interrupted.

    ``artifact`` is a weights ``.npz`` or an orbax artifact directory
    (``utils.weights.load_params``), or a
    frozen artifact of the port (``ctpn-torch-export --frozen``), which
    needs a program per served shape (``--frozen-shapes
    {max_batch}x<bucket>,...``); its warm-up runs every exported
    ``max_batch`` program.
    """
    from ctpn_tpu_torch.utils.weights import load_params

    if is_frozen(artifact):
        predictor = FrozenPredictor(FrozenCTPN(artifact, device=device), mode=mode)
        if verbose:
            print(f"ctpn-torch-serve: frozen artifact, programs "
                  f"{predictor.frozen.shapes}", flush=True)
    else:
        predictor = CTPNPredictor(load_params(artifact, device=device),
                                  mode=mode, device=device)
    server = DetectionServer(
        predictor, host, port, max_batch, window_ms,
        request_timeout_s=request_timeout_s, verbose=verbose,
    )
    if warmup_buckets and isinstance(predictor, FrozenPredictor):
        predictor.warmup(batch=max_batch)  # all exported max_batch programs
    elif warmup_buckets:
        for bh, bw in cfg.TPU.BUCKETS:
            if verbose:
                print(f"warming bucket ({bh}, {bw}) at batch {max_batch}...",
                      flush=True)
            predictor.warmup((bh, bw), batch=max_batch)
    if verbose:
        h, p = server.server_address
        print(f"ctpn-torch-serve: listening on {h}:{p} "
              f"(mode={server.mode}, max_batch={max_batch}, "
              f"device={predictor.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
