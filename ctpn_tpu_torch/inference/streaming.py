"""Streaming inference over image collections (the port of
``ctpn_tpu.inference.streaming``).

* host worker threads decode, resize and pad images into bucket-keyed
  batches (bounded queues);
* a bucket's batch is flushed when it fills, and the last partial batches
  are padded to the fixed batch size, so every launch has one shape per
  bucket;
* two batches in flight: batch k+1 is queued on the device before batch
  k's results are fetched;
* results stream back as (path, records) pairs with boxes mapped to the
  original image coordinates.

Results come back to the host with ``.cpu()`` (``np.asarray`` refuses a
CUDA tensor). With tracing on (``utils/timer.py``), each worker's load,
resize and pad is a ``stream.prep`` span, the main loop's wait for a
prepped image a ``stream.wait`` span, and its fetch of a batch's results
a ``stream.fetch`` span.
"""

from __future__ import annotations

import collections
import queue as queue_mod
import threading
from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.inference.pipeline import CTPNPredictor, unscale_records
from ctpn_tpu_torch.utils import timer
from ctpn_tpu_torch.utils.image import load_image_bgr, prep_image, resize_im


class _Prepped(collections.namedtuple(
        "_Prepped", "path image info f1 orig_shape pad")):
    pass


def _prep_worker(paths_q, out_q, stop):
    while not stop.is_set():
        try:
            path = paths_q.get_nowait()
        except queue_mod.Empty:
            out_q.put(None)
            return
        try:
            with timer.span("stream.prep"):
                im = load_image_bgr(path)
                resized, f1 = resize_im(im, cfg.TEXT.SCALE, cfg.TEXT.MAX_SCALE)
                data, info, pad = prep_image(resized)
            out_q.put(_Prepped(path, data, info, f1, im.shape[:2], pad))
        except Exception as e:  # pragma: no cover - surfaced to the caller
            out_q.put(e)


def stream_detect(
    paths: Iterable[str],
    predictor: CTPNPredictor,
    batch_size: int = 8,
    workers: int = 4,
) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (path, (M, 9) records in original coords) for every image."""
    paths = list(paths)
    paths_q: "queue_mod.Queue" = queue_mod.Queue()
    for p in paths:
        paths_q.put(p)
    out_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=batch_size * 4)
    stop = threading.Event()
    threads = [
        threading.Thread(target=_prep_worker, args=(paths_q, out_q, stop),
                         daemon=True)
        for _ in range(workers)
    ]
    for t in threads:
        t.start()

    # bucket-keyed accumulation; flush when a bucket batch fills
    buckets: Dict[Tuple[int, int], List[_Prepped]] = collections.defaultdict(list)
    done_workers = 0
    inflight: List[Tuple[List[_Prepped], object]] = []
    unscale = getattr(predictor, "unscale", unscale_records)  # EAST's or CTPN's

    def flush(items: List[_Prepped]):
        out = predictor.run_padded(  # queued on the device; padded batch
            [it.image for it in items], [it.info for it in items], batch_size
        )
        inflight.append((items, out))

    def drain():
        items, (_, lines) = inflight.pop(0)
        with timer.span("stream.fetch"):
            counts = lines.count.cpu().numpy()
            recs_all = lines.recs.cpu().numpy()
        for b, it in enumerate(items):
            yield it.path, unscale(
                recs_all[b], int(counts[b]), it.f1, it.info, y_off=it.pad
            )

    try:
        while done_workers < workers or any(buckets.values()):
            if done_workers < workers:
                with timer.span("stream.wait"):
                    item = out_q.get()
                if item is None:
                    done_workers += 1
                    continue
                if isinstance(item, Exception):
                    raise item
                key = item.image.shape[:2]
                buckets[key].append(item)
                if len(buckets[key]) >= batch_size:
                    flush(buckets.pop(key))
            else:
                key = next(k for k, v in buckets.items() if v)
                flush(buckets.pop(key))
            # keep at most 2 batches in flight (double buffering)
            while len(inflight) > 1:
                yield from drain()
        while inflight:
            yield from drain()
    finally:
        stop.set()
