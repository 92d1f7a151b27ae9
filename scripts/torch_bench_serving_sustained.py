#!/usr/bin/env python3
"""Batcher-ceiling bench of the PyTorch port: sustained load on the
micro-batcher with pre-prepped payloads (the port of
``scripts/bench_serving_sustained.py``).

``torch_bench_serving.py`` measures the whole HTTP path with a fresh JPEG
per request, where HTTP and JPEG decoding on the client and handler
threads take their share. This bench isolates the serving code: it drives
``ctpn_tpu_torch.serving.MicroBatcher`` directly with pre-prepped payloads
(``data.synth.render_image`` scenes through ``utils.image.prep_image``)
from a small reused pool, under closed-loop sustained load.

The question it answers: does the micro-batcher itself (gather window,
padding, dispatch/complete pipelining, handler wake-ups) sustain near the
rate of the program it runs, or does it add a ceiling of its own?

    python3 scripts/torch_bench_serving_sustained.py [--seconds 30] \
        [--clients 32] [--max-batch 8] [--pool 16] \
        [--artifact data/artifacts/ctpn_synth_f16.npz] [--device cuda] \
        [--set TPU.NMS_FUSED False TPU.FUSED_STEM True] [--trace]

First the raw rate on the same batch geometry and content: ``run_padded``
at ``--max-batch`` over 12 iterations ended by a fetch. On the card each
``run_padded`` replays the bucket's captured program
(``inference/graphs.py``), so this is the replayed rate; the JSON keeps the
JAX script's key for it, ``jit_rate``. Then ``--clients`` closed-loop
clients on the batcher for ``--seconds``. Prints one JSON line with the
JAX script's keys (``serving_batcher_sustained_throughput``, ``jit_rate``,
``batcher_efficiency`` = sustained / raw, p50 and p99 ms, ok, errors,
shed, batches, images per batch, clients, seconds), plus
``program_runs`` (every ``run_batch`` of the process), the kernel route
and the card's name and power limit as ``nvidia-smi`` prints them, and
``max_ms``, the longest request. Exits 1 when a request failed or was shed.

``--trace`` turns the port's tracing on (``utils/timer.py``) before the
predictor is built: the line then also carries ``spans``, the span totals
of the sustained phase (what ``/healthz`` reports under ``"spans"``), and
``stage_ms``, the stage clock's median device ms per batch of each stage
of the replayed program over that phase (``StageClock.read``).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_bench_serving import count_runs, route_name  # noqa: E402

ARTIFACT = REPO / "data" / "artifacts" / "ctpn_synth_f16.npz"
RAW_ITERS = 12


def payload_pool(n: int) -> list:
    """``n`` distinct pre-prepped (image, info) payloads with text, 900x600
    scenes in the bucket the cfg picks for them."""
    from ctpn_tpu_torch.data.synth import render_image
    from ctpn_tpu_torch.utils.image import prep_image

    rng = np.random.RandomState(5)
    pool = []
    for _ in range(n):
        arr, _ = render_image(rng, width=900, height=600)
        data, info, _pad = prep_image(arr[..., ::-1])
        pool.append((data, info))
    return pool


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--clients", type=int, default=32)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--window-ms", type=float, default=5.0)
    p.add_argument("--pool", type=int, default=16)
    p.add_argument("--artifact", default=str(ARTIFACT))
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' plain versions)")
    p.add_argument("--set", dest="set_cfg", nargs="*", default=[],
                   help="cfg key/value overrides, e.g. the served kernel route")
    p.add_argument("--trace", action="store_true",
                   help="trace the sustained phase: span totals and stage times")
    args = p.parse_args(argv)

    from ctpn_tpu_torch.config import cfg, cfg_from_list
    from ctpn_tpu_torch.utils import timer
    from ctpn_tpu_torch.utils.device import resolve_device

    cfg_from_list(args.set_cfg)
    timer.enable(args.trace)
    dev = resolve_device(args.device)

    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.parallel.multicard import card_line
    from ctpn_tpu_torch.serving import MicroBatcher, _Pending
    from ctpn_tpu_torch.utils.weights import load_params

    card = card_line() if dev.type == "cuda" else "cpu"
    predictor = CTPNPredictor(load_params(args.artifact, device=dev), device=dev)
    runs = count_runs(predictor)
    pool = payload_pool(args.pool)
    bucket = pool[0][0].shape[:2]
    print(f"warming bucket {bucket} at batch {args.max_batch}...", flush=True)
    predictor.warmup(bucket, batch=args.max_batch)

    # the raw replayed rate on the same geometry and content (run_padded
    # includes the same stacking the batcher path pays per batch)
    n = args.max_batch
    _, lines = predictor.run_padded([pool[0][0]] * n, [pool[0][1]] * n, n)
    lines.count.cpu()
    t0 = time.perf_counter()
    for i in range(RAW_ITERS):
        batch = [pool[(i + j) % len(pool)] for j in range(n)]
        _, lines = predictor.run_padded([b[0] for b in batch], [b[1] for b in batch], n)
    lines.count.cpu()
    raw_rate = n * RAW_ITERS / (time.perf_counter() - t0)
    print(f"raw replayed rate (batch {n}): {raw_rate:.1f} img/s", flush=True)

    timer.reset()
    row0 = predictor.clock.row() if args.trace else 0
    batcher = MicroBatcher(predictor, max_batch=n, window_ms=args.window_ms)
    batcher.start()
    lat, errors = [], []
    sent = [0]
    lock = threading.Lock()
    stop_at = time.monotonic() + args.seconds

    def client(cid: int):
        k = cid
        while time.monotonic() < stop_at:
            data, info = pool[k % len(pool)]
            k += args.clients
            item = _Pending(data, info, 1.0, (600, 900),
                            deadline=time.monotonic() + 60.0)
            t0 = time.monotonic()
            with lock:
                sent[0] += 1
            batcher.submit(item)
            if not item.event.wait(timeout=90.0):
                with lock:
                    errors.append("wait timeout")
                continue
            if item.error is not None:
                with lock:
                    errors.append(repr(item.error))
                continue
            with lock:
                lat.append(time.monotonic() - t0)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(args.clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    batcher.stop()
    batcher.join(timeout=60)
    batcher._completer.join(timeout=60)

    lat_ms = np.asarray(lat) * 1e3
    sustained = len(lat) / wall
    if errors:
        print("errors:", errors[:5], file=sys.stderr)
    traced = ({"spans": timer.totals(), "stage_ms": predictor.clock.read(row0)}
              if args.trace else {})
    print(json.dumps({
        "metric": "serving_batcher_sustained_throughput",
        "value": sustained,
        "unit": "images/sec",
        "jit_rate": raw_rate,
        "batcher_efficiency": sustained / raw_rate,
        "p50_ms": float(np.percentile(lat_ms, 50)) if len(lat) else None,
        "p99_ms": float(np.percentile(lat_ms, 99)) if len(lat) else None,
        "max_ms": float(lat_ms.max()) if len(lat) else None,
        "ok": len(lat),
        "errors": len(errors),
        "sent": sent[0],
        "shed": batcher.shed,
        "batches": batcher.batches_run,
        "img_per_batch": batcher.images_run / max(1, batcher.batches_run),
        "clients": args.clients,
        "seconds": wall,
        "program_runs": runs[0],
        "route": route_name(cfg), "device": str(dev), "card": card, **traced,
    }), flush=True)
    return 1 if errors or batcher.shed else 0


if __name__ == "__main__":
    sys.exit(main())
