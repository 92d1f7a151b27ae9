#!/usr/bin/env python3
"""Streaming benchmark of the PyTorch port: the whole streaming pipeline,
not only the program (the port of ``scripts/bench_streaming.py``).

    python3 scripts/torch_bench_streaming.py [--images 128] [--batch 16] \
        [--workers 8] [--artifact data/artifacts/ctpn_synth_f16.npz] \
        [--corpus DIR] [--latency] [--device cuda] [--set KEY VALUE ...] \
        [--trace]

Measures ``ctpn_tpu_torch.inference.streaming.stream_detect`` end to end:
image decode on host worker threads, resize and bucket padding, two
batches in flight on the card, box un-scaling, over a mixed landscape and
portrait synthetic corpus (``data.synth.generate_dataset``, seed 11, or
``--corpus``), so two buckets and their programs alternate in the run.
Every bucket of the corpus is warmed first (run and captured), with a warm
set stratified by bucket. Without ``--artifact`` the weights are random,
from a fixed seed, as in the JAX script.

With ``--latency`` it also times 16 batch-1 ``detect_image`` calls (host
to card to host), after each bucket's batch-1 program is warmed.

Prints one JSON line per measurement: ``ctpn_streaming_serving_throughput``
and, with ``--latency``, ``ctpn_single_image_latency_p50`` (with p90 and
max). ``vs_baseline`` divides by the target of ``BASELINE.json``, 1000
img/s on a TPU v5e-8, 125 per chip (``"baseline"`` says so): it is not a
figure of any card. Each line carries ``program_runs`` (every
``run_batch`` of the process), the kernel route and the card's name and
power limit as ``nvidia-smi`` prints them.

``--trace`` turns the port's tracing on (``utils/timer.py``) before the
predictor is built: the throughput line then also carries ``spans``, the
span totals of the timed stream (``stream.prep``, ``stream.wait``,
``stream.fetch``, the captured program's ``graphs.*``, ``predict.pad``),
and ``stage_ms``, the
stage clock's median device ms per batch of each stage over it.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_bench_serving import count_runs, route_name  # noqa: E402

TARGET_PER_CHIP = 1000.0 / 8.0  # BASELINE.json: 1000 img/s on a v5e-8
BASELINE = "TPU v5e per-chip target"
LATENCY_IMAGES = 16


def warm_set(paths: list, batch: int) -> list:
    """Up to ``batch`` paths of every bucket the corpus lands in, so that a
    corpus that leads with one orientation leaves no bucket to be built and
    captured inside the timed run."""
    from PIL import Image

    from ctpn_tpu_torch.config import cfg
    from ctpn_tpu_torch.utils.image import pick_bucket, resize_factor

    by_bucket = {}
    for path in paths:
        with Image.open(path) as im:
            w, h = im.size
        f = resize_factor(h, w, cfg.TEXT.SCALE, cfg.TEXT.MAX_SCALE)
        by_bucket.setdefault(
            pick_bucket(int(round(h * f)), int(round(w * f))), []).append(path)
    return sum((ps[:batch] for ps in by_bucket.values()), [])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--images", type=int, default=128)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--artifact", default=None,
                   help="weights .npz (realistic proposal counts); random "
                        "weights from a fixed seed if omitted")
    p.add_argument("--latency", action="store_true",
                   help="also measure single-image latency")
    p.add_argument("--corpus", default=None,
                   help="existing image dir; synthesized if omitted")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' plain versions)")
    p.add_argument("--set", dest="set_cfg", nargs="*", default=[],
                   help="cfg key/value overrides, e.g. the served kernel route")
    p.add_argument("--trace", action="store_true",
                   help="trace the timed stream: span totals and stage times")
    args = p.parse_args(argv)

    from ctpn_tpu_torch.config import cfg, cfg_from_list
    from ctpn_tpu_torch.utils import timer
    from ctpn_tpu_torch.utils.device import resolve_device

    cfg_from_list(args.set_cfg)
    timer.enable(args.trace)
    dev = resolve_device(args.device)

    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.inference.streaming import stream_detect
    from ctpn_tpu_torch.parallel.multicard import card_line

    card = card_line() if dev.type == "cuda" else "cpu"
    if args.artifact:
        from ctpn_tpu_torch.utils.weights import load_params

        params = load_params(args.artifact, device=dev)
    else:
        from ctpn_tpu_torch.models.factory import init_params

        params = init_params(0)
    predictor = CTPNPredictor(params, device=dev)
    runs = count_runs(predictor)
    common = {"route": route_name(cfg), "device": str(dev), "card": card}

    with tempfile.TemporaryDirectory(prefix="bench_stream_") as tmp:
        if args.corpus:
            paths = sorted(sum((glob.glob(os.path.join(args.corpus, e))
                                for e in ("*.jpg", "*.jpeg", "*.png")), []))[: args.images]
        else:
            from ctpn_tpu_torch.data.synth import generate_dataset

            img_dir, _ = generate_dataset(tmp, n_images=args.images, seed=11)
            paths = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)
                           if f.endswith(".jpg"))

        # warm EVERY bucket program outside the timed region
        for _ in stream_detect(warm_set(paths, args.batch), predictor,
                               batch_size=args.batch, workers=args.workers):
            pass
        warm_runs = runs[0]

        timer.reset()
        row0 = predictor.clock.row() if args.trace else 0
        t0 = time.perf_counter()
        n_out = n_boxes = 0
        bad = []
        for path, recs in stream_detect(paths, predictor, batch_size=args.batch,
                                        workers=args.workers):
            n_out += 1
            n_boxes += len(recs)
            if recs.ndim != 2 or recs.shape[1] != 9 or not np.isfinite(recs).all():
                bad.append(f"{path}: bad records {recs.shape}")
        dt = time.perf_counter() - t0
        stream_runs = runs[0] - warm_runs
        errors = len(bad) + len(paths) - n_out
        if errors:
            print("errors:", bad[:5], f"{n_out} of {len(paths)} streamed",
                  file=sys.stderr)

        imgs_per_sec = n_out / dt
        traced = ({"spans": timer.totals(), "stage_ms": predictor.clock.read(row0)}
                  if args.trace else {})
        print(json.dumps({
            "metric": "ctpn_streaming_serving_throughput",
            "value": imgs_per_sec, "unit": "images/sec",
            "vs_baseline": imgs_per_sec / TARGET_PER_CHIP, "baseline": BASELINE,
            "sent": len(paths), "ok": n_out - len(bad), "errors": errors,
            "images": n_out, "batch": args.batch, "workers": args.workers,
            "seconds": dt, "boxes_per_img": n_boxes / max(1, n_out),
            "batches": stream_runs, "program_runs": runs[0], **common, **traced,
        }), flush=True)
        print(f"# device={dev} images={n_out} batch={args.batch} "
              f"workers={args.workers} dt={dt:.3f}s "
              f"boxes/img={n_boxes / max(1, n_out):.1f}", file=sys.stderr)

        if args.latency:
            from ctpn_tpu_torch.utils.image import load_image_bgr

            ims = [load_image_bgr(p) for p in paths[:LATENCY_IMAGES]]
            # warm the batch-1 program of every bucket represented in the set
            seen = set()
            for im in ims:
                if im.shape[:2] not in seen:
                    seen.add(im.shape[:2])
                    predictor.detect_image(im)
            lats = []
            for im in ims:
                t = time.perf_counter()
                predictor.detect_image(im)
                lats.append(time.perf_counter() - t)
            lats = np.array(lats) * 1e3
            print(json.dumps({
                "metric": "ctpn_single_image_latency_p50",
                "value": float(np.percentile(lats, 50)), "unit": "ms",
                "vs_baseline": None,
                "p90_ms": float(np.percentile(lats, 90)), "max_ms": float(lats.max()),
                "calls": len(lats), "program_runs": runs[0], **common,
            }), flush=True)
            print(f"# latency ms p50={np.percentile(lats, 50):.1f} "
                  f"p90={np.percentile(lats, 90):.1f} max={lats.max():.1f}",
                  file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
