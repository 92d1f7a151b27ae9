"""Where the time goes: stage times and top device kernels of the batched
H-mode detect on one CUDA card.

    python3 -m ctpn_tpu_torch.inference.breakdown [--batch 8] [--iters 10]

Runs ``CTPNPredictor`` with the shipped weights on a batch of the committed
demo photos in the 608x912 bucket, after a warm-up, and prints one JSON
object: the card (``nvidia-smi`` name and power limit), the mean wall time
per batch, the mean device time of each stage (CUDA events: trunk + heads,
proposal layer, detector), the device-busy share of a profiled window
(summed kernel time over wall time; overlapping kernels would count
twice, and the detect path runs on one stream), and the top kernels by
device time from ``torch.profiler``. Needs CUDA; raises without it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.inference.pipeline import CTPNPredictor, build_detect_fn
from ctpn_tpu_torch.utils.device import resolve_device
from ctpn_tpu_torch.utils.image import load_image_bgr, prep_image
from ctpn_tpu_torch.utils.weights import load_params

REPO = Path(__file__).resolve().parents[2]
ARTIFACT = REPO / "data" / "artifacts" / "ctpn_synth_f16.npz"
PHOTOS = sorted((REPO / "docs" / "demo_results" / "H").glob("0*.*"))


def _staged(pred: CTPNPredictor, images: torch.Tensor, info: torch.Tensor):
    """Device ms of each stage of the predictor's own detect path, between
    CUDA events recorded at its stage marks."""
    events = []

    def record(name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    detect = build_detect_fn(pred.model, mode=pred.mode, on_stage=record)
    record("start")
    _, lines = detect(images, info)
    lines.count.cpu()
    return [events[i].elapsed_time(events[i + 1]) for i in range(3)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    pred = CTPNPredictor(load_params(str(ARTIFACT), device=dev), device=dev)
    preps = [prep_image(load_image_bgr(str(p)), bucket=(608, 912)) for p in PHOTOS]
    preps = (preps * args.batch)[: args.batch]
    data = np.stack([p[0] for p in preps])
    infos = np.stack([p[1] for p in preps])
    images = torch.from_numpy(data).to(dev)
    info = torch.from_numpy(infos).to(dev)

    def run():
        _, lines = pred.run_batch(data, infos)
        lines.count.cpu()

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / args.iters * 1e3

    stages = np.mean([_staged(pred, images, info) for _ in range(args.iters)], 0)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_ms = lambda e: e.self_device_time_total / 1e3  # noqa: E731
    busy_ms = sum(dev_ms(e) for e in events)
    top = sorted(events, key=dev_ms, reverse=True)[:15]
    result = {
        "card": card,
        "kind": torch.cuda.get_device_name(0),
        "batch": args.batch,
        "bucket": [608, 912],
        "dtype": cfg.TPU.COMPUTE_DTYPE,
        "wall_ms_per_batch": wall_ms,
        "img_per_s": args.batch / wall_ms * 1e3,
        "stage_device_ms": {
            "forward": float(stages[0]),
            "proposal_layer": float(stages[1]),
            "detect_lines": float(stages[2]),
        },
        "profiled_window_ms": window_ms,
        "device_busy_share": busy_ms / window_ms,
        "top_kernels": [
            {"name": e.key[:90], "device_ms": dev_ms(e), "calls": e.count}
            for e in top
        ],
    }
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
