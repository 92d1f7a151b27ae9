#!/usr/bin/env python3
"""Does an image's output depend on its slot in the padded batch? The
PyTorch port's detect program on one CUDA card, with its stride-16 convs
(``conv5_1``-``conv5_3``, ``rpn_conv``) batched, as cuDNN runs them, and
one image at a time (``models/vgg.py::Conv3x3.per_image``, the test
network's setting on the card).

    python3 scripts/torch_slot_dependence.py [--set TPU.NMS_FUSED False TPU.FUSED_STEM True]

For each bucket the committed photos of ``docs/demo_results/H`` land in,
a batch of 8 holds those photos in its first slots, then in its last
slots, beside noise JPEGs; every image is decoded, resized and padded as
the HTTP server does. Prints one JSON line per bucket and setting
(``batched``, ``per_image``):

* ``layers``: each conv's output for one photo in slot 1 and in slot 7 of
  the same input (two rows swapped), largest difference;
* ``records``, ``rois``: each photo's records and proposals, first slots
  against last slots, largest difference (or the two counts);
* ``ms_per_batch``: the replayed program, 10 batches ended by a fetch,
  three times;

with the kernel route and the card's name and power limit as
``nvidia-smi`` prints them. ``--device cpu`` runs the same at whatever
buckets ``--set`` gives (no card number then).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_bench_serving import LANDSCAPE, PORTRAIT, fresh_jpeg, route_name  # noqa: E402

ARTIFACT = REPO / "data" / "artifacts" / "ctpn_synth_f16.npz"
PHOTOS = sorted((REPO / "docs" / "demo_results" / "H").glob("0*.*g"))
BATCH = 8


def largest(a: np.ndarray, b: np.ndarray):
    if a.shape != b.shape:
        return f"counts {len(a)} and {len(b)}"
    return float(np.abs(a.astype(np.float64) - b).max(initial=0.0))


def layer_diffs(model, images: np.ndarray, dev) -> dict:
    """Each conv's output for the photo in slot 1 against the same photo in
    slot 7, from the same inputs with rows 1 and 7 swapped."""
    import torch

    from ctpn_tpu_torch.inference.pipeline import forward_features
    from ctpn_tpu_torch.models.vgg import Conv3x3

    inputs = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, n=n: inputs.setdefault(n, args[0].detach()))
        for n, m in model.named_modules() if isinstance(m, Conv3x3)]
    try:
        with torch.inference_mode():
            forward_features(model, torch.from_numpy(images).to(dev))
    finally:
        for h in hooks:
            h.remove()
    mods = dict(model.named_modules())
    out = {}
    with torch.inference_mode():
        for name, x in inputs.items():
            swapped = x.clone()
            swapped[[1, 7]] = x[[7, 1]]
            a, b = mods[name](x)[1], mods[name](swapped)[7]
            out[name] = float((a.float() - b.float()).abs().max())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--artifact", default=str(ARTIFACT))
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", dest="set_cfg", nargs="*", default=[])
    args = p.parse_args(argv)

    from ctpn_tpu_torch.config import cfg, cfg_from_list
    from ctpn_tpu_torch.utils.device import resolve_device

    cfg_from_list(args.set_cfg)
    dev = resolve_device(args.device)

    from chip_smoke import handler_prep
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.models.vgg import Conv3x3
    from ctpn_tpu_torch.parallel.multicard import card_line
    from ctpn_tpu_torch.utils.weights import load_params

    card = card_line() if dev.type == "cuda" else "cpu"
    route = route_name(cfg)
    params = load_params(args.artifact, device=dev)
    rng = np.random.RandomState(3)
    by_bucket = {}
    for photo in PHOTOS:
        data, info = handler_prep(photo.read_bytes())[:2]
        by_bucket.setdefault(data.shape[:2], []).append((data, info))
    noise = {bucket: [handler_prep(fresh_jpeg(rng, LANDSCAPE if bucket[1] > bucket[0]
                                              else PORTRAIT))[:2]
                      for _ in range(BATCH - len(photos))]
             for bucket, photos in by_bucket.items()}
    for setting in ("batched", "per_image"):
        pred = CTPNPredictor(params, device=dev)
        block, reps, _ = pred.model.trunk.stages[-1]  # the stride-16 convs
        tail = {f"trunk.conv{block}_{r}" for r in range(1, reps + 1)} | {"rpn_conv"}
        for name, m in pred.model.named_modules():
            if name in tail:
                m.per_image = setting == "per_image"
        per_image = sorted(n for n, m in pred.model.named_modules()
                           if isinstance(m, Conv3x3) and m.per_image)
        for bucket, photos in by_bucket.items():
            k = len(photos)
            runs = {}
            for tag, items in (("first", photos + noise[bucket]),
                               ("last", noise[bucket] + photos)):
                images = np.stack([it[0] for it in items])
                infos = np.stack([it[1] for it in items])
                pred.run_batch(images, infos)[1].count.cpu()  # warm-up and capture
                props, lines = pred.run_batch(images, infos)
                runs[tag] = (images, infos, props.rois.cpu().numpy(),
                             lines.recs.cpu().numpy(), lines.count.cpu().numpy())
            f, last = runs["first"], runs["last"]
            records = [largest(f[3][j, :f[4][j]], last[3][BATCH - k + j, :last[4][BATCH - k + j]])
                       for j in range(k)]
            rois = [largest(f[2][j], last[2][BATCH - k + j]) for j in range(k)]
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(10):
                    _, lines = pred.run_batch(f[0], f[1])
                lines.count.cpu()
                ms.append((time.perf_counter() - t0) / 10 * 1e3)
            print(json.dumps({
                "bucket": list(bucket), "setting": setting, "per_image_convs": per_image,
                "photos": k, "records": records, "rois": rois,
                "layers": layer_diffs(pred.model, f[0], dev), "ms_per_batch": ms,
                "route": route, "card": card}), flush=True)
        del pred
    return 0


if __name__ == "__main__":
    sys.exit(main())
