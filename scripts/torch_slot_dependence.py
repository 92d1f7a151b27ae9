#!/usr/bin/env python3
"""Does an image's output depend on its slot in the padded batch? The
PyTorch port's detect program on one CUDA card, in every bucket the server
serves, at the server's batch and at ``stream_detect``'s, on each route.

    python3 scripts/torch_slot_dependence.py [--setting per_image|batched]
        [--device cuda]

For each bucket of ``cfg.TPU.BUCKETS``, the committed photos of
``docs/demo_results/H`` that land in it and two renders of the port's
``data/synth.py`` sized into it (``content_shape``: 600x600 to 608x608,
600x1016 to 608x1024, ...) go through ``run_padded`` in the first slots of
a batch, then in its last slots behind noise JPEGs of the same size, both
from the replayed program (a batch of noise captures it first); every
image is encoded, decoded, resized and padded as the HTTP server's handler
does. Routes: ``default`` (fused NMS, stock cuDNN block 1), ``served``
(``TPU.NMS_FUSED False TPU.FUSED_STEM True``) and ``O`` (O mode on the
default route). ``--setting batched`` runs the stride-16 convs
(``conv5_1``-``conv5_3``, ``rpn_conv``) on the whole batch, as cuDNN would,
instead of one image at a time (``models/vgg.py::Conv3x3.per_image``, the
test network's setting). Prints one JSON line per route, bucket and batch:

* ``records``, ``rois``: each image's raw records and proposals, first
  slots against last slots, largest difference (or the two counts);
* ``layers``: for every module that has parameters (``param_modules``:
  the convs, the BiLSTM, the heads, the trunk and the whole model), its
  output for the image in slot 1 against the same image in the last slot,
  from the module's own input with those two rows swapped; a module whose
  forward never runs (the BiLSTM's projections, whose weights its forward
  applies itself) is named with ``null``;
* ``ms_per_batch``: the replayed program, 10 batches ended by a fetch,
  three times;

with the route and the card's name and power limit as ``nvidia-smi``
prints them. ``--device cpu`` runs the same at whatever buckets ``--set``
gives (no card number then).
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_bench_serving import fresh_jpeg  # noqa: E402

ARTIFACT = REPO / "data" / "artifacts" / "ctpn_synth_f16.npz"
PHOTOS = sorted((REPO / "docs" / "demo_results" / "H").glob("0*.*g"))
ROUTES = {"default": ([], "H"),
          "served": (["TPU.NMS_FUSED", "False", "TPU.FUSED_STEM", "True"], "H"),
          "O": ([], "O")}
BATCHES = (8, 16)  # the server's max_batch; stream_detect's batch
RENDERS = 2  # renders per bucket, beside the photos that land in it


def largest(a: np.ndarray, b: np.ndarray):
    if a.shape != b.shape:
        return f"counts {len(a)} and {len(b)}"
    return float(np.abs(a.astype(np.float64) - b).max(initial=0.0))


def content_shape(bucket) -> tuple:
    """An image size the handler resizes into ``bucket`` (its padding of 8
    px taken off each side: 600x600 for 608x608, 600x1016 for 608x1024)."""
    return bucket[0] - 8, bucket[1] - 8


def render_body(rng, shape) -> bytes:
    """A PNG of a synthetic scene with text lines, ``shape`` (h, w)."""
    from PIL import Image

    from ctpn_tpu_torch.data.synth import render_image

    buf = io.BytesIO()
    Image.fromarray(render_image(rng, width=shape[1], height=shape[0])[0]).save(
        buf, format="PNG")
    return buf.getvalue()


def handler_prep(body: bytes) -> tuple:
    """The server handler's decode, resize and padding of a request body:
    (padded image, im_info)."""
    import chip_smoke

    return chip_smoke.handler_prep(body)[:2]


def bucket_content(seed: int = 3, photos=PHOTOS, max_batch: int = max(BATCHES)) -> dict:
    """Per bucket of ``cfg.TPU.BUCKETS``: (images, noise), each a list of
    ``handler_prep`` pairs: the photos that land in the bucket and
    :data:`RENDERS` renders sized into it; ``max_batch`` noise JPEGs of the
    render size."""
    from ctpn_tpu_torch.config import cfg

    rng = np.random.RandomState(seed)
    by_bucket = {}
    for photo in photos:
        item = handler_prep(photo.read_bytes())
        by_bucket.setdefault(item[0].shape[:2], []).append(item)
    out = {}
    for bucket in (tuple(b) for b in cfg.TPU.BUCKETS):
        shape = content_shape(bucket)
        images = by_bucket.get(bucket, []) + [handler_prep(render_body(rng, shape))
                                              for _ in range(RENDERS)]
        noise = [handler_prep(fresh_jpeg(rng, shape)) for _ in range(max_batch)]
        for data, _ in images + noise:
            if data.shape[:2] != bucket:
                raise AssertionError(f"{shape} content landed in {data.shape[:2]}, "
                                     f"not {bucket}")
        out[bucket] = (images, noise)
    return out


def slot_runs(pred, images: list, noise: list, batch: int) -> dict:
    """``images`` in the first slots of a batch of ``batch`` (noise after
    them), then in its last slots behind noise: per image, its raw records
    and proposals from each run, and the largest difference of each. A
    batch of noise runs first, so that on the card both compared runs
    replay the shape's captured program, as the server does."""
    k = min(len(images), batch // 2)
    images, fill = images[:k], noise[:batch - k]
    pred.run_padded([it[0] for it in noise[:batch]], [it[1] for it in noise[:batch]], batch)
    runs = {}
    for tag, items in (("first", images + fill), ("last", fill + images)):
        props, lines = pred.run_padded([it[0] for it in items], [it[1] for it in items],
                                       batch)
        runs[tag] = (props.rois.cpu().numpy(), lines.recs.cpu().numpy(),
                     lines.count.cpu().numpy())
    (rf, lf, cf), (rl, ll, cl) = runs["first"], runs["last"]
    last = [batch - k + j for j in range(k)]
    return {"slots_first": list(range(k)), "slots_last": last,
            "records": [largest(lf[j, :cf[j]], ll[s, :cl[s]]) for j, s in enumerate(last)],
            "counts": [int(cf[j]) for j in range(k)],
            "rois": [largest(rf[j], rl[s]) for j, s in enumerate(last)]}


def param_modules(model) -> dict:
    """Every module of ``model`` that holds a parameter, itself or below
    it, by name (the model itself is named ``model``)."""
    return {name or "model": m for name, m in model.named_modules()
            if next(m.parameters(), None) is not None}


def layer_diffs(model, images, dev, slots=(1, 7)) -> dict:
    """For each of :func:`param_modules`: its output for the image in slot
    ``slots[0]`` against the same image in slot ``slots[1]``, from the
    module's own input (recorded on a forward of ``images``) with the two
    rows swapped; None for a module whose forward did not run."""
    import torch
    from torch.utils._pytree import tree_leaves

    from ctpn_tpu_torch.inference.pipeline import forward_features

    a, b = slots
    mods = param_modules(model)
    inputs = {}

    def hook(name):
        def record(mod, args, kwargs):
            inputs.setdefault(name, (args, kwargs))
        return record

    hooks = [m.register_forward_pre_hook(hook(n), with_kwargs=True) for n, m in mods.items()]
    try:
        with torch.inference_mode():
            forward_features(model, torch.as_tensor(images).to(dev))
    finally:
        for h in hooks:
            h.remove()
    out = {}
    with torch.inference_mode():
        for name, mod in mods.items():
            if name not in inputs:
                out[name] = None
                continue
            (x, *rest), kwargs = inputs[name]
            swapped = x.clone()
            swapped[[a, b]] = x[[b, a]]
            got = tree_leaves(mod(x, *rest, **kwargs))
            other = tree_leaves(mod(swapped, *rest, **kwargs))
            out[name] = max(float((p[a].float() - q[b].float()).abs().max())
                            for p, q in zip(got, other))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--artifact", default=str(ARTIFACT))
    p.add_argument("--device", default="cuda")
    p.add_argument("--setting", default="per_image", choices=("per_image", "batched"))
    p.add_argument("--set", dest="set_cfg", nargs="*", default=[])
    args = p.parse_args(argv)

    import torch

    from ctpn_tpu_torch.config import cfg_from_list, reset_cfg
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.models.vgg import Conv3x3
    from ctpn_tpu_torch.parallel.multicard import card_line
    from ctpn_tpu_torch.utils.device import resolve_device
    from ctpn_tpu_torch.utils.weights import load_params

    cfg_from_list(args.set_cfg)
    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu"
    params = load_params(args.artifact, device=dev)
    content = bucket_content()
    for route, (sets, mode) in ROUTES.items():
        reset_cfg()
        cfg_from_list(args.set_cfg + sets)
        pred = CTPNPredictor(params, mode=mode, device=dev)
        if args.setting == "batched":
            for m in pred.model.modules():
                if isinstance(m, Conv3x3):
                    m.per_image = False
        per_image = sorted(n for n, m in pred.model.named_modules()
                           if isinstance(m, Conv3x3) and m.per_image)
        for bucket, (images, noise) in content.items():
            for batch in BATCHES:
                row = slot_runs(pred, images, noise, batch)
                stacked = np.stack([it[0] for it in (images + noise)[:batch]])
                infos = np.stack([it[1] for it in (images + noise)[:batch]])
                ms = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    for _ in range(10):
                        _, lines = pred.run_batch(stacked, infos)
                    lines.count.cpu()
                    ms.append((time.perf_counter() - t0) / 10 * 1e3)
                print(json.dumps({
                    "route": route, "bucket": list(bucket), "batch": batch,
                    "setting": args.setting, "per_image_convs": per_image,
                    "images": len(row["records"]), **row,
                    "layers": layer_diffs(pred.model, stacked, dev, (1, batch - 1)),
                    "ms_per_batch": ms, "card": card}), flush=True)
                pred.graphs.graphs.clear()  # one shape's graph at a time
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
        del pred
    reset_cfg()
    return 0


if __name__ == "__main__":
    sys.exit(main())
