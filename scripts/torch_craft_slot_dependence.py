#!/usr/bin/env python3
"""Does CRAFT's batched program move an image's maps with its slot in the
batch? Conv by conv, then the whole captured program, on one CUDA card.

    python3 scripts/torch_craft_slot_dependence.py [--batch 32]
        [--bucket 736 1280] [--roll 13] [--device cuda]

The batch is ``--batch`` held-out renders at 1280x720
(``cli/train_craft_synth.holdout``) prepped by CRAFT's rule into the
bucket, on the shipped weights (``data/artifacts/craft_vgg16bn_synth_f16.npz``).
Prints one JSON line each:

* ``layers``: every conv of the model (``Conv3x3``, ``Conv1x1``) run on
  the whole batch, from its own input in the batched eager program: its
  output for the batch against each image's alone (batch 1) and against
  the batch rolled by ``--roll`` slots; the images whose output differs
  in any bit (``alone``, ``rolled``), the largest difference, the shape;
* ``program`` for each setting of the convs that run one image at a time:
  ``batched`` (none), ``measured`` (the convs ``layers`` found moving),
  ``shipped`` (those of ``get_network("CRAFT_VGG16_BN")``) and ``tail``
  (every conv from ``conv5_1`` on): the captured program's maps and boxes
  of each image alone and in the rolled batch against the batch's (images
  that differ), the largest map gap to ``tail``'s maps, and the replayed ms
  per batch (10 replays ended by a fetch, the least of three);

with the card's name and power limit as ``nvidia-smi`` prints them.
``--device cpu`` runs the same on the CPU (no card numbers then).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

ARTIFACT = REPO / "data" / "artifacts" / "craft_vgg16bn_synth_f16.npz"


def card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]


def convs(model) -> dict:
    from ctpn_tpu_torch.models.vgg import Conv3x3

    return {n: m for n, m in model.named_modules() if isinstance(m, Conv3x3)}


def set_per_image(model, names) -> None:
    for n, m in convs(model).items():
        m.per_image = n in names


def layers(model, x: torch.Tensor, roll: int) -> dict:
    """Each conv's batched output against its images alone and rolled, from
    the conv's own input in the batched eager program."""
    from ctpn_tpu_torch.inference.pipeline import craft_normalised

    names = {m: n for n, m in convs(model).items()}
    rows = {}

    def hook(mod, args, kwargs):
        name = names[mod]
        inp, n = args[0], args[0].shape[0]

        def f(t):
            return type(mod).forward(mod, t, **kwargs)  # no hooks, as the program calls it

        out = f(inp)
        alone, gap = [], 0.0
        for i in range(n):
            one = f(inp[i:i + 1])
            if not torch.equal(one, out[i:i + 1]):
                alone.append(i)
                gap = max(gap, float((one.float() - out[i:i + 1].float()).abs().max()))
        fmt = (torch.channels_last if inp.is_contiguous(memory_format=torch.channels_last)
               and not inp.is_contiguous() else torch.contiguous_format)
        # the rolled batch in the input's memory format, as the program would hold it
        back = f(inp.roll(roll, 0).contiguous(memory_format=fmt)).roll(-roll, 0)
        rolled = [i for i in range(n) if not torch.equal(back[i], out[i])]
        if rolled:
            gap = max(gap, float((back.float() - out.float()).abs().max()))
        rows[name] = {"alone": alone, "rolled": rolled, "max_abs": gap,
                      "shape": list(out.shape)}

    set_per_image(model, ())
    handles = [m.register_forward_pre_hook(hook, with_kwargs=True) for m in names]
    try:
        with torch.inference_mode():
            model.maps(model.trunk_taps(craft_normalised(x)))
    finally:
        for h in handles:
            h.remove()
    return rows


def answers(out, n: int) -> list:
    text, recs = out
    maps = text.maps.cpu().numpy()
    rr, rc = recs.recs.cpu().numpy(), recs.count.cpu().numpy()
    return [(maps[i], rr[i, :int(rc[i])]) for i in range(n)]


def same(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def program(params, names, x, info, roll: int, dev) -> tuple:
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.models.craft import CRAFT

    model = CRAFT(dtype=torch.bfloat16)
    set_per_image(model, names)
    pred = CTPNPredictor(params, model=model, device=dev)
    n = x.shape[0]
    pred.graphs(x, info)  # the warm-up run and capture
    base = answers(pred.graphs(x, info), n)
    alone = [i for i in range(n)
             if not same(answers(pred.graphs(x[i:i + 1], info[i:i + 1]), 1)[0], base[i])]
    rolled = answers(pred.graphs(x.roll(roll, 0), info.roll(roll, 0)), n)
    moved = [i for i in range(n) if not same(rolled[(i + roll) % n], base[i])]

    def ten():
        for _ in range(10):
            _, recs = pred.graphs(x, info)
        recs.count.cpu()

    ten()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        ten()
        best = min(best, (time.perf_counter() - t0) / 10 * 1e3)
    row = {"per_image": sorted(names), "alone": alone, "rolled": moved, "ms_per_batch": best}
    return row, base


def main(argv=None) -> None:
    from ctpn_tpu_torch.cli.train_craft_synth import holdout
    from ctpn_tpu_torch.config import cfg_from_list, reset_cfg
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.utils.weights import load_params

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--bucket", type=int, nargs=2, default=[736, 1280])
    ap.add_argument("--roll", type=int, default=13)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    reset_cfg()
    cfg_from_list(["NET_NAME", "CRAFT_VGG16_BN", "TPU.BUCKETS", [list(args.bucket)]])
    params = load_params(str(ARTIFACT), device=dev)
    pred = CTPNPredictor(params, device=dev)
    preps = [pred.prep(im) for im, _ in holdout(args.batch)]
    x = torch.from_numpy(np.stack([p[0] for p in preps])).to(dev)
    info = torch.from_numpy(np.stack([p[1] for p in preps])).to(dev)
    head = {"card": card(), "torch": torch.__version__, "batch": args.batch,
            "bucket": args.bucket, "roll": args.roll}

    shipped = {n for n, m in convs(pred.model).items() if m.per_image}
    rows = layers(pred.model, x, args.roll)
    del pred
    print(json.dumps(dict(head, layers=rows)), flush=True)
    moving = {n for n, r in rows.items() if r["alone"] or r["rolled"]}
    tail = {n for n in rows if not n.startswith("trunk.") or n.startswith("trunk.conv5_")}
    settings = {"batched": set(), "measured": moving, "shipped": shipped, "tail": tail}
    results, maps = {}, {}
    for name, names in settings.items():
        results[name], base = program(params, names, x, info, args.roll, dev)
        maps[name] = [a[0] for a in base]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for name, row in results.items():
        row["max_map_gap_to_tail"] = float(max(np.abs(a - b).max()
                                               for a, b in zip(maps[name], maps["tail"])))
        print(json.dumps(dict(head, program=name, **row)), flush=True)


if __name__ == "__main__":
    main()
