"""Make CRAFT's weights on the synthetic renders, then score them.

    python -m ctpn_tpu_torch.cli.train_craft_synth --steps 40000 --max-seconds 900 \\
        --out data/artifacts/craft_vgg16bn_synth_f16.npz
    python -m ctpn_tpu_torch.cli.train_craft_synth --eval data/artifacts/craft_vgg16bn_synth_f16.npz

The trunk is CTPN's shipped ``data/artifacts/ctpn_synth_f16.npz``
(``conv1_1``-``conv5_2`` of VGG16 trained on the same renders, with no
batch norm: an identity one folded), frozen: it runs with gradients off
in bfloat16 through the conv epilogue. slice5, the decoder and
``conv_cls`` train in float32
with Adam (the rate divided by 10 at 70 % and 90 % of the steps, or of
``--max-seconds``) on 512x512 crops of a pool of seeded ``data/synth.py``
renders (900x600 scenes, rendered once by spawned workers; each crop
scaled by 0.8-2.0 and mirrored for half, cut by forked workers).

Targets (the paper's section 3.1, at the maps' stride 2): each character
box gets a 2D Gaussian warped into it (the region map), and each pair of
neighbouring characters of a word the same Gaussian warped into their
affinity box, whose corners are the centres of the upper and lower
triangles that each character box's diagonals cut (the affinity map); a
pixel takes the largest value over the boxes. The character boxes are
the renderer's own (``render_image(chars=)``: each glyph's ink box at its
advance in the word; a glyph line's square glyphs), which draws nothing
more for them. The loss is the squared error over both maps with online
hard negative mining: every pixel whose target passes 0.1, and three
times as many of the rest, the worst first (at least 1000 per map and
image). The crop workers run at most two batches a worker ahead of the
loop.

The artifact holds what was trained in the port's ``.npz`` format, its
kernels of 65,536 or more elements as int8 with a float32 scale per output
channel and the rest in float16 (about 7 MB for the 8.3 M parameters,
where float16 would take 15 MB), and names the trunk's artifact beside it
with its sha256 (``__trunk__``, ``__trunk_sha256__``), which
``utils/weights.py``'s loader reads in; so the trunk is stored once.

Scoring (``--eval``, and after training): the port's predictor on 32
held-out renders (scenes from seeds training never draws, resized to
1280x720 as the benchmark's inputs are), precision and recall of its
boxes against the words at polygon IoU 0.5, one to one; words whose
shorter side is under 8 px are don't-care. Prints one JSON line per phase.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import os.path as osp
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ctpn_tpu_torch.cli.train_east_synth import (EVAL_SIZE, HOLDOUT_BASE, SCENE, _sha256,
                                                 match)

TRUNK = "data/artifacts/ctpn_synth_f16.npz"
SIGMA = 0.25  # the Gaussian's deviation, in units of the box's sides
STRIDE = 2


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--scenes", type=int, default=2000, help="renders the crops are cut from")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--crop", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=6,
                   help="crop workers (leave the training loop a core of its own)")
    p.add_argument("--trunk", default=TRUNK)
    p.add_argument("--out", default="data/artifacts/craft_vgg16bn_synth_f16.npz")
    p.add_argument("--holdout", type=int, default=32)
    p.add_argument("--max-seconds", type=float, default=0.0,
                   help="end training after this many seconds (0: run every step)")
    p.add_argument("--save-every", type=int, default=500,
                   help="write the artifact every N steps too (0: at the end only)")
    p.add_argument("--eval", default=None, help="score this artifact and exit")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _render(seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A scene and its word boxes (n, 8)."""
    return _render_chars(seed)[:2]


def _render_chars(seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """A scene, its word boxes (n, 8), its character boxes (m, 8) and the
    word of each character (m,)."""
    from ctpn_tpu_torch.data.synth import render_image

    chars: list = []
    img, polys = render_image(np.random.RandomState(seed), width=SCENE[0], height=SCENE[1],
                              chars=chars)
    flat = [c for w in chars for c in w]
    word_of = np.repeat(np.arange(len(chars)), [len(w) for w in chars])
    return (img, np.asarray(polys, np.float64).reshape(-1, 8),
            np.asarray(flat, np.float64).reshape(-1, 8), word_of.astype(np.int64))


# -------------------------------------------------------------- targets

def affinity_boxes(chars: np.ndarray) -> np.ndarray:
    """(n - 1, 4, 2) affinity boxes of a word's neighbouring characters:
    the centres of each character box's upper and lower triangles (cut by
    its diagonals), joined to the next character's."""
    centre = chars.mean(1)
    upper = (chars[:, 0] + chars[:, 1] + centre) / 3.0
    lower = (chars[:, 2] + chars[:, 3] + centre) / 3.0
    return np.stack([upper[:-1], upper[1:], lower[1:], lower[:-1]], 1)


def paint(heat: np.ndarray, box: np.ndarray) -> None:
    """The Gaussian warped into ``box`` (4, 2) TL, TR, BR, BL in map
    pixels, taken into ``heat`` by maximum: each pixel centre's place
    (u, v) in the box, by the inverse of the affine map that sends the unit
    square's corners TL, TR, BL to the box's."""
    o, ex, ey = box[0], box[1] - box[0], box[3] - box[0]
    det = ex[0] * ey[1] - ex[1] * ey[0]
    if abs(det) < 1e-6:
        return
    h, w = heat.shape
    x0, y0 = np.floor(box.min(0)).astype(int)
    x1, y1 = np.ceil(box.max(0)).astype(int)
    x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1 + 1, w), min(y1 + 1, h)
    if x0 >= x1 or y0 >= y1:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1]
    dx, dy = xs + 0.5 - o[0], ys + 0.5 - o[1]
    u = (dx * ey[1] - dy * ey[0]) / det
    v = (dy * ex[0] - dx * ex[1]) / det
    g = np.exp(-((u - 0.5) ** 2 + (v - 0.5) ** 2) / (2 * SIGMA ** 2))
    g[(u < 0) | (u > 1) | (v < 0) | (v > 1)] = 0.0
    np.maximum(heat[y0:y1, x0:x1], g.astype(np.float32), out=heat[y0:y1, x0:x1])


def craft_targets(chars: np.ndarray, word_of: np.ndarray, h: int, w: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(region, affinity) (h / 2, w / 2) float32 of character boxes (m, 8)
    TL, TR, BR, BL in image pixels, in reading order, and the word of each
    (m,): affinities join the neighbours of a word."""
    region = np.zeros((h // STRIDE, w // STRIDE), np.float32)
    affinity = np.zeros_like(region)
    boxes = np.asarray(chars, np.float64).reshape(-1, 4, 2) / STRIDE
    for c in boxes:
        paint(region, c)
    for k in np.unique(word_of):
        word = boxes[word_of == k]
        for a in affinity_boxes(word) if len(word) > 1 else ():
            paint(affinity, a)
    return region, affinity


def ohem_loss(pred, target, ratio: int = 3, least: int = 1000):
    """Mean squared error over each image's pixels whose target passes 0.1
    and ``ratio`` times as many others, the worst first (at least
    ``least``): ``pred`` and ``target`` (B, H, W). Tensor code with no
    host sync: the negatives are sorted and a rank mask keeps each
    image's worst."""
    import torch

    err = ((pred - target) ** 2).flatten(1)
    pos = target.flatten(1) > 0.1
    n_pos = pos.sum(1)
    k = torch.minimum(torch.clamp(ratio * n_pos, min=least), (~pos).sum(1))
    neg = torch.sort(torch.where(pos, -1.0, err), 1, descending=True).values
    keep = torch.arange(neg.shape[1], device=neg.device)[None] < k[:, None]
    total = torch.where(pos, err, 0.0).sum() + torch.where(keep, neg, 0.0).sum()
    return total / (n_pos.sum() + k.sum()).clamp(min=1)


# ---------------------------------------------------------------- crops
def _crop(img: np.ndarray, chars: np.ndarray, rng: np.random.RandomState, size: int):
    """A scaled, maybe mirrored, ``size`` square crop (zero padded) in BGR
    and its character boxes (a character the frame cuts keeps its whole
    box: its Gaussian is cut by the frame; mirrored, a word's characters
    run right to left, still neighbours)."""
    from PIL import Image

    s = rng.uniform(0.8, 2.0)
    h, w = img.shape[:2]
    nh, nw = max(int(h * s), 1), max(int(w * s), 1)
    im = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
    q = chars * s
    if rng.rand() < 0.5:
        im = im[:, ::-1]
        q = q.reshape(-1, 4, 2).copy()
        q[..., 0] = nw - q[..., 0]
        q = q[:, [1, 0, 3, 2]].reshape(-1, 8)
    y0 = rng.randint(0, max(nh - size, 0) + 1)
    x0 = rng.randint(0, max(nw - size, 0) + 1)
    out = np.zeros((size, size, 3), np.uint8)
    part = im[y0:y0 + size, x0:x0 + size]
    out[:part.shape[0], :part.shape[1]] = part
    return np.ascontiguousarray(out[..., ::-1]), q - np.tile([x0, y0], 4)


_POOL: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []  # the scenes


def _keep_pool(pool) -> None:
    global _POOL
    _POOL = pool


def make_batch(args: Tuple[int, int, int]):
    """One training batch from seed ``seed``: crops of scenes drawn from
    the pool of renders, with their region and affinity targets."""
    seed, batch, size = args
    rng = np.random.RandomState(seed)
    ims, regions, affinities = [], [], []
    for _ in range(batch):
        img, _, chars, word_of = _POOL[rng.randint(len(_POOL))]
        im, q = _crop(img, chars, rng, size)
        r, a = craft_targets(q, word_of, size, size)
        ims.append(im)
        regions.append(r)
        affinities.append(a)
    return np.stack(ims), np.stack(regions), np.stack(affinities)


# ---------------------------------------------------------------- model
TRAINED = ("fc6", "fc7", "up", "cls")


def build_model(trunk: str, device):
    import torch

    from ctpn_tpu_torch.models.craft import CRAFT
    from ctpn_tpu_torch.utils.weights import load_params, params_from_jax

    model = CRAFT(dtype=torch.bfloat16, per_image_tail=False).to(device)
    state = {k: v for k, v in params_from_jax(load_params(trunk, device=device)).items()
             if k.startswith("trunk.") and not k.startswith("trunk.conv5_3.")}
    missing = model.load_state_dict(state, strict=False).missing_keys
    assert all(not k.startswith("trunk.") for k in missing), missing
    for n, p in model.named_parameters():
        p.requires_grad_(n.startswith(TRAINED))
    return model


def export(model, trunk: str, out: str) -> str:
    from ctpn_tpu_torch.utils.weights import _flatten, params_to_jax

    state = {k: v for k, v in model.state_dict().items() if k.startswith(TRAINED)}
    return pack({k: np.asarray(v) for k, v in _flatten(params_to_jax(state))}, trunk, out)


def pack(flat, trunk: str, out: str) -> str:
    """Write the trained leaves ``flat`` (``utils/weights.py::quantized``:
    the large kernels int8 with a scale per output channel, the rest
    float16) and the trunk's name and sha256."""
    from ctpn_tpu_torch.utils.weights import quantized

    flat = quantized(flat)
    flat["__trunk__"] = np.array(osp.basename(trunk))
    flat["__trunk_sha256__"] = np.array(_sha256(trunk))
    os.makedirs(osp.dirname(osp.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **flat)
    return out


def forward_train(model, x):
    """The maps (B, H/2, W/2, 2) with the frozen trunk run in bfloat16
    under no_grad; the decoder and head in float32 with gradients (their
    convs' separate passes, ``Conv3x3.conv_relu``)."""
    import torch

    from ctpn_tpu_torch.inference.pipeline import craft_normalised

    with torch.no_grad():
        taps = model.trunk_taps(craft_normalised(x))
    return model.head(model.decoder([t.float() for t in taps]))


def train(args: argparse.Namespace) -> dict:
    import torch

    t0 = time.perf_counter()
    rng = np.random.RandomState(args.seed)
    with mp.get_context("spawn").Pool(args.workers) as pool:
        scenes = pool.map(_render_chars, rng.randint(0, HOLDOUT_BASE, args.scenes).tolist(),
                          chunksize=8)
    print(json.dumps({"scenes": len(scenes), "s": round(time.perf_counter() - t0, 1)}),
          flush=True)
    crops = mp.get_context("fork").Pool(args.workers, initializer=_keep_pool,
                                        initargs=(scenes,))
    dev = torch.device(args.device)
    torch.manual_seed(args.seed)
    model = build_model(args.trunk, dev)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=args.lr)
    seeds = [(args.seed * 10**6 + i, args.batch, args.crop) for i in range(args.steps)]
    log = []
    t_train = time.perf_counter()
    wait = 0.0
    with crops:
        # at most two batches a worker ahead: results the loop has not
        # taken would pile up in this process and be unpickled beside it
        ahead = deque(crops.apply_async(make_batch, (a,))
                      for a in seeds[:2 * args.workers])
        for step in range(args.steps):
            t_wait = time.perf_counter()
            batch = ahead.popleft().get()
            wait += time.perf_counter() - t_wait
            if step + len(ahead) + 1 < args.steps:
                ahead.append(crops.apply_async(make_batch, (seeds[step + len(ahead) + 1],)))
            done = step / args.steps
            if args.max_seconds:
                done = max(done, (time.perf_counter() - t_train) / args.max_seconds)
            for g in opt.param_groups:
                g["lr"] = args.lr * (0.1 if done >= 0.7 else 1.0) * (0.1 if done >= 0.9 else 1.0)
            x, tr, ta = (torch.from_numpy(np.ascontiguousarray(b)).to(dev) for b in batch)
            maps = forward_train(model, x)
            lr_, la = ohem_loss(maps[..., 0], tr), ohem_loss(maps[..., 1], ta)
            loss = lr_ + la
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            last = step == args.steps - 1 or done >= 1.0
            if step % 100 == 0 or last:
                row = {"step": step, "loss": float(loss.detach()), "region": float(lr_.detach()),
                       "affinity": float(la.detach()), "s": round(time.perf_counter() - t0, 1),
                       "data_wait_s": round(wait, 1)}
                log.append(row)
                print(json.dumps(row), flush=True)
            if args.save_every and step and step % args.save_every == 0:
                export(model, args.trunk, args.out)
            if last:
                break
    model.eval()
    export(model, args.trunk, args.out)
    return {"steps": step + 1, "batch": args.batch, "crop": args.crop, "lr": args.lr,
            "scenes": args.scenes,
            "train_s": round(time.perf_counter() - t0, 1), "final": log[-1],
            "artifact": args.out, "sha256": _sha256(args.out)}


def holdout(n: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n`` held-out renders at 1280x720 (BGR) with their word boxes."""
    from PIL import Image

    out = []
    sx, sy = EVAL_SIZE[0] / SCENE[0], EVAL_SIZE[1] / SCENE[1]
    for i in range(n):
        img, words = _render(HOLDOUT_BASE + i)
        im = np.asarray(Image.fromarray(img).resize(EVAL_SIZE, Image.BILINEAR))
        out.append((np.ascontiguousarray(im[..., ::-1]), words * np.tile([sx, sy], 4)))
    return out


def craft_cfg() -> None:
    from ctpn_tpu_torch.config import cfg_from_list, reset_cfg

    reset_cfg()
    cfg_from_list(["NET_NAME", "CRAFT_VGG16_BN", "TPU.BUCKETS", [[736, 1280]]])


def score(artifact: str, n: int, device: str) -> dict:
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.utils.weights import load_params

    craft_cfg()
    pred = CTPNPredictor(load_params(artifact, device=device), device=device)
    hit = ndet = ngt = 0
    words_n = boxes_n = 0
    for im, words in holdout(n):
        q = words.reshape(-1, 4, 2)
        sides = np.minimum(np.linalg.norm(q[:, 1] - q[:, 0], axis=1),
                           np.linalg.norm(q[:, 3] - q[:, 0], axis=1))
        care = sides >= 8
        dets = pred.detect_image(im)
        h, d, g = match(dets, words, care)
        hit, ndet, ngt = hit + h, ndet + d, ngt + g
        words_n += len(words)
        boxes_n += len(dets)
    return {"holdout": n, "matched": hit, "detections": ndet, "words": ngt,
            "precision": hit / max(ndet, 1), "recall": hit / max(ngt, 1),
            "boxes_per_image": boxes_n / max(n, 1), "words_per_image": words_n / max(n, 1)}


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.eval:
        print(json.dumps({"eval": score(args.eval, args.holdout, args.device)}), flush=True)
        return
    recipe = train(args)
    print(json.dumps({"trained": recipe}), flush=True)
    print(json.dumps({"eval": score(args.out, args.holdout, args.device)}), flush=True)


if __name__ == "__main__":
    main()
