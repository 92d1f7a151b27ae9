"""Make DBNet-ResNet50-DCN's weights on the synthetic renders, then score
them.

    python -m ctpn_tpu_torch.cli.train_db_synth --steps 20000 --max-seconds 1200 \\
        --out data/artifacts/dbnet_r50_dcn_synth.npz
    python -m ctpn_tpu_torch.cli.train_db_synth --eval data/artifacts/dbnet_r50_dcn_synth.npz

No ResNet is in the repository, so the whole network trains from scratch:
:class:`TrainDBNet`, DBNet in MhLiao/DB's own module layout (its state dict
has MhLiao's names: ``backbone.layer2.0.conv2_offset.weight``,
``decoder.binarize.4.running_var``, ...) with live batch norms, in float32
under bfloat16 autocast with channels_last activations, the offset convs
zero at the start (MhLiao's init: no offset, every mask 0.5). For the
first ``--sample-from`` share of the training (0.75) each deformable conv
runs as what it is at that init, its plain conv at half gain (cuDNN: 50
ms a step at batch 16 against 373 with the sampling, on the card), and
its offset conv is not used; from then on as itself, the plain version's
autograd (``ops/deform_conv.py::deform_conv_ref``, in float32, recomputed
in the backward pass rather than kept: its gathered corners would take
tens of GB at batch 16), continuing from the same function. Adam, the rate divided by
10 at 70 % and 90 % of the steps (or of ``--max-seconds``), on ``--crop``
square crops of a pool of seeded ``data/synth.py`` renders (900x600
scenes, rendered once by spawned workers; each crop scaled by 0.8-2.0 and
mirrored for half, cut by forked workers at most two batches a worker
ahead).

The loss is on the probability map alone, against each word box shrunk
by ``D = A (1 - r^2) / L`` (r = 0.4, A and L the box's area and
perimeter; the shrunk box is the intersection of its edges moved in by
D): the paper's L_s (section 3.4: binary cross-entropy with hard negative
mining at 3:1, every positive pixel and the three times as many negative
pixels of highest loss over the batch) plus the dice loss that the paper
puts on the approximate binary map (L_b), here on the probability map;
the head's last bias starts at -2 (a prior of about 0.12). Trained from
scratch, L_s alone sat at its constant solution (0.25 everywhere, 0.56)
for 900 steps. Words whose shorter side is under 8 px, and the pixels of
their boxes, are left out of the loss (don't-care), as MhLiao's
``min_text_size``. The threshold map is not trained: inference reads only
the probability map.

The artifact (:func:`export`) is the state dict folded by
``utils/weights.py::db_params_from_mhliao``, in the port's ``.npz`` format,
its kernels of 65,536 or more elements int8 with a float32 scale per output
channel and the rest float16.

Scoring (``--eval``, and after training): the port's predictor on 32
held-out renders (scenes from seeds training never draws, resized to
1280x720 as the benchmark's inputs are), precision and recall of its boxes
against the words at polygon IoU 0.5, one to one; words whose shorter side
is under 8 px are don't-care. Prints one JSON line per phase.
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

from ctpn_tpu_torch.cli.train_craft_synth import _crop, _keep_pool, _render, holdout
from ctpn_tpu_torch.cli.train_east_synth import HOLDOUT_BASE, _sha256, match

SHRINK_RATIO = 0.4  # the paper's r
MIN_TEXT = 8.0  # MhLiao's min_text_size: shorter words are don't-care
NEG_RATIO = 3
# DB's normalisation (MhLiao/DB demo.py): the BGR image minus RGB_MEAN, over 255
PIXEL_MEANS = (122.67891434, 116.66876762, 104.00698793)
PIXEL_STD = 255.0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--scenes", type=int, default=2000, help="renders the crops are cut from")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--crop", type=int, default=640)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=3,
                   help="crop workers (the loop launches some 5,700 kernels a step: "
                        "leave it cores of its own)")
    p.add_argument("--sample-from", type=float, default=0.75,
                   help="share of the training after which the deformable convs sample")
    p.add_argument("--out", default="data/artifacts/dbnet_r50_dcn_synth.npz")
    p.add_argument("--holdout", type=int, default=32)
    p.add_argument("--max-seconds", type=float, default=0.0,
                   help="end training after this many seconds (0: run every step)")
    p.add_argument("--save-every", type=int, default=1000,
                   help="write the artifact every N steps too (0: at the end only)")
    p.add_argument("--no-score", action="store_true", help="train only")
    p.add_argument("--eval", default=None, help="score this artifact and exit")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


# -------------------------------------------------------------- targets
def _signed_area(q: np.ndarray) -> float:
    x, y = q[:, 0], q[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def shrink(q: np.ndarray, ratio: float = SHRINK_RATIO) -> Optional[np.ndarray]:
    """The convex polygon ``q`` (n, 2) with each edge moved in by ``D = A (1
    - ratio^2) / L``: each new corner the meeting of its two edges' moved
    lines. None where the result is not a polygon of the same turn."""
    area = _signed_area(q)
    perim = float(np.linalg.norm(np.roll(q, -1, 0) - q, axis=1).sum())
    if abs(area) < 1e-6 or perim <= 0:
        return None
    d = abs(area) * (1 - ratio * ratio) / perim
    e = np.roll(q, -1, 0) - q
    length = np.linalg.norm(e, axis=1)
    if (length < 1e-6).any():
        return None
    normal = np.stack([-e[:, 1], e[:, 0]], 1) / length[:, None] * np.sign(area)
    pts = q + d * normal  # a point of each moved edge
    out = []
    for i in range(len(q)):
        p1, d1, p2, d2 = pts[i - 1], e[i - 1], pts[i], e[i]
        den = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(den) < 1e-9:
            return None
        t = ((p2[0] - p1[0]) * d2[1] - (p2[1] - p1[1]) * d2[0]) / den
        out.append(p1 + t * d1)
    out = np.asarray(out)
    s = _signed_area(out)
    return out if s * area > 0 and abs(s) < abs(area) else None


def short_side(q: np.ndarray) -> float:
    """The shorter side of the quad ``q`` (4, 2) TL, TR, BR, BL."""
    return float(min(np.linalg.norm(q[1] - q[0]), np.linalg.norm(q[3] - q[0])))


def db_targets(words: np.ndarray, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(gt, mask) (h, w) float32 of word boxes (n, 8) in image pixels: gt 1
    inside each shrunk box; mask 0 over the boxes of don't-care words (too
    small, or nothing left once shrunk)."""
    from PIL import Image, ImageDraw

    gt, mask = Image.new("L", (w, h), 0), Image.new("L", (w, h), 1)
    dg, dm = ImageDraw.Draw(gt), ImageDraw.Draw(mask)
    for q in np.asarray(words, np.float64).reshape(-1, 4, 2):
        small = short_side(q) < MIN_TEXT
        s = None if small else shrink(q)
        if s is None:
            dm.polygon([tuple(p) for p in q], fill=0)
        else:
            dg.polygon([tuple(p) for p in s], fill=1)
    return np.asarray(gt, np.float32), np.asarray(mask, np.float32)


def make_batch(args: Tuple[int, int, int]):
    """One training batch from seed ``seed``: crops of scenes drawn from
    the pool of renders, with their targets."""
    from ctpn_tpu_torch.cli import train_craft_synth as craft

    seed, batch, size = args
    rng = np.random.RandomState(seed)
    ims, gts, masks = [], [], []
    for _ in range(batch):
        img, words = craft._POOL[rng.randint(len(craft._POOL))][:2]
        im, q = _crop(img, words, rng, size)
        g, m = db_targets(q, size, size)
        ims.append(im)
        gts.append(g.astype(np.uint8))
        masks.append(m.astype(np.uint8))
    return np.stack(ims), np.stack(gts), np.stack(masks)


def ohem_bce(logits, gt, mask, ratio: int = NEG_RATIO):
    """Binary cross-entropy of the map's ``logits`` (float32) over every
    positive pixel and the ``ratio`` times as many negative pixels of
    highest loss, over the batch, with no host sync (the negatives sorted,
    a rank mask keeps the worst)."""
    import torch

    loss = torch.nn.functional.binary_cross_entropy_with_logits(
        logits, gt, reduction="none").flatten()
    pos = (gt * mask).flatten() > 0.5
    neg = ((1 - gt) * mask).flatten() > 0.5
    n_pos = pos.sum()
    k = torch.minimum(neg.sum(), ratio * n_pos)
    worst = torch.sort(torch.where(neg, loss, -1.0), descending=True).values
    keep = torch.arange(worst.shape[0], device=worst.device) < k
    total = torch.where(pos, loss, 0.0).sum() + torch.where(keep, worst, 0.0).sum()
    return total / (n_pos + k).clamp(min=1)


def dice_loss(logits, gt, mask, eps: float = 1e-6):
    """1 - the dice coefficient of the map's probabilities and the targets
    over the cared-for pixels of the batch."""
    import torch

    p, g = torch.sigmoid(logits) * mask, gt * mask
    return 1 - 2 * (p * g).sum() / (p.sum() + g.sum() + eps)


def db_loss(logits, gt, mask):
    """The training loss: :func:`ohem_bce` plus :func:`dice_loss`."""
    return ohem_bce(logits, gt, mask) + dice_loss(logits, gt, mask)


# ---------------------------------------------------------------- model
def _train_modules():
    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    from torch.utils.checkpoint import checkpoint

    from ctpn_tpu_torch.models.dbnet import INNER
    from ctpn_tpu_torch.models.resnet import STAGE_WITH_DCN, STAGES, STEM_WIDTH
    from ctpn_tpu_torch.ops.deform_conv import deform_conv_ref

    def deform(x, om, w, stride):
        with torch.autocast(x.device.type, enabled=False):
            return deform_conv_ref(x.float(), om.float(), w.float(), stride)

    class DeformConv(nn.Module):
        """MhLiao's ModulatedDeformConv, no bias: ``weight`` only."""

        def __init__(self, cin, cout, stride):
            super().__init__()
            self.stride = stride
            self.sampling = True
            self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
            nn.init.kaiming_normal_(self.weight, mode="fan_out", nonlinearity="relu")

        def forward(self, x, offset_mask):
            if not self.sampling:  # no offset, every mask 0.5
                return 0.5 * F.conv2d(x, self.weight.to(x.dtype), stride=self.stride, padding=1)
            if not torch.is_grad_enabled():
                return deform(x, offset_mask, self.weight, self.stride)
            return checkpoint(deform, x, offset_mask, self.weight, self.stride,
                              use_reentrant=False)

    class Bottleneck(nn.Module):
        def __init__(self, cin, planes, stride, dcn):
            super().__init__()
            self.dcn = dcn
            self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(planes)
            if dcn:
                self.conv2_offset = nn.Conv2d(planes, 27, 3, stride=stride, padding=1)
                nn.init.zeros_(self.conv2_offset.weight)
                nn.init.zeros_(self.conv2_offset.bias)
                self.conv2 = DeformConv(planes, planes, stride)
            else:
                self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
            self.bn2 = nn.BatchNorm2d(planes)
            self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(planes * 4)
            self.downsample = None
            if stride != 1 or cin != planes * 4:
                self.downsample = nn.Sequential(
                    nn.Conv2d(cin, planes * 4, 1, stride=stride, bias=False),
                    nn.BatchNorm2d(planes * 4))

        def forward(self, x):
            out = F.relu(self.bn1(self.conv1(x)))
            if self.dcn:
                om = self.conv2_offset(out) if self.conv2.sampling else None
                out = self.conv2(out, om)
            else:
                out = self.conv2(out)
            out = self.bn3(self.conv3(F.relu(self.bn2(out))))
            return F.relu(out + (x if self.downsample is None else self.downsample(x)))

    class ResNet(nn.Module):
        def __init__(self, stages, dcn, stem=64):
            super().__init__()
            self.conv1 = nn.Conv2d(3, stem, 7, stride=2, padding=3, bias=False)
            self.bn1 = nn.BatchNorm2d(stem)
            cin = stem
            for i, ((n, planes), d) in enumerate(zip(stages, dcn), start=1):
                blocks = []
                for b in range(n):
                    blocks.append(Bottleneck(cin, planes, (1 if i == 1 else 2) if b == 0 else 1,
                                             d))
                    cin = planes * 4
                self.add_module(f"layer{i}", nn.Sequential(*blocks))
            for m in self.modules():
                if isinstance(m, nn.Conv2d) and not m.weight.is_meta:
                    if m.out_channels != 27:
                        nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")

        def forward(self, x):
            x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
            outs = []
            for i in range(1, 5):
                x = getattr(self, f"layer{i}")(x)
                outs.append(x)
            return outs

    class SegDetector(nn.Module):
        def __init__(self, channels, inner=256):
            super().__init__()
            q = inner // 4
            for k, c in zip((2, 3, 4, 5), channels):
                setattr(self, f"in{k}", nn.Conv2d(c, inner, 1, bias=False))
            self.out5 = nn.Sequential(nn.Conv2d(inner, q, 3, padding=1, bias=False),
                                      nn.Upsample(scale_factor=8, mode="nearest"))
            self.out4 = nn.Sequential(nn.Conv2d(inner, q, 3, padding=1, bias=False),
                                      nn.Upsample(scale_factor=4, mode="nearest"))
            self.out3 = nn.Sequential(nn.Conv2d(inner, q, 3, padding=1, bias=False),
                                      nn.Upsample(scale_factor=2, mode="nearest"))
            self.out2 = nn.Conv2d(inner, q, 3, padding=1, bias=False)
            self.binarize = nn.Sequential(
                nn.Conv2d(inner, q, 3, padding=1, bias=False), nn.BatchNorm2d(q),
                nn.ReLU(inplace=True), nn.ConvTranspose2d(q, q, 2, 2), nn.BatchNorm2d(q),
                nn.ReLU(inplace=True), nn.ConvTranspose2d(q, 1, 2, 2), nn.Sigmoid())
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    nn.init.kaiming_normal_(m.weight)
                    if m.bias is not None:
                        nn.init.constant_(m.bias, 1e-4)
                elif isinstance(m, nn.BatchNorm2d):
                    nn.init.constant_(m.weight, 1.0)
                    nn.init.constant_(m.bias, 1e-4)
            nn.init.constant_(self.binarize[6].bias, -2.0)  # a prior of about 0.12

        def logits(self, feats):
            """The map before the sigmoid, float32."""
            c2, c3, c4, c5 = feats
            in5, in4, in3, in2 = self.in5(c5), self.in4(c4), self.in3(c3), self.in2(c2)
            up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
            out4 = up(in5) + in4
            out3 = up(out4) + in3
            out2 = up(out3) + in2
            fuse = torch.cat([self.out5(in5), self.out4(out4), self.out3(out3),
                              self.out2(out2)], 1)
            return self.binarize[:-1](fuse)[:, 0].float()

        def forward(self, feats):
            return torch.sigmoid(self.logits(feats))

    class TrainDBNet(nn.Module):
        """DBNet in MhLiao/DB's module layout with live batch norms: images
        (N, 3, H, W) normalised -> (N, H, W) probabilities."""

        def __init__(self, stages=STAGES, dcn=STAGE_WITH_DCN, stem=STEM_WIDTH, inner=INNER):
            super().__init__()
            self.backbone = ResNet(stages, dcn, stem)
            self.decoder = SegDetector([p * 4 for _, p in stages], inner)

        def logits(self, x):
            return self.decoder.logits(self.backbone(x))

        def forward(self, x):
            return self.decoder(self.backbone(x))

    return TrainDBNet


def train_model(**kw):
    """A :class:`TrainDBNet` (MhLiao's layout) on the CPU, in train mode."""
    return _train_modules()(**kw)


def set_sampling(model, on: bool) -> None:
    """The deformable convs of a :class:`TrainDBNet` sample (``on``) or run
    as their zero-offset form, a plain conv at half gain."""
    for m in model.modules():
        if hasattr(m, "sampling"):
            m.sampling = on


def sampling_on(model) -> bool:
    return all(m.sampling for m in model.modules() if hasattr(m, "sampling"))


def normalised(x):
    """uint8 BGR (N, H, W, 3) -> DB's normalised float32 (N, 3, H, W)."""
    import torch

    mean = torch.tensor(PIXEL_MEANS, dtype=torch.float32, device=x.device)
    return ((x.float() - mean) / PIXEL_STD).permute(0, 3, 1, 2).contiguous()


def export(model, out: str) -> str:
    """The trained state dict folded into the port's parameters, the
    large kernels int8 with a scale per output channel, the rest float16."""
    from ctpn_tpu_torch.utils.weights import db_params_from_mhliao, quantized

    flat = quantized(db_params_from_mhliao(model.state_dict()))
    os.makedirs(osp.dirname(osp.abspath(out)), exist_ok=True)
    tmp = out + ".tmp.npz"
    np.savez_compressed(tmp, **flat)
    os.replace(tmp, out)
    return out


def train(args: argparse.Namespace) -> dict:
    import torch

    t0 = time.perf_counter()
    rng = np.random.RandomState(args.seed)
    with mp.get_context("spawn").Pool(args.workers) as pool:
        scenes = pool.map(_render, rng.randint(0, HOLDOUT_BASE, args.scenes).tolist(),
                          chunksize=8)
    print(json.dumps({"scenes": len(scenes), "s": round(time.perf_counter() - t0, 1)}),
          flush=True)
    crops = mp.get_context("fork").Pool(args.workers, initializer=_keep_pool,
                                        initargs=(scenes,))
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = True
    torch.manual_seed(args.seed)
    model = train_model().to(dev, memory_format=torch.channels_last).train()
    set_sampling(model, args.sample_from <= 0)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    seeds = [(args.seed * 10**6 + i, args.batch, args.crop) for i in range(args.steps)]
    log = []
    t_train = time.perf_counter()
    wait = 0.0
    with crops:
        ahead = deque(crops.apply_async(make_batch, (a,)) for a in seeds[:2 * args.workers])
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
            if done >= args.sample_from and not sampling_on(model):
                set_sampling(model, True)
                print(json.dumps({"sampling_from_step": step}), flush=True)
            x, gt, mask = (torch.from_numpy(np.ascontiguousarray(b)).to(dev, non_blocking=True)
                           for b in batch)
            gt, mask = gt.float(), mask.float()
            with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=dev.type == "cuda"):
                logits = model.logits(normalised(x).contiguous(memory_format=torch.channels_last))
            loss = db_loss(logits.float(), gt, mask)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            last = step == args.steps - 1 or done >= 1.0
            if step % 100 == 0 or step in (10, 30) or last:
                row = {"step": step, "loss": float(loss.detach()),
                       "s": round(time.perf_counter() - t0, 1), "data_wait_s": round(wait, 1)}
                log.append(row)
                print(json.dumps(row), flush=True)
            if args.save_every and step and step % args.save_every == 0:
                export(model.eval(), args.out)
                model.train()
            if last:
                break
    model.eval()
    export(model, args.out)
    return {"steps": step + 1, "batch": args.batch, "crop": args.crop, "lr": args.lr,
            "scenes": args.scenes, "sample_from": args.sample_from,
            "train_s": round(time.perf_counter() - t0, 1),
            "final": log[-1], "artifact": args.out, "sha256": _sha256(args.out)}


def db_cfg() -> None:
    from ctpn_tpu_torch.config import cfg_from_list, reset_cfg

    reset_cfg()
    cfg_from_list(["NET_NAME", "DB_RESNET50_DCN", "TPU.BUCKETS", [[736, 1312]],
                   "CHANNEL_ORDER", "BGR", "PIXEL_MEANS", list(PIXEL_MEANS),
                   "PIXEL_STDS", [PIXEL_STD] * 3])


def score(artifact: str, n: int, device: str) -> dict:
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.utils.weights import load_params

    db_cfg()
    pred = CTPNPredictor(load_params(artifact, device=device), device=device)
    hit = ndet = ngt = 0
    words_n = boxes_n = 0
    for im, words in holdout(n):
        q = words.reshape(-1, 4, 2)
        care = np.array([short_side(w) >= MIN_TEXT for w in q], bool)
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
    if not args.no_score:
        print(json.dumps({"eval": score(args.out, args.holdout, args.device)}), flush=True)


if __name__ == "__main__":
    main()
