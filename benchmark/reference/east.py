"""EAST-VGG16 (RBOX) in plain PyTorch and NumPy: the reference that the
port's EAST is held against.

Imports torch and numpy only, nothing of ``ctpn_tpu_torch`` and nothing of
JAX. :class:`ReferenceEAST` runs the float32 network (TF32 off) on padded
uint8 BGR images and the post-process in NumPy float32, and reports the
IoU tests that its walk and its NMS make (the rooflines' work).

The network (Zhou et al., CVPR 2017, section 3.2, Fig. 3, the VGG16
variant): VGG16 conv1-conv5 with a 2x2/2 max-pool after every block; the
pool2-pool5 outputs merged by three stages of (2x bilinear unpool to the
skip's size, concat, 1x1 conv, 3x3 conv) of 128, 64 and 32 channels, each
conv with its ReLU; a 3x3 conv of 32; 1x1 heads: score ``sigmoid``, four
distances (top, right, bottom, left) ``sigmoid * 512``, angle ``(sigmoid
- 0.5) * pi / 2``, at stride 4. Weights: the port's ``.npz`` format (flat
``a/b/c`` keys, conv kernels HWIO, dense kernels (in, out)).

The post-process (argman/EAST ``eval.py::detect`` and ``lanms/``):

1. the cells whose score is over ``SCORE_MAP_THRESH`` (0.8), inside the
   image's resized extent, in raster order (y, then x);
2. each cell's rectangle restored from the point (4x, 4y): TL, TR, BR, BL
   at the distances from the point, turned by the angle;
3. locality-aware NMS (the paper's Algorithm 1): the cells in order, each
   folded into the quad merged before it when their IoU is over
   ``NMS_THRESH`` (0.2), the vertices averaged weighted by score and the
   scores summed;
4. standard greedy NMS at ``NMS_THRESH`` over the merged quads sorted by
   score sum (stable), suppressing where the IoU is over the threshold; a
   record's score is its quad's score sum over the cells it folds.

Departures from argman/EAST, all of the port as well:

* the unpool samples with half-pixel centres (PyTorch ``align_corners=
  False``); TF1's ``resize_bilinear`` samples without the half-pixel offset;
* no batch norm (the paper's figure has none; argman's would fold into
  the conv biases at inference);
* the trunk is CTPN's: its pixel means and BGR order, and images resized
  and padded to a bucket as the port's CTPN does;
* the polygon IoU is float32 Sutherland-Hodgman clipping of one convex
  quad by the other (the cell by the merged quad in the walk, the higher
  scored by the lower in NMS); lanms clips with Clipper on coordinates
  scaled to integers;
* the walk folds vertices in their order: the restore always emits TL, TR,
  BR, BL, where lanms first turns a quad's vertices to meet the first
  quad's; the merged quads are sorted with a stable sort (lanms:
  ``std::sort``);
* argman's ``box_thresh`` filter (the mean score inside each box) is not
  in the paper and is left out;
* the RBOX angle's sign: positive turns the text from +x towards +y;
  argman's restore turns the other way; the rectangle is the same.

``quant="fp8"`` is the benchmark's control: the convs' inputs and weights
rounded to float8 e4m3 (one scale per tensor) before a float32 product,
one step below the port's bfloat16.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0
MAXV = 16
STRIDE = 4


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def load_weights(weights: Union[str, Dict[str, np.ndarray]], device) -> Dict[str, torch.Tensor]:
    """An ``.npz`` path or a flat dict -> float32 tensors on ``device``:
    conv kernels OIHW, dense kernels (out, in). An ``.npz`` that names a
    trunk artifact beside it (``__trunk__``, ``__trunk_sha256__``) gets
    that artifact's ``VGG16Trunk_0`` leaves, checked against the digest."""
    if isinstance(weights, str):
        with np.load(weights) as z:
            flat = {k: z[k] for k in z.files}
        if "__trunk__" in flat:
            path = os.path.join(os.path.dirname(os.path.abspath(weights)),
                                str(flat.pop("__trunk__")))
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            if digest != str(flat.pop("__trunk_sha256__")):
                raise ValueError(f"{path}: sha256 {digest} is not the one {weights} names")
            with np.load(path) as z:
                flat.update({k: z[k] for k in z.files if k.startswith("VGG16Trunk_0/")})
        weights = flat
    out = {}
    for key, v in weights.items():
        t = torch.as_tensor(np.asarray(v, np.float32))
        if key.endswith("kernel") and t.ndim == 4:
            t = t.permute(3, 2, 0, 1)
        elif key.endswith("kernel") and t.ndim == 2:
            t = t.t()
        out[key] = t.contiguous().to(device)
    return out


# ------------------------------------------------------------- geometry
def restore_rbox(ox, oy, geo, angle) -> np.ndarray:
    """(n, 8) float32 quads TL, TR, BR, BL of the cells at (ox, oy)."""
    c, s = np.cos(angle), np.sin(angle)
    t, r, b, l = geo[:, 0], geo[:, 1], geo[:, 2], geo[:, 3]
    return np.stack([ox - l * c + t * s, oy - l * s - t * c,
                     ox + r * c + t * s, oy + r * s - t * c,
                     ox + r * c - b * s, oy + r * s + b * c,
                     ox - l * c - b * s, oy - l * s + b * c], -1).astype(np.float32)


def _signed2(xs: np.ndarray, ys: np.ndarray, n) -> np.ndarray:
    acc = np.zeros(xs.shape[:-1], np.float32)
    n = np.broadcast_to(np.asarray(n), xs.shape[:-1])
    for i in range(xs.shape[-1]):
        j = np.where(n > i + 1, i + 1, 0)
        xj = np.take_along_axis(xs, j[..., None], -1)[..., 0]
        yj = np.take_along_axis(ys, j[..., None], -1)[..., 0]
        term = xs[..., i] * yj - xj * ys[..., i]
        acc = np.where(n > i, acc + term, acc).astype(np.float32)
    return acc


def _area(xs, ys, n) -> np.ndarray:
    return (np.abs(_signed2(xs, ys, n)) * np.float32(0.5)).astype(np.float32)


def quad_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of quads (..., 8) float32, ``a`` clipped by ``b`` (convex)."""
    a, b = np.broadcast_arrays(np.asarray(a, np.float32), np.asarray(b, np.float32))
    lead = a.shape[:-1]
    ax, ay, bx, by = a[..., 0::2], a[..., 1::2], b[..., 0::2], b[..., 1::2]
    flip = _signed2(bx, by, 4) < 0
    sx = np.zeros((*lead, MAXV), np.float32)
    sy = np.zeros((*lead, MAXV), np.float32)
    sx[..., :4], sy[..., :4] = ax, ay
    n = np.full(lead, 4, np.int64)
    idx = np.arange(MAXV)
    with np.errstate(divide="ignore", invalid="ignore"):
        for e in range(4):
            x0, y0 = bx[..., e, None], by[..., e, None]
            ex, ey = bx[..., (e + 1) % 4, None] - x0, by[..., (e + 1) % 4, None] - y0
            c = ex * (sy - y0) - ey * (sx - x0)
            c = np.where(flip[..., None], -c, c)
            prev = np.maximum(np.where(idx == 0, n[..., None] - 1, idx - 1), 0)
            cp = np.take_along_axis(c, prev, -1)
            px, py = np.take_along_axis(sx, prev, -1), np.take_along_axis(sy, prev, -1)
            cin, pin, live = c >= 0, cp >= 0, idx < n[..., None]
            t = cp / (cp - c)
            ix, iy = px + t * (sx - px), py + t * (sy - py)
            flags = np.stack([live & (cin != pin), live & cin], -1).reshape(*lead, 2 * MAXV)
            cx = np.stack([ix, sx], -1).reshape(*lead, 2 * MAXV)
            cy = np.stack([iy, sy], -1).reshape(*lead, 2 * MAXV)
            pos = np.cumsum(flags, -1) - 1
            dest = np.where(flags & (pos < MAXV), pos, MAXV)
            ox = np.zeros((*lead, MAXV + 1), np.float32)
            oy = np.zeros((*lead, MAXV + 1), np.float32)
            np.put_along_axis(ox, np.where(flags, dest, MAXV), cx, -1)
            np.put_along_axis(oy, np.where(flags, dest, MAXV), cy, -1)
            sx, sy = ox[..., :MAXV], oy[..., :MAXV]
            n = np.minimum(flags.sum(-1), MAXV)
        inter = _area(sx, sy, n)
        union = (_area(ax, ay, 4) + _area(bx, by, 4) - inter).astype(np.float32)
        return np.where(union > 0, inter / np.where(union > 0, union, 1), 0).astype(np.float32)


def lanms_walk(cells: Sequence[np.ndarray], thresh: float):
    """The walk over each image's cells (n, 9) ``[score, quad]``, every
    image stepped at once. Per image: (merged (k, 9) ``[score sum,
    quad]``, cells folded (k,), IoU tests)."""
    t32 = np.float32(thresh)
    counts = [len(c) for c in cells]
    out = [([], []) for _ in cells]
    live_imgs = [i for i, n in enumerate(counts) if n]
    if live_imgs:
        score = np.array([cells[i][0, 0] for i in live_imgs], np.float32)
        quad = np.stack([cells[i][0, 1:] for i in live_imgs]).astype(np.float32)
        cnt = np.ones(len(live_imgs), np.int64)
        for step in range(1, max(counts)):
            rows = [k for k, i in enumerate(live_imgs) if counts[i] > step]
            if not rows:
                break
            r = np.array(rows)
            cell = np.stack([cells[live_imgs[k]][step] for k in rows]).astype(np.float32)
            s, q = cell[:, 0], cell[:, 1:]
            fold = quad_iou(q, quad[r]) > t32
            for k, f in zip(rows, fold):
                if not f:
                    out[live_imgs[k]][0].append(np.concatenate([[score[k]], quad[k]]))
                    out[live_imgs[k]][1].append(cnt[k])
            total = (score[r] + s).astype(np.float32)
            folded = ((quad[r] * score[r][:, None] + q * s[:, None]) / total[:, None])
            quad[r] = np.where(fold[:, None], folded, q)
            score[r] = np.where(fold, total, s)
            cnt[r] = np.where(fold, cnt[r] + 1, 1)
        for k, i in enumerate(live_imgs):
            out[i][0].append(np.concatenate([[score[k]], quad[k]]))
            out[i][1].append(cnt[k])
    res = []
    for (m, n), c in zip(out, counts):
        res.append((np.array(m, np.float32).reshape(-1, 9), np.array(n, np.int64),
                    max(c - 1, 0)))
    return res


def greedy_nms(quads: np.ndarray, thresh: float):
    """Greedy NMS over quads (k, 8) in their order (sorted by score): the
    kept indices and the IoU tests made."""
    t32 = np.float32(thresh)
    order = list(range(len(quads)))
    keep, tests = [], 0
    while order:
        cur, rest = order[0], np.array(order[1:], np.int64)
        keep.append(cur)
        if len(rest) == 0:
            break
        tests += len(rest)
        iou = quad_iou(np.broadcast_to(quads[cur], (len(rest), 8)), quads[rest])
        order = rest[~(iou > t32)].tolist()
    return np.array(keep, np.int64), tests


# -------------------------------------------------------------- network
class ReferenceEAST:
    """The detector of ``config`` (``model``: ``vgg_stages``,
    ``merge_widths``, ``out_width``, ``text_scale``; ``pixel_means``;
    ``TEXT``: ``SCORE_MAP_THRESH``, ``NMS_THRESH``) with ``weights`` (an
    ``.npz`` path or a flat dict) on ``device``."""

    def __init__(self, config: dict, weights, device="cpu", quant: Optional[str] = None,
                 block: int = 8):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown precision {quant!r}")
        self.config = config
        self.device = torch.device(device)
        self.quant = quant
        self.block = block
        self.w = load_weights(weights, self.device)
        self.means = torch.tensor(config["pixel_means"], dtype=torch.float32)

    def _q(self, x):
        return fp8_round(x) if self.quant == "fp8" else x

    def _conv(self, x, name, pad):
        w, b = self.w[f"{name}/kernel"], self.w[f"{name}/bias"]
        return F.relu(F.conv2d(self._q(x), self._q(w), b, padding=pad))

    def forward(self, images: torch.Tensor):
        """(N, H, W, 3) uint8 -> (score (N, h, w), geo (N, h, w, 4), angle)."""
        m = self.config["model"]
        x = (images.float() - self.means.to(images.device)).permute(0, 3, 1, 2).contiguous()
        taps = []
        for block, reps, _ in m["vgg_stages"]:
            for rep in range(1, reps + 1):
                x = self._conv(x, f"VGG16Trunk_0/conv{block}_{rep}", 1)
            x = F.max_pool2d(x, 2, 2)
            if block >= 2:
                taps.append(x)
        h = taps[-1]
        for k, skip in enumerate(taps[-2::-1], start=2):
            g = F.interpolate(h, size=skip.shape[-2:], mode="bilinear", align_corners=False)
            h = self._conv(torch.cat([g, skip], 1), f"merge{k}_1x1", 0)
            h = self._conv(h, f"merge{k}_3x3", 1)
        h = self._conv(h, "out_conv", 1).permute(0, 2, 3, 1)
        y = h @ self.w["heads/kernel"].t() + self.w["heads/bias"]
        return (torch.sigmoid(y[..., 0]), torch.sigmoid(y[..., 1:5]) * float(m["text_scale"]),
                (torch.sigmoid(y[..., 5]) - 0.5) * (math.pi / 2))

    def maps(self, images: np.ndarray) -> List[tuple]:
        """Per padded image (score, geo, angle) as float32 numpy."""
        out = []
        with torch.inference_mode(), no_tf32():
            for lo in range(0, len(images), self.block):
                x = torch.as_tensor(np.ascontiguousarray(images[lo:lo + self.block]))
                s, g, a = self.forward(x.to(self.device))
                out += list(zip(s.cpu().numpy(), g.cpu().numpy(), a.cpu().numpy()))
        return out

    def cells(self, score, geo, angle, info) -> np.ndarray:
        """(n, 9) ``[score, quad]`` of the cells over the threshold inside
        the image, in raster order."""
        h, w = score.shape
        ys, xs = np.mgrid[0:h, 0:w]
        oy, ox = (ys * STRIDE).astype(np.float32), (xs * STRIDE).astype(np.float32)
        hit = ((score > np.float32(self.config["TEXT"]["SCORE_MAP_THRESH"]))
               & (oy < np.float32(info[0])) & (ox < np.float32(info[1])))
        quads = restore_rbox(ox[hit], oy[hit], geo[hit], angle[hit])
        return np.concatenate([score[hit][:, None], quads], 1).astype(np.float32)

    def detect(self, images: np.ndarray, infos: np.ndarray) -> List[Dict[str, np.ndarray]]:
        """Per padded image: ``merged`` (k, 9) ``[score sum, quad]`` sorted
        by score sum, ``recs`` (l, 9) ``[quad, score]`` in the bucket's
        pixels, ``cells`` over the threshold, and the IoU tests of the walk
        (``walk_tests``) and of the NMS (``nms_tests``)."""
        t = self.config["TEXT"]["NMS_THRESH"]
        cells = [self.cells(s, g, a, info) for (s, g, a), info in zip(self.maps(images), infos)]
        res = []
        for c, (merged, ncells, walk_tests) in zip(cells, lanms_walk(cells, t)):
            order = np.argsort(-merged[:, 0], kind="stable")
            merged, ncells = merged[order], ncells[order]
            keep, nms_tests = greedy_nms(merged[:, 1:], t)
            recs = np.concatenate(
                [merged[keep, 1:], (merged[keep, 0] / np.maximum(ncells[keep], 1).astype(np.float32))[:, None]], 1)
            res.append({"merged": merged, "recs": recs.astype(np.float32), "cells": len(c),
                        "walk_tests": walk_tests, "nms_tests": nms_tests})
        return res
