"""DBNet-ResNet50-DCN in plain PyTorch and NumPy: the reference that the
port's DBNet is held against.

Imports torch, numpy and PIL only, nothing of ``ctpn_tpu_torch`` and
nothing of JAX. :class:`ReferenceDB` runs the float32 network (TF32 off)
on padded uint8 BGR images, with its batch norms unfolded (eval-mode
``F.batch_norm``) where the weights carry them, and DB's
``boxes_from_bitmap`` in NumPy with its own labelling, hull, calipers,
fill and unclip.

The network (Liao et al., AAAI 2020; MhLiao/DB ``backbones/resnet.py::
deformable_resnet50``, ``decoders/seg_detector.py::SegDetector``): a
7x7/2 conv to 64, BN, ReLU, a 3x3/2 max-pool (padding 1); bottleneck
stages of (blocks, planes) (3, 64), (4, 128), (6, 256), (3, 512), ``out =
relu(bn3(conv3(relu(bn2(conv2(relu(bn1(conv1(x)))))))) + identity)``, the
stride on conv2, the identity a strided 1x1 conv and BN in each stage's
first block; conv2 of stages 2-4 a modulated deformable conv whose offsets
and masks a 3x3 conv (``conv2_offset``, 27 channels, with a bias) gives:
for tap ``k = 3 i + j`` the sample at ``(y s - 1 + i + om[2k], x s - 1 + j
+ om[2k + 1])``, bilinear, a corner outside the map reading 0 and a point
at or beyond -1 and H (W) reading 0, times ``sigmoid(om[18 + k])``, then
the product with the weights (here gathered and multiplied with
``torch.matmul``). The neck: 1x1 convs to 256, the top-down sums with
nearest x2 upsamples, 3x3 convs to 64 upsampled (nearest) to stride 4 and
concatenated; the head: 3x3 conv to 64, BN, ReLU, a 2x2/2 transposed conv,
BN, ReLU, a 2x2/2 transposed conv to one channel, the sigmoid: the
probability map at stride 1.

Weights: the port's ``.npz`` format (flat ``a/b/c`` keys, conv kernels
HWIO, a transposed conv's stored (kh, kw, out, in), batch norms folded,
large kernels int8 with a float32 scale per output channel), or a
MhLiao/DB state dict (``model.``, ``module.`` prefixes stripped), whose
batch norms run as they are.

The post-process (``seg_detector_representer.py::boxes_from_bitmap``,
the representer's defaults: thresh 0.3, box_thresh 0.7, max_candidates
100, unclip_ratio 1.5, min_size 3), on each image's map inside its
resized extent:

1. on: probability > thresh;
2. 8-connected components in raster order of their first pixel (the first
   ``max_candidates``, the configuration's ``TPU.DB_MAX_BOXES``; the rest
   counted);
3. the minimum-area rectangle of each component's pixels: their convex
   hull, the rectangle of least area over the hull's edges (areas times
   ``|e|^2`` compared exactly in integers, the first on ties); dropped
   where its shorter side is under min_size;
4. ``get_mini_boxes``' corner order (sorted by x; the upper, then the
   lower, of each side's pair);
5. the score: the mean probability over the pixels of the corners'
   clipped bounding box inside or on the quad of the corners less the
   box's corner, truncated to integers; dropped under box_thresh;
6. the unclip: each side pushed out by ``area * unclip_ratio /
   perimeter``; dropped where the grown rectangle's shorter side is under
   min_size + 2;
7. the corners ``round(v / size * original size)``, clipped to the
   original image: a record ``[x1, y1, ..., x4, y4, score]``.

Departures from MhLiao's code, all of the port as well: components in
place of ``cv2.findContours``' contours (the outer border's hull is the
pixels'; hole borders, whose boxes score under the threshold, are left
out; components are taken in raster order); the fill rule above in place
of ``cv2.fillPoly``'s; the exact offset in place of pyclipper's integer
one; the images are resized bilinearly by PIL and padded into a bucket.

``quant="fp8"`` is the benchmark's control: the convs' inputs and weights
(the deformable products' too) rounded to float8 e4m3 (one scale per
tensor) before a float32 product, one step below the port's bfloat16.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

FP8_MAX = 448.0
BN_EPS = 1e-5
STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))
DCN = (False, True, True, True)
LANES = 128


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


def conv_names(stages=STAGES, dcn=DCN):
    """(reference name, MhLiao conv, MhLiao batch norm or None) of every conv."""
    out = [("conv1", "backbone.conv1", "backbone.bn1")]
    for s, ((n, _), d) in enumerate(zip(stages, dcn), start=1):
        for b in range(n):
            at, mh = f"layer{s}/{b}", f"backbone.layer{s}.{b}"
            out += [(f"{at}/conv1", f"{mh}.conv1", f"{mh}.bn1"),
                    (f"{at}/conv2", f"{mh}.conv2", f"{mh}.bn2"),
                    (f"{at}/conv3", f"{mh}.conv3", f"{mh}.bn3")]
            if d:
                out.append((f"{at}/conv2_offset", f"{mh}.conv2_offset", None))
            if b == 0:
                out.append((f"{at}/downsample", f"{mh}.downsample.0", f"{mh}.downsample.1"))
    for k in (2, 3, 4, 5):
        out += [(f"in{k}", f"decoder.in{k}", None),
                (f"out{k}", f"decoder.out{k}" + ("" if k == 2 else ".0"), None)]
    return out + [("bin_conv", "decoder.binarize.0", "decoder.binarize.1"),
                  ("bin_up1", "decoder.binarize.3", "decoder.binarize.4"),
                  ("bin_up2", "decoder.binarize.6", None)]


PORT_KEY = {"in": "decoder/in", "out": "decoder/out", "bin": "decoder/bin"}


def _port_key(name: str) -> str:
    for head, full in PORT_KEY.items():
        if name.startswith(head):
            return full + name[len(head):]
    return "backbone/" + name


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    """The leaves of an ``.npz``: an int8 leaf times its float32
    ``<key>__scale`` per output channel (a float32 product)."""
    with np.load(path) as z:
        raw = {k: z[k] for k in z.files}
    flat = {}
    for k, v in raw.items():
        if k.endswith("__scale"):
            continue
        if v.dtype == np.int8:
            v = v.astype(np.float32) * raw[k + "__scale"].astype(np.float32)
        flat[k] = v
    return flat


def load_weights(weights: Union[str, Dict], device) -> Dict[str, dict]:
    """Per conv name: ``{"w": (O, I, kh, kw) (a transposed conv's (I, O,
    kh, kw)), "b": (O,) or None, "bn": (gamma, beta, mean, var) or
    None}`` float32 on ``device``, from an ``.npz`` path or flat dict in
    the port's format, or from a MhLiao/DB state dict."""
    flat = _read_npz(weights) if isinstance(weights, str) else dict(weights)

    def strip(k):
        while k.startswith(("model.", "module.")):
            k = k.split(".", 1)[1]
        return k

    flat = {strip(k): v for k, v in flat.items()}

    def t(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return torch.as_tensor(np.asarray(v, np.float32)).to(device)

    out = {}
    mhliao = any(k.startswith("backbone.") for k in flat)
    for name, conv, bn in conv_names():
        if mhliao:
            entry = {"w": t(flat[f"{conv}.weight"]),
                     "b": t(flat[f"{conv}.bias"]) if f"{conv}.bias" in flat else None,
                     "bn": None}
            if bn is not None:
                entry["bn"] = tuple(t(flat[f"{bn}.{k}"]) for k in
                                    ("weight", "bias", "running_mean", "running_var"))
        else:
            key = _port_key(name)
            bias = flat.get(f"{key}/bias")
            entry = {"w": t(flat[f"{key}/kernel"]).permute(3, 2, 0, 1).contiguous(),
                     "b": None if bias is None else t(bias), "bn": None}
        out[name] = entry
    return out


# ---------------------------------------------------------------- input
def resize_size(h: int, w: int, short_side: int,
                buckets: Sequence[Sequence[int]]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """DB's ``resize_image``: the short side to ``short_side``, the other
    to ``ceil(short_side / short * long / 32) * 32``, in the smallest bucket
    that holds it; where none does, the short side less 32 at a time."""
    s = int(short_side)
    while True:
        if h < w:
            nh, nw = s, int(math.ceil(s / h * w / 32) * 32)
        else:
            nh, nw = int(math.ceil(s / w * h / 32) * 32), s
        fits = [(bh * bw, bh, bw) for bh, bw in buckets if bh >= nh and bw >= nw]
        _, bh, bw = min(fits) if fits else max((bh * bw, bh, bw) for bh, bw in buckets)
        if (nh <= bh and nw <= bw) or s <= 32:
            return (min(nh, bh), min(nw, bw)), (bh, bw)
        s -= 32


def prep(im_bgr: np.ndarray, config: dict) -> Tuple[np.ndarray, np.ndarray]:
    """One uint8 BGR image -> (padded uint8 image, im_info [resized h,
    resized w, original h, original w]): DB's resize (PIL bilinear; the same
    size copies), zero padding at the bottom and right."""
    h, w = im_bgr.shape[:2]
    (rh, rw), (bh, bw) = resize_size(h, w, config["TEXT"]["DB_SHORT_SIDE"], config["buckets"])
    if (rh, rw) != (h, w):
        im_bgr = np.asarray(Image.fromarray(im_bgr).resize((rw, rh), Image.BILINEAR))
    out = np.zeros((bh, bw, 3), np.uint8)
    out[:rh, :rw] = im_bgr
    return out, np.array([rh, rw, h, w], np.float32)


# ------------------------------------------------------------ post-process
def label8(on: np.ndarray) -> np.ndarray:
    """(H, W) bool -> int64 labels 1.. of the 8-connected components in
    raster order of their first pixel, 0 off (runs joined to the runs of
    the row above that they touch, diagonals included; union-find)."""
    h, w = on.shape
    parent: List[int] = []

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    runs, prev = [], []
    for y in range(h):
        d = np.diff(np.concatenate([[0], on[y].astype(np.int8), [0]]))
        cur = []
        for x0, x1 in zip(np.flatnonzero(d == 1).tolist(), np.flatnonzero(d == -1).tolist()):
            rid = len(parent)
            parent.append(rid)
            for px0, px1, prid in prev:  # [px0, px1) touches [x0 - 1, x1 + 1)
                if px0 < x1 + 1 and px1 > x0 - 1:
                    a, b = find(rid), find(prid)
                    parent[max(a, b)] = min(a, b)
            cur.append((x0, x1, rid))
            runs.append((y, x0, x1, rid))
        prev = cur
    labels = np.zeros((h, w), np.int64)
    names: Dict[int, int] = {}
    for y, x0, x1, rid in runs:
        root = find(rid)
        if root not in names:
            names[root] = len(names) + 1
        labels[y, x0:x1] = names[root]
    return labels


def convex_hull(points: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Andrew's monotone chain over points sorted by (y, x), collinear
    points dropped."""
    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    if len(points) <= 1:
        return list(points)
    lower: List[Tuple[int, int]] = []
    for p in points:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: List[Tuple[int, int]] = []
    for p in reversed(points):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return lower[:-1] + upper[:-1]


def min_area_rect(hull: List[Tuple[int, int]]):
    """(corners (4, 2) float32, shorter side) of the least-area rectangle
    over the hull's edges."""
    best = None
    for i in range(len(hull)):
        (x0, y0), (x1, y1) = hull[i], hull[(i + 1) % len(hull)]
        ex, ey = x1 - x0, y1 - y0
        u = [ex * x + ey * y for x, y in hull]
        v = [ex * y - ey * x for x, y in hull]
        area, n2 = (max(u) - min(u)) * (max(v) - min(v)), ex * ex + ey * ey
        if best is None or area * best[1] < best[0] * n2:
            best = (area, n2, ex, ey, min(u), max(u), min(v), max(v))
    _, n2, ex, ey, u0, u1, v0, v1 = best
    pts = [((a * ex - b * ey) / n2, (a * ey + b * ex) / n2)
           for a, b in ((u0, v0), (u1, v0), (u1, v1), (u0, v1))]
    root = math.sqrt(n2)
    return np.array(pts, np.float64).astype(np.float32), min(u1 - u0, v1 - v0) / root


def mini_boxes(pts: np.ndarray) -> np.ndarray:
    """``get_mini_boxes``' order of four corners."""
    p = sorted(list(pts), key=lambda q: q[0])
    i1, i4 = (0, 1) if p[1][1] > p[0][1] else (1, 0)
    i2, i3 = (2, 3) if p[3][1] > p[2][1] else (3, 2)
    return np.array([p[i1], p[i2], p[i3], p[i4]], np.float32)


def box_score(prob: np.ndarray, box: np.ndarray) -> float:
    h, w = prob.shape
    xmin = int(np.clip(np.floor(box[:, 0].min()), 0, w - 1))
    xmax = int(np.clip(np.ceil(box[:, 0].max()), 0, w - 1))
    ymin = int(np.clip(np.floor(box[:, 1].min()), 0, h - 1))
    ymax = int(np.clip(np.ceil(box[:, 1].max()), 0, h - 1))
    q = (box - np.array([xmin, ymin], np.float32)).astype(np.int32).astype(np.int64)
    ys, xs = np.mgrid[0:ymax - ymin + 1, 0:xmax - xmin + 1]
    cr = np.stack([(q[(c + 1) % 4, 0] - q[c, 0]) * (ys - q[c, 1])
                   - (q[(c + 1) % 4, 1] - q[c, 1]) * (xs - q[c, 0]) for c in range(4)])
    inside = ~((cr < 0).any(0) & (cr > 0).any(0))
    n = int(inside.sum())
    if n == 0:
        return 0.0
    return float(prob[ymin:ymax + 1, xmin:xmax + 1].astype(np.float64)[inside].sum() / n)


def unclip(box: np.ndarray, ratio: float) -> Tuple[np.ndarray, float]:
    """The rectangle grown by area * ratio / perimeter on every side, and
    its shorter side."""
    b = box.astype(np.float64)
    e = np.roll(b, -1, 0) - b
    area = abs(float(np.sum(b[:, 0] * np.roll(b[:, 1], -1) - np.roll(b[:, 0], -1) * b[:, 1]))) / 2
    length = np.linalg.norm(e, axis=1)
    d = area * ratio / length.sum()
    out = b + d * (b - np.roll(b, -1, 0)) / length[:, None] \
        + d * (b - np.roll(b, 1, 0)) / np.roll(length, 1)[:, None]
    side = min(np.linalg.norm(out[1] - out[0]), np.linalg.norm(out[3] - out[0]))
    return out, float(side)


def boxes_from_bitmap(prob: np.ndarray, dest: Tuple[int, int], text: dict):
    """DB's post-process on one image's (h, w) map inside its extent: the
    records (n, 9) in the original image's pixels, and the counts."""
    thresh, box_thresh = text["DB_THRESH"], text["DB_BOX_THRESH"]
    ratio, min_size = text["DB_UNCLIP_RATIO"], text["DB_MIN_SIZE"]
    cap = text["max_candidates"]
    h, w = prob.shape
    dh, dw = (np.float32(v) for v in dest)
    on = prob > np.float32(thresh)
    labels = label8(on)
    n = int(labels.max())
    flat = labels.ravel()
    order = np.argsort(flat, kind="stable")
    bounds = np.searchsorted(flat[order], np.arange(n + 2))
    recs, box_px = [], 0
    for k in range(1, min(n, cap) + 1):
        idx = order[bounds[k]:bounds[k + 1]]
        ys, xs = idx // w, idx % w
        box_px += int((xs.max() - xs.min() + 1) * (ys.max() - ys.min() + 1))
        hull = convex_hull(sorted(zip(xs.tolist(), ys.tolist()), key=lambda p: (p[1], p[0])))
        if len(hull) <= 1:
            continue
        rect, side = min_area_rect(hull)
        if side < min_size:
            continue
        box = mini_boxes(rect)
        score = box_score(prob, box)
        if score < box_thresh:
            continue
        grown, side = unclip(box, ratio)
        if side < min_size + 2:
            continue
        box = mini_boxes(grown.astype(np.float32))
        rec = np.zeros(9, np.float32)
        rec[0:8:2] = np.clip(np.rint(box[:, 0] / np.float32(w) * dw), 0, dw)
        rec[1:8:2] = np.clip(np.rint(box[:, 1] / np.float32(h) * dh), 0, dh)
        rec[8] = score
        recs.append(rec)
    counts = {"on": int(on.sum()), "labelled": n, "taken": min(n, cap),
              "overflow": max(n - cap, 0), "kept": len(recs), "box_pixels": box_px}
    return np.array(recs, np.float32).reshape(-1, 9), counts


# -------------------------------------------------------------- network
class ReferenceDB:
    """The detector of ``config`` (``pixel_means``, ``pixel_stds``,
    ``channel_order``; ``TEXT``: the representer's constants, and
    ``program``'s ``TPU.DB_MAX_BOXES``) with ``weights`` (an ``.npz`` path,
    a flat dict in the port's format, or a MhLiao state dict) on
    ``device``."""

    def __init__(self, config: dict, weights, device="cpu", quant: Optional[str] = None,
                 block: int = 2):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown precision {quant!r}")
        self.config = config
        self.device = torch.device(device)
        self.quant = quant
        self.block = block
        self.w = load_weights(weights, self.device)
        self.means = torch.tensor(config["pixel_means"], dtype=torch.float32)
        self.stds = torch.tensor(config.get("pixel_stds", [1.0, 1.0, 1.0]), dtype=torch.float32)

    def _q(self, x):
        return fp8_round(x) if self.quant == "fp8" else x

    def _bn(self, y, name):
        bn = self.w[name]["bn"]
        if bn is not None:
            g, b, m, v = bn
            y = F.batch_norm(y, m, v, g, b, training=False, eps=BN_EPS)
        return y

    def _conv(self, x, name, stride=1, relu=True):
        p = self.w[name]
        k = p["w"].shape[-1]
        y = F.conv2d(self._q(x), self._q(p["w"]), p["b"], stride=stride, padding=k // 2)
        y = self._bn(y, name)
        return F.relu(y) if relu else y

    def _deform(self, x, name, stride):
        """Bottleneck conv2 of a deformable stage: its offsets and masks,
        the samples gathered, the product with the weights."""
        om = self._conv(x, name + "_offset", stride, relu=False)
        n, c, h, w = x.shape
        ho, wo = om.shape[2:]
        k, dev = torch.arange(9, device=x.device), x.device
        ys = (torch.arange(ho, device=dev) * stride - 1)[None, :, None] + (k // 3)[:, None, None]
        xs = (torch.arange(wo, device=dev) * stride - 1)[None, None, :] + (k % 3)[:, None, None]
        py = ys.float()[None] + om[:, 0:18:2]
        px = xs.float()[None] + om[:, 1:18:2]
        mask = torch.sigmoid(om[:, 18:27])
        inside = (py > -1) & (px > -1) & (py < h) & (px < w)
        y0, x0 = torch.floor(py), torch.floor(px)
        ly, lx = py - y0, px - x0
        src = x.permute(0, 2, 3, 1).reshape(n, h * w, c)
        val = 0.0
        for dy, dx, wt in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx),
                           (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
            yy, xx = (y0 + dy).long(), (x0 + dx).long()
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(n, -1)
            got = torch.gather(src, 1, idx[..., None].expand(-1, -1, c)).view(n, 9, ho, wo, c)
            val = val + (wt * ok)[..., None] * got
        col = (val * (mask * inside)[..., None]).permute(0, 2, 3, 1, 4).reshape(n, ho * wo, 9 * c)
        wk = self.w[name]["w"].permute(0, 2, 3, 1).reshape(-1, 9 * c)  # tap-major
        y = torch.matmul(self._q(col), self._q(wk).t())
        y = y.view(n, ho, wo, -1).permute(0, 3, 1, 2)
        if self.w[name]["b"] is not None:  # a folded batch norm's
            y = y + self.w[name]["b"].view(1, -1, 1, 1)
        return F.relu(self._bn(y, name))

    def _convT(self, x, name, relu):
        p = self.w[name]
        y = F.conv_transpose2d(self._q(x), self._q(p["w"]), p["b"], stride=2)
        y = self._bn(y, name)
        return F.relu(y) if relu else y

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 BGR -> (N, H, W) probabilities."""
        x = images.float()
        if self.config.get("channel_order", "BGR") == "RGB":
            x = x.flip(-1)
        x = ((x - self.means.to(x.device)) / self.stds.to(x.device)).permute(0, 3, 1, 2)
        x = F.max_pool2d(self._conv(x, "conv1", 2), 3, 2, 1)
        feats = []
        for s, ((n, _), d) in enumerate(zip(STAGES, DCN), start=1):
            for b in range(n):
                at = f"layer{s}/{b}"
                stride = (1 if s == 1 else 2) if b == 0 else 1
                out = self._conv(x, f"{at}/conv1")
                out = self._deform(out, f"{at}/conv2", stride) if d else \
                    self._conv(out, f"{at}/conv2", stride)
                out = self._conv(out, f"{at}/conv3", relu=False)
                idt = self._conv(x, f"{at}/downsample", stride, relu=False) if b == 0 else x
                x = F.relu(out + idt)
            feats.append(x)
        c2, c3, c4, c5 = feats
        # nearest upsamples to the size of the map met: x2, x4, x8 on sides
        # that are multiples of 32
        up = lambda t, like: F.interpolate(t, size=like.shape[-2:], mode="nearest")  # noqa: E731
        in5, in4 = self._conv(c5, "in5", relu=False), self._conv(c4, "in4", relu=False)
        in3, in2 = self._conv(c3, "in3", relu=False), self._conv(c2, "in2", relu=False)
        out4 = up(in5, in4) + in4
        out3 = up(out4, in3) + in3
        out2 = up(out3, in2) + in2
        p2 = self._conv(out2, "out2", relu=False)
        fuse = torch.cat([up(self._conv(in5, "out5", relu=False), p2),
                          up(self._conv(out4, "out4", relu=False), p2),
                          up(self._conv(out3, "out3", relu=False), p2), p2], 1)
        h = self._convT(self._conv(fuse, "bin_conv"), "bin_up1", relu=True)
        return torch.sigmoid(self._convT(h, "bin_up2", relu=False))[:, 0]

    def maps(self, images: np.ndarray) -> List[np.ndarray]:
        """Per padded image its (H, W) probability map, float32 numpy."""
        out = []
        with torch.inference_mode(), no_tf32():
            for lo in range(0, len(images), self.block):
                x = torch.as_tensor(np.ascontiguousarray(images[lo:lo + self.block]))
                out += list(self.forward(x.to(self.device)).cpu().numpy())
        return out

    def detect(self, images: np.ndarray, infos: np.ndarray) -> List[Dict]:
        """Per padded image: ``maps`` (h, w) inside the resized extent,
        ``recs`` (n, 9) ``[x1, y1, ..., x4, y4, score]`` in the original
        image's pixels, and the counts of :func:`boxes_from_bitmap`."""
        text = dict(self.config["TEXT"],
                    max_candidates=int(self.config["program"]["TPU.DB_MAX_BOXES"]))
        res = []
        for m, info in zip(self.maps(images), infos):
            rh, rw = int(info[0]), int(info[1])
            m = m[:rh, :rw]
            recs, counts = boxes_from_bitmap(m, (int(info[2]), int(info[3])), text)
            res.append(dict(counts, maps=m, recs=recs))
        return res
