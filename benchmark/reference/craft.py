"""CRAFT (VGG16-BN, region and affinity maps) in plain PyTorch and NumPy:
the reference that the port's CRAFT is held against.

Imports torch, numpy and PIL only, nothing of ``ctpn_tpu_torch`` and
nothing of JAX. :class:`ReferenceCRAFT` runs the float32 network (TF32
off) on padded uint8 BGR images with its batch norms unfolded (eval-mode
``F.batch_norm``), and ``getDetBoxes_core`` in NumPy with its own
labelling, dilation, convex hull and rotating calipers.

The network (Baek et al., CVPR 2019; clovaai/CRAFT-pytorch ``craft.py``,
``basenet/vgg16_bn.py``): VGG16-BN to ``conv5_2``; taps relu(conv2_2),
relu(conv3_2), relu(conv4_2) (torchvision's ReLUs work in place on the
slices' outputs), conv5_2 after its batch norm and before its ReLU, and
fc7 (a 3x3/1 max-pool of the pre-ReLU conv5_2, fc6 3x3 1024 dilation 6,
fc7 1x1 1024, no ReLU); four ``double_conv`` blocks (1x1 to mid, BN,
ReLU, 3x3 to out, BN, ReLU), the first on ``cat(fc7, conv5_2)``, the
others after a bilinear resize (``align_corners=False``) to the next
tap's size and a concat with it; ``conv_cls`` (3x3 32, 3x3 32, 3x3 16,
1x1 16, each with a ReLU, 1x1 to 2): the region and affinity maps at
stride 2.

Weights: the port's ``.npz`` format (flat ``a/b/c`` keys, conv kernels
HWIO, dense kernels (in, out), no batch norm: the artifact's convs carry
their own biases; an ``__trunk__`` artifact named beside it with its
sha256 gives the trunk), or a clovaai state dict (``basenet.slice1.0.weight``
..., ``module.`` prefixes stripped), whose batch norms run as they are.

The post-process (``craft_utils.py::getDetBoxes_core``, clovaai's
defaults: text 0.7, low text 0.4, link 0.4, no polygons, no refiner):

1. on: ``region > low_text`` or ``affinity > link_threshold``, inside the
   image's resized extent (``ceil(h / 2)`` rows, ``ceil(w / 2)`` columns);
2. 4-connected components, labelled in raster order of their first pixel
   (runs of each row joined to the runs they touch above, union-find);
3. kept: area >= 10 and largest region score >= text_threshold;
4. the component's pixels less the link-only ones (affinity over
   link_threshold, region not over low_text), dilated by the (1 +
   niter)-square, niter = int(sqrt(area * min(w, h) / (w * h)) * 2), as
   ``cv2.dilate`` does (anchor at k // 2, nothing from outside the
   window), inside the window [x - niter, x + w + niter + 1) (likewise y)
   clipped to the extent;
5. the minimum-area rectangle of the dilated pixels: their convex hull
   (the monotone chain over the pixels in (y, x) order), then for each
   hull edge the rectangle along it, the first of least area (areas times
   |e|^2 compared exactly in integers), its corners clockwise on the image;
   where its sides differ by at most 10 %, the pixels' axis-aligned box;
6. the corners rolled to start at the least x + y, times 2 (the map's
   stride): a record ``[x1, y1, ..., x4, y4, score]`` in the bucket's
   pixels, the score the component's largest region score.

Departures from clovaai, all of the port as well: the map is read inside
the resized extent only (clovaai reads the 32-padded map); the images are
resized bilinearly by PIL, padded into a bucket (clovaai: ``cv2.resize``,
padded to multiples of 32), and normalised as the configuration says; the
rectangle's corners are computed from the hull edge in double (OpenCV's
``minAreaRect`` and ``boxPoints`` round in float), so the diamond rule's
side ratio differs from clovaai's by rounding.

``quant="fp8"`` is the benchmark's control: the convs' inputs and weights
rounded to float8 e4m3 (one scale per tensor) before a float32 product,
one step below the port's bfloat16.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

FP8_MAX = 448.0
STRIDE = 2
BN_EPS = 1e-5
MIN_AREA = 10

# (block, reps) of VGG16 to conv5_2; taps after these convs' ReLU
TRUNK = ((1, 2), (2, 2), (3, 3), (4, 3), (5, 2))
TAPS = ("conv2_2", "conv3_2", "conv4_2")
# clovaai's state-dict names of each conv and of its batch norm
CLOVAAI = {
    "conv1_1": ("basenet.slice1.0", "basenet.slice1.1"),
    "conv1_2": ("basenet.slice1.3", "basenet.slice1.4"),
    "conv2_1": ("basenet.slice1.7", "basenet.slice1.8"),
    "conv2_2": ("basenet.slice1.10", "basenet.slice1.11"),
    "conv3_1": ("basenet.slice2.14", "basenet.slice2.15"),
    "conv3_2": ("basenet.slice2.17", "basenet.slice2.18"),
    "conv3_3": ("basenet.slice3.20", "basenet.slice3.21"),
    "conv4_1": ("basenet.slice3.24", "basenet.slice3.25"),
    "conv4_2": ("basenet.slice3.27", "basenet.slice3.28"),
    "conv4_3": ("basenet.slice4.30", "basenet.slice4.31"),
    "conv5_1": ("basenet.slice4.34", "basenet.slice4.35"),
    "conv5_2": ("basenet.slice4.37", "basenet.slice4.38"),
    "fc6": ("basenet.slice5.1", None),
    "fc7": ("basenet.slice5.2", None),
    **{f"up{k}_1x1": (f"upconv{k}.conv.0", f"upconv{k}.conv.1") for k in range(1, 5)},
    **{f"up{k}_3x3": (f"upconv{k}.conv.3", f"upconv{k}.conv.4") for k in range(1, 5)},
    "cls1": ("conv_cls.0", None),
    "cls2": ("conv_cls.2", None),
    "cls3": ("conv_cls.4", None),
    "cls4": ("conv_cls.6", None),
    "cls_out": ("conv_cls.8", None),
}


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


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    """The leaves of an ``.npz``: an int8 leaf times its float32
    ``<key>__scale`` per output channel (a float32 product), the trunk's
    leaves from the artifact it names."""
    with np.load(path) as z:
        raw = {k: z[k] for k in z.files}
    flat = {}
    for k, v in raw.items():
        if k.endswith("__scale"):
            continue
        if v.dtype == np.int8:
            v = v.astype(np.float32) * raw[k + "__scale"].astype(np.float32)
        flat[k] = v
    if "__trunk__" in flat:
        trunk = os.path.join(os.path.dirname(os.path.abspath(path)), str(flat.pop("__trunk__")))
        with open(trunk, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != str(flat.pop("__trunk_sha256__")):
            raise ValueError(f"{trunk}: sha256 {digest} is not the one {path} names")
        with np.load(trunk) as z:
            flat.update({k: z[k] for k in z.files if k.startswith("VGG16Trunk_0/")})
    return flat


def load_weights(weights: Union[str, Dict], device) -> Dict[str, dict]:
    """Per conv name: ``{"w": OIHW, "b": (O,), "bn": (gamma, beta, mean,
    var) or None}`` float32 on ``device``, from an ``.npz`` path or flat
    dict in the port's format, or from a clovaai state dict."""
    flat = _read_npz(weights) if isinstance(weights, str) else dict(weights)
    flat = {k[len("module."):] if k.startswith("module.") else k: v for k, v in flat.items()}

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float32)).to(device)

    out = {}
    if any(k.startswith("basenet.") for k in flat):
        for name, (conv, bn) in CLOVAAI.items():
            w = t(flat[f"{conv}.weight"])
            entry = {"w": w, "b": t(flat[f"{conv}.bias"]), "bn": None}
            if bn is not None:
                entry["bn"] = tuple(t(flat[f"{bn}.{k}"]) for k in
                                    ("weight", "bias", "running_mean", "running_var"))
            out[name] = entry
        return out
    for name in CLOVAAI:
        key = f"VGG16Trunk_0/{name}" if name.startswith("conv") else name
        k = t(flat[f"{key}/kernel"])
        w = k.t()[:, :, None, None] if k.ndim == 2 else k.permute(3, 2, 0, 1)
        out[name] = {"w": w.contiguous(), "b": t(flat[f"{key}/bias"]), "bn": None}
    return out


# ---------------------------------------------------------------- input
def resize_factor(h: int, w: int, mag_ratio: float, canvas: int,
                  buckets: Sequence[Sequence[int]]) -> Tuple[float, Tuple[int, int]]:
    """clovaai's ``resize_aspect_ratio``: the long side to min(mag_ratio x
    long side, canvas), the sizes padded to multiples of 32, in the
    smallest bucket that holds them, else the factor shrunk to fit the
    largest bucket."""
    f = min(mag_ratio * max(h, w), float(canvas)) / max(h, w)
    th, tw = int(h * f), int(w * f)
    h32, w32 = -(-th // 32) * 32, -(-tw // 32) * 32
    fits = [(bh * bw, bh, bw) for bh, bw in buckets if bh >= h32 and bw >= w32]
    _, bh, bw = min(fits) if fits else max((bh * bw, bh, bw) for bh, bw in buckets)
    if th > bh or tw > bw:
        f = min(f, bh / h, bw / w)
    return f, (bh, bw)


def prep(im_bgr: np.ndarray, config: dict) -> Tuple[np.ndarray, np.ndarray, float]:
    """One uint8 BGR image -> (padded uint8 image, im_info [h, w, 1],
    factor): CRAFT's resize (bilinear; a factor of 1 copies), zero padding
    at the bottom and right."""
    text = config["TEXT"]
    h, w = im_bgr.shape[:2]
    f, (bh, bw) = resize_factor(h, w, text["MAG_RATIO"], text["CANVAS_SIZE"],
                                config["buckets"])
    if f != 1.0:
        size = (int(w * f), int(h * f))
        im_bgr = np.asarray(Image.fromarray(im_bgr).resize(size, Image.BILINEAR))
    rh, rw = min(im_bgr.shape[0], bh), min(im_bgr.shape[1], bw)
    out = np.zeros((bh, bw, 3), np.uint8)
    out[:rh, :rw] = im_bgr[:rh, :rw]
    return out, np.array([rh, rw, 1.0], np.float32), f


def extent(info) -> Tuple[int, int]:
    """Rows and columns of the stride-2 map inside the resized extent."""
    return (int(info[0]) + 1) // STRIDE, (int(info[1]) + 1) // STRIDE


# ------------------------------------------------------------- labelling
def label_components(on: np.ndarray) -> np.ndarray:
    """(H, W) bool -> int64 labels 1.. in raster order of each 4-connected
    component's first pixel, 0 off."""
    h, w = on.shape
    parent: List[int] = []

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    runs = []  # (y, x0, x1, run id) per row
    prev: List[Tuple[int, int, int]] = []
    for y in range(h):
        row = on[y]
        d = np.diff(np.concatenate([[0], row.astype(np.int8), [0]]))
        starts, ends = np.flatnonzero(d == 1), np.flatnonzero(d == -1)
        cur = []
        j = 0
        for x0, x1 in zip(starts.tolist(), ends.tolist()):
            rid = len(parent)
            parent.append(rid)
            while j < len(prev) and prev[j][1] <= x0:
                j += 1
            k = j
            while k < len(prev) and prev[k][0] < x1:
                a, b = find(rid), find(prev[k][2])
                parent[max(a, b)] = min(a, b)
                k += 1
            cur.append((x0, x1, rid))
            runs.append((y, x0, x1, rid))
        prev = cur
    labels = np.zeros((h, w), np.int64)
    names: Dict[int, int] = {}
    for y, x0, x1, rid in runs:  # run ids grow in raster order
        root = find(rid)
        if root not in names:
            names[root] = len(names) + 1
        labels[y, x0:x1] = names[root]
    return labels


def dilate(mask: np.ndarray, k: int) -> np.ndarray:
    """``cv2.dilate`` of a bool mask by the k-square, anchor k // 2:
    dst(x) = any src(x + d), d in [-a, k - 1 - a], nothing from outside."""
    a = k // 2
    out = np.zeros_like(mask)
    h, w = mask.shape
    for dy in range(-a, k - a):
        for dx in range(-a, k - a):
            ys, yd = slice(max(dy, 0), h + min(dy, 0)), slice(max(-dy, 0), h + min(-dy, 0))
            xs, xd = slice(max(dx, 0), w + min(dx, 0)), slice(max(-dx, 0), w + min(-dx, 0))
            out[yd, xd] |= mask[ys, xs]
    return out


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
    """(corners (4, 2) float32 clockwise on the image, side along the
    edge, side across it) of the least-area rectangle over the hull's edges."""
    if len(hull) == 1:
        return np.array(hull * 4, np.float32), 0.0, 0.0
    best = None
    for i in range(len(hull)):
        (x0, y0), (x1, y1) = hull[i], hull[(i + 1) % len(hull)]
        ex, ey = x1 - x0, y1 - y0
        u = [ex * x + ey * y for x, y in hull]
        v = [ex * y - ey * x for x, y in hull]
        area, norm2 = (max(u) - min(u)) * (max(v) - min(v)), ex * ex + ey * ey
        if best is None or area * best[1] < best[0] * norm2:
            best = (area, norm2, ex, ey, min(u), max(u), min(v), max(v))
    _, n2, ex, ey, u0, u1, v0, v1 = best
    pts = [((a * ex - b * ey) / n2, (a * ey + b * ex) / n2)
           for a, b in ((u0, v0), (u1, v0), (u1, v1), (u0, v1))]
    root = math.sqrt(n2)
    return np.array(pts, np.float64).astype(np.float32), (u1 - u0) / root, (v1 - v0) / root


def det_boxes(region: np.ndarray, link: np.ndarray, text_threshold: float,
              link_threshold: float, low_text: float) -> Tuple[List[np.ndarray], dict]:
    """``getDetBoxes_core`` on one image's maps, cut to its extent: the
    boxes (4, 2) in map pixels with their scores, and the counts."""
    text_score = region > np.float32(low_text)
    link_score = link > np.float32(link_threshold)
    on = text_score | link_score
    labels = label_components(on)
    n = int(labels.max())
    h, w = region.shape
    out, boxes_px, hulls = [], [], []
    flat = labels.ravel()
    order = np.argsort(flat, kind="stable")
    bounds = np.searchsorted(flat[order], np.arange(n + 2))
    for k in range(1, n + 1):
        idx = order[bounds[k]:bounds[k + 1]]
        ys, xs = idx // w, idx % w
        size = len(idx)
        if size < MIN_AREA:
            continue
        score = float(region.ravel()[idx].max())
        if score < np.float32(text_threshold):
            continue
        x, y = int(xs.min()), int(ys.min())
        cw, ch = int(xs.max()) - x + 1, int(ys.max()) - y + 1
        niter = int(math.sqrt(size * min(cw, ch) / (cw * ch)) * 2)
        sx, ex = max(x - niter, 0), min(x + cw + niter + 1, w)
        sy, ey = max(y - niter, 0), min(y + ch + niter + 1, h)
        seg = np.zeros((h, w), bool)
        seg[ys, xs] = True
        seg &= ~(link_score & ~text_score)
        seg[sy:ey, sx:ex] = dilate(seg[sy:ey, sx:ex], 1 + niter)
        py, px = np.nonzero(seg)  # (y, x) order
        hull = convex_hull(list(zip(px.tolist(), py.tolist())))
        box, side_u, side_v = min_area_rect(hull)
        if len(hull) > 1 and abs(1 - max(side_u, side_v) / (min(side_u, side_v) + 1e-5)) <= 0.1:
            l, r, t, b = int(px.min()), int(px.max()), int(py.min()), int(py.max())
            box = np.array([[l, t], [r, t], [r, b], [l, b]], np.float32)
        start = int(np.argmin(box.sum(axis=1)))
        out.append((np.roll(box, 4 - start, 0), score))
        boxes_px.append(cw * ch)
        hulls.append(len(hull))
    counts = {"on": int(on.sum()), "labelled": n, "kept": len(out),
              "box_pixels": int(sum(boxes_px)), "hull_points": int(sum(hulls))}
    return out, counts


# -------------------------------------------------------------- network
class ReferenceCRAFT:
    """The detector of ``config`` (``pixel_means``, ``pixel_stds``,
    ``channel_order``; ``TEXT``: ``TEXT_THRESHOLD``, ``LOW_TEXT``,
    ``LINK_THRESHOLD``) with ``weights`` (an ``.npz`` path, a flat dict in
    the port's format, or a clovaai state dict) on ``device``."""

    def __init__(self, config: dict, weights, device="cpu", quant: Optional[str] = None,
                 block: int = 4):
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

    def _conv(self, x, name, relu=True, dilation=1):
        p = self.w[name]
        k = p["w"].shape[-1]
        pad = dilation * (k // 2)
        y = F.conv2d(self._q(x), self._q(p["w"]), p["b"], padding=pad, dilation=dilation)
        if p["bn"] is not None:
            g, b, m, v = p["bn"]
            y = F.batch_norm(y, m, v, g, b, training=False, eps=BN_EPS)
        return F.relu(y) if relu else y

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 BGR -> (N, H/2, W/2, 2) [region, affinity]."""
        x = images.float()
        if self.config.get("channel_order", "BGR") == "RGB":
            x = x.flip(-1)
        x = ((x - self.means.to(x.device)) / self.stds.to(x.device)).permute(0, 3, 1, 2)
        taps = []
        for block, reps in TRUNK:
            for rep in range(1, reps + 1):
                name = f"conv{block}_{rep}"
                last5 = block == 5 and rep == reps
                x = self._conv(x, name, relu=not last5)
                if name in TAPS or last5:
                    taps.append(x)
                if rep == reps and block < 5:
                    x = F.max_pool2d(x, 2, 2)
        c2, c3, c4, c5 = taps
        fc = self._conv(F.max_pool2d(c5, 3, 1, 1), "fc6", relu=False, dilation=6)
        fc = self._conv(fc, "fc7", relu=False)
        h = torch.cat([fc, c5], 1)
        for k, skip in enumerate((None, c4, c3, c2), start=1):
            if skip is not None:
                h = F.interpolate(h, size=skip.shape[-2:], mode="bilinear", align_corners=False)
                h = torch.cat([h, skip], 1)
            h = self._conv(self._conv(h, f"up{k}_1x1"), f"up{k}_3x3")
        for name in ("cls1", "cls2", "cls3", "cls4"):
            h = self._conv(h, name)
        return self._conv(h, "cls_out", relu=False).permute(0, 2, 3, 1)

    def maps(self, images: np.ndarray) -> List[np.ndarray]:
        """Per padded image its (H/2, W/2, 2) maps, float32 numpy."""
        out = []
        with torch.inference_mode(), no_tf32():
            for lo in range(0, len(images), self.block):
                x = torch.as_tensor(np.ascontiguousarray(images[lo:lo + self.block]))
                out += list(self.forward(x.to(self.device)).cpu().numpy())
        return out

    def detect(self, images: np.ndarray, infos: np.ndarray) -> List[Dict]:
        """Per padded image: ``maps`` (h, w, 2) inside the extent, ``recs``
        (n, 9) ``[x1, y1, ..., x4, y4, score]`` in the bucket's pixels, and
        the counts of ``det_boxes``."""
        t = self.config["TEXT"]
        res = []
        for m, info in zip(self.maps(images), infos):
            eh, ew = extent(info)
            m = m[:eh, :ew]
            boxes, counts = det_boxes(m[..., 0], m[..., 1], t["TEXT_THRESHOLD"],
                                      t["LINK_THRESHOLD"], t["LOW_TEXT"])
            recs = np.array([np.concatenate([b.reshape(8) * np.float32(STRIDE), [s]])
                             for b, s in boxes], np.float32).reshape(-1, 9)
            res.append(dict(counts, maps=m, recs=recs))
        return res
