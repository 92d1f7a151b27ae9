"""CRAFT's word boxes: a minimum-area rectangle per kept component
(clovaai/CRAFT-pytorch ``craft_utils.py::getDetBoxes_core``: the
component's dilation, ``cv2.minAreaRect``, ``cv2.boxPoints``, the diamond
rule and the corners' roll).

No TPU counterpart: the JAX package runs CTPN only. Each component's box
needs its own dilation and convex hull, of a size that only its pixels
decide, so the card runs it as one op, a block per component.

* :func:`craft_boxes` is the wrapper around the op
  ``torch.ops.ctpn_torch.craft_boxes``. A CUDA tensor launches the
  hand-written kernel in ``ops/csrc/craft_ccl.cu``; a CPU tensor runs
  :func:`craft_boxes_ref`, the plain version (NumPy, one component at a
  time, the kernel's arithmetic step for step). There is no fallback from
  one to the other.

Contract (both versions), on ``ops/ccl.py::ccl_label``'s outputs: for
each kept component ``[label, area, x, y, w, h]`` of image b:

1. its text pixels: those labelled ``label`` whose region score is over
   ``low_text`` (the link-only pixels are left out);
2. dilated by the ``k = 1 + niter`` square, ``niter = int(sqrt(area *
   min(w, h) / (w * h)) * 2)``, with ``cv2.dilate``'s anchor ``a = k // 2``
   (a pixel q marks ``q - (k - 1 - a)`` to ``q + a`` on each axis), inside
   the window ``[x - niter, x + w + niter + 1)`` and ``[y - niter, y + h +
   niter + 1)`` clipped to the extent;
3. the convex hull of each dilated row's leftmost and rightmost pixels:
   Andrew's monotone chain over them in (y, x) order, a point dropped
   where the turn is not strictly convex;
4. for each hull edge ``e = (dx, dy)`` in hull order, with ``n = (-dy,
   dx)``: ``U`` and ``V`` the ranges of ``e.p`` and ``n.p`` over the hull
   (integers), the rectangle's area times ``|e|^2`` being ``U * V``; the
   first edge of least ``U * V / |e|^2`` (compared exactly) is kept; its
   corners ``(u e + v n) / |e|^2`` at (min u, min v), (max u, min v),
   (max u, max v), (min u, max v), in double, rounded to float32:
   clockwise on the image;
5. where ``max(s) / (min(s) + 1e-5)``, ``s`` the sides ``U / |e|`` and
   ``V / |e|`` in double, is within 0.1 of 1, the corners are instead
   those of the dilated pixels' axis-aligned box (left, top), (right,
   top), (right, bottom), (left, bottom);
6. rolled to start at the least ``x + y`` (float32 sums, the first on
   ties), scaled by ``scale`` (float32).

A one-point hull gives four equal corners, no text pixel four zeros.
Returns recs (B, K, 9) float32 ``[x1, y1, ..., x4, y4, score]``, zero
past each image's count.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ctpn_tpu_torch.ops import _kernel
from ctpn_tpu_torch.ops._kernel import FLOAT, INT, PTR


def _check(maps, labels, stats, score, count, extent) -> None:
    if maps.ndim != 4 or maps.shape[-1] != 2 or maps.dtype != torch.float32:
        raise ValueError(f"maps must be float32 (B, H, W, 2), got {tuple(maps.shape)}")
    b, h, w = maps.shape[:3]
    if labels.dtype != torch.int32 or tuple(labels.shape) != (b, h, w):
        raise ValueError(f"labels must be int32 ({b}, {h}, {w}), got {tuple(labels.shape)}")
    if stats.dtype != torch.int32 or stats.ndim != 3 or stats.shape[0] != b \
            or stats.shape[2] != 6:
        raise ValueError(f"stats must be int32 ({b}, K, 6), got {tuple(stats.shape)}")
    if score.dtype != torch.float32 or tuple(score.shape) != tuple(stats.shape[:2]):
        raise ValueError(f"score must be float32 {tuple(stats.shape[:2])}")
    if count.dtype != torch.int32 or tuple(count.shape) != (b,):
        raise ValueError(f"count must be int32 ({b},)")
    if extent.dtype != torch.int32 or tuple(extent.shape) != (b, 2):
        raise ValueError(f"extent must be int32 ({b}, 2)")
    if len({t.device for t in (maps, labels, stats, score, count, extent)}) != 1:
        raise ValueError("craft_boxes: every input must be on one device")
    if maps.device.type not in ("cpu", "cuda"):
        raise ValueError(f"craft_boxes: unsupported device {maps.device}")


def _cross(o, a, b) -> int:
    return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])


def monotone_chain(points):
    """The convex hull of ``points`` (sorted, distinct) by Andrew's chain,
    a point dropped where the turn is not strictly convex."""
    if len(points) <= 1:
        return list(points)
    hull = []
    for p in points:
        while len(hull) >= 2 and _cross(hull[-2], hull[-1], p) <= 0:
            hull.pop()
        hull.append(p)
    t = len(hull) + 1
    for p in reversed(points[:-1]):
        while len(hull) >= t and _cross(hull[-2], hull[-1], p) <= 0:
            hull.pop()
        hull.append(p)
    return hull[:-1]


def min_area_corners(hull):
    """Step 4 on hull points ``[(x, y), ...]``: (corners (4, 2) float32,
    U, V, |e|^2)."""
    if len(hull) <= 1:  # one point, or none (no text pixel): zeros
        return np.array((hull or [(0, 0)]) * 4, np.float32), 0, 0, 0
    best = None
    for i, (x, y) in enumerate(hull):
        nx, ny = hull[(i + 1) % len(hull)]
        dx, dy = nx - x, ny - y
        us = [dx * px + dy * py for px, py in hull]
        vs = [dx * py - dy * px for px, py in hull]
        area, ll = (max(us) - min(us)) * (max(vs) - min(vs)), dx * dx + dy * dy
        if best is None or area * best[1] < best[0] * ll:
            best = (area, ll, dx, dy, min(us), max(us), min(vs), max(vs))
    _, ll, dx, dy, u0, u1, v0, v1 = best
    corners = [(float(u * dx - v * dy) / float(ll), float(u * dy + v * dx) / float(ll))
               for u, v in ((u0, v0), (u1, v0), (u1, v1), (u0, v1))]
    return np.array(corners, np.float64).astype(np.float32), u1 - u0, v1 - v0, ll


def component_box(region: np.ndarray, labels: np.ndarray, stat, extent, low: np.float32):
    """Steps 1-5 for one component of one image's (H, W) maps: (corners
    (4, 2) float32 before the roll)."""
    label, area, x0, y0, cw, ch = (int(v) for v in stat)
    eh, ew = (int(v) for v in extent)
    niter = int(math.sqrt(area * min(cw, ch) / (cw * ch)) * 2)
    k = 1 + niter
    a = k // 2
    back = k - 1 - a
    sx, ex = max(x0 - niter, 0), min(x0 + cw + niter + 1, ew)
    sy, ey = max(y0 - niter, 0), min(y0 + ch + niter + 1, eh)
    box = (labels[y0:y0 + ch, x0:x0 + cw] == label) & (region[y0:y0 + ch, x0:x0 + cw] > low)
    src = [(x0 + int(np.flatnonzero(r)[0]), x0 + int(np.flatnonzero(r)[-1])) if r.any()
           else None for r in box]
    rows = []
    for y in range(sy, ey):
        got = [src[q - y0] for q in range(max(y - a, y0), min(y + back, y0 + ch - 1) + 1)
               if src[q - y0] is not None]
        if got:
            rows.append((y, max(min(g[0] for g in got) - back, sx),
                         min(max(g[1] for g in got) + a, ex - 1)))
    points = []
    for y, lo, hi in rows:
        points.append((lo, y))
        if hi != lo:
            points.append((hi, y))
    hull = monotone_chain(sorted(points, key=lambda p: (p[1], p[0])))
    corners, su, sv, ll = min_area_corners(hull)
    if len(hull) > 1:
        root = math.sqrt(ll)
        sw, sh = su / root, sv / root
        if abs(1.0 - max(sw, sh) / (min(sw, sh) + 1e-5)) <= 0.1:
            left, right = min(r[1] for r in rows), max(r[2] for r in rows)
            top, bottom = rows[0][0], rows[-1][0]
            corners = np.array([(left, top), (right, top), (right, bottom), (left, bottom)],
                               np.float32)
    return corners


def rolled(corners: np.ndarray) -> np.ndarray:
    """Step 6's roll: the corner of least x + y (float32) first."""
    sums = corners[:, 0] + corners[:, 1]
    return np.roll(corners, -int(np.argmin(sums)), 0)


def craft_boxes_ref(maps: torch.Tensor, labels: torch.Tensor, stats: torch.Tensor,
                    score: torch.Tensor, count: torch.Tensor, extent: torch.Tensor,
                    low_text: float, scale: float) -> torch.Tensor:
    """Plain version: NumPy, one component at a time."""
    _check(maps, labels, stats, score, count, extent)
    m, lab = maps.detach().cpu().numpy(), labels.cpu().numpy()
    st, sc = stats.cpu().numpy(), score.cpu().numpy()
    n, ext = count.cpu().numpy(), extent.cpu().numpy()
    low, f = np.float32(low_text), np.float32(scale)
    recs = np.zeros((*st.shape[:2], 9), np.float32)
    for b in range(st.shape[0]):
        for s in range(int(n[b])):
            c = rolled(component_box(m[b, ..., 0], lab[b], st[b, s], ext[b], low))
            recs[b, s, :8] = (c * f).reshape(8)
            recs[b, s, 8] = sc[b, s]
    return torch.from_numpy(recs).to(maps.device)


_KERNEL = _kernel.Entry("craft_boxes", [PTR] * 7 + [INT, INT, INT, INT, FLOAT, FLOAT],
                        source="craft_ccl")


def _launch(maps, labels, stats, score, count, extent, low_text: float,
            scale: float) -> torch.Tensor:
    """The op's CUDA implementation: launch the kernel or raise."""
    _check(maps, labels, stats, score, count, extent)
    dev = maps.device
    batch, h, w = maps.shape[:3]
    cap = stats.shape[1]
    recs = torch.zeros((batch, cap, 9), dtype=torch.float32, device=dev)
    if batch == 0 or cap == 0:
        return recs
    _KERNEL(dev, maps.contiguous(), labels.contiguous(), stats.contiguous(),
            score.contiguous(), count.contiguous(), extent.contiguous(), recs, batch, h, w,
            cap, float(low_text), float(scale))
    return recs


def _fake(maps, labels, stats, score, count, extent, low_text, scale):
    _check(maps, labels, stats, score, count, extent)
    return maps.new_empty((stats.shape[0], stats.shape[1], 9))


_kernel.op("craft_boxes(Tensor maps, Tensor labels, Tensor stats, Tensor score, Tensor count, "
           "Tensor extent, float low_text, float scale) -> Tensor",
           cpu=craft_boxes_ref, cuda=_launch, fake=_fake)


@_KERNEL.counts
def craft_boxes(maps: torch.Tensor, labels: torch.Tensor, stats: torch.Tensor,
                score: torch.Tensor, count: torch.Tensor, extent: torch.Tensor,
                low_text: float, scale: float) -> torch.Tensor:
    """(B, K, 9) ``[x1, y1, ..., x4, y4, score]`` of the kept components.

    Calls the op ``torch.ops.ctpn_torch.craft_boxes``: CPU tensors run
    :func:`craft_boxes_ref`; CUDA tensors launch the kernel (adding one to
    ``craft_boxes.LAUNCHES`` and ``LAUNCHES_BY_DEVICE``) or raise.
    """
    _check(maps, labels, stats, score, count, extent)
    return torch.ops.ctpn_torch.craft_boxes(maps, labels, stats, score, count, extent,
                                            float(low_text), float(scale))
