"""DBNet's word boxes: a minimum-area rectangle per component of the
binarized probability map, scored, unclipped and mapped to the original
image (MhLiao/DB ``structure/representers/seg_detector_representer.py::
boxes_from_bitmap``: ``get_mini_boxes``, ``box_score_fast``, ``unclip``).

No TPU counterpart: the JAX package runs CTPN only. Each component's box
needs its own convex hull and its own score, of a size that only its
pixels decide, so the card runs it as one op, a block per component
(``db_boxes_kernel`` in ``ops/csrc/craft_ccl.cu``, on the row extremes,
hull and calipers of CRAFT's box kernel, with no dilation).

* :func:`db_boxes` is the wrapper around the op
  ``torch.ops.ctpn_torch.db_boxes``. A CUDA tensor launches the kernel; a
  CPU tensor runs :func:`db_boxes_ref`, the plain version (NumPy, one
  component at a time, the kernel's arithmetic step for step). There is no
  fallback from one to the other.

Contract (both versions), on ``ops/ccl.py::ccl_label``'s outputs for the
map binarized at ``thresh`` (8-connected): for each kept component
``[label, area, x, y, w, h]`` of image b, with ``(eh, ew)`` its extent
(the resized image's rows and columns) and ``(dh, dw)`` its original size:

1. the convex hull of each row's leftmost and rightmost pixels of the
   component (the outer border's hull, which ``cv2.findContours`` and
   ``cv2.minAreaRect`` take), by Andrew's monotone chain;
2. the rectangle of least area over the hull's edges, compared exactly in
   integers, the first on ties (``craft_boxes``' step 4): its corners in
   double rounded to float32, its sides ``U / |e|`` and ``V / |e|`` in
   double; dropped where the shorter side is under ``min_size``;
3. ``get_mini_boxes``' order: sorted by x (stable), the upper of the left
   two (the second on equal y), the upper of the right two, the lower of
   the right two, the lower of the left two;
4. the score: the mean probability (double; each of 128 lanes sums the
   pixels ``t, t + 128, ...`` in raster order, then the lanes in order)
   over the pixels of the box's bounding box (``floor`` and ``ceil`` of
   the corners clipped to the extent) that lie inside or on the quad of
   the corners less the box's corner, truncated to integers (all four edge
   cross products of one sign or zero); 0 without such a pixel; dropped
   under ``box_thresh``;
5. the unclip, closed form: ``d = area * unclip / perimeter`` of the
   ordered corners (double); each corner moved by ``d`` away from each of
   its two neighbours along their edges, which grows a rectangle by ``d``
   on every side (the round-joined offset's minimum-area rectangle);
   dropped where the grown rectangle's shorter side (``|g1 - g0|``,
   ``|g3 - g0|``) is under ``min_size + 2``; rounded to float32 and put in
   step 3's order again;
6. each corner ``round(v / ew * dw)`` (float32 operations, ties to even),
   clipped to ``[0, dw]`` (likewise y with ``eh`` and ``dh``).

Returns recs (B, K, 9) float32 ``[x1, y1, ..., x4, y4, score]`` in the
original image's pixels and keep (B, K) int32 (1: kept), zero elsewhere.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ctpn_tpu_torch.ops import _kernel
from ctpn_tpu_torch.ops._kernel import DOUBLE, INT, PTR
from ctpn_tpu_torch.ops.craft_boxes import min_area_corners, monotone_chain

LANES = 128  # the kernel's threads per block: the score's summing lanes


def _check(prob, labels, stats, count, extent, dest) -> None:
    if prob.ndim != 3 or prob.dtype != torch.float32:
        raise ValueError(f"prob must be float32 (B, H, W), got {prob.dtype} {tuple(prob.shape)}")
    b, h, w = prob.shape
    if labels.dtype != torch.int32 or tuple(labels.shape) != (b, h, w):
        raise ValueError(f"labels must be int32 ({b}, {h}, {w}), got {tuple(labels.shape)}")
    if stats.dtype != torch.int32 or stats.ndim != 3 or stats.shape[0] != b \
            or stats.shape[2] != 6:
        raise ValueError(f"stats must be int32 ({b}, K, 6), got {tuple(stats.shape)}")
    if count.dtype != torch.int32 or tuple(count.shape) != (b,):
        raise ValueError(f"count must be int32 ({b},)")
    if extent.dtype != torch.int32 or tuple(extent.shape) != (b, 2):
        raise ValueError(f"extent must be int32 ({b}, 2)")
    if dest.dtype != torch.float32 or tuple(dest.shape) != (b, 2):
        raise ValueError(f"dest must be float32 ({b}, 2)")
    if len({t.device for t in (prob, labels, stats, count, extent, dest)}) != 1:
        raise ValueError("db_boxes: every input must be on one device")
    if prob.device.type not in ("cpu", "cuda"):
        raise ValueError(f"db_boxes: unsupported device {prob.device}")


def mini_order(pts: np.ndarray) -> np.ndarray:
    """Step 3 on (4, 2) float32 corners."""
    idx = sorted(range(4), key=lambda i: pts[i, 0])
    left = pts[idx[1], 1] > pts[idx[0], 1]
    right = pts[idx[3], 1] > pts[idx[2], 1]
    order = [idx[0] if left else idx[1], idx[2] if right else idx[3],
             idx[3] if right else idx[2], idx[1] if left else idx[0]]
    return pts[order]


def _len(ax: float, ay: float, bx: float, by: float) -> float:
    dx, dy = bx - ax, by - ay
    return math.sqrt(dx * dx + dy * dy)


def box_score(prob: np.ndarray, box: np.ndarray, eh: int, ew: int) -> float:
    """Step 4 on one image's (H, W) map and its ordered float32 corners."""
    xmin = min(max(int(np.floor(box[:, 0].min())), 0), ew - 1)
    xmax = min(max(int(np.ceil(box[:, 0].max())), 0), ew - 1)
    ymin = min(max(int(np.floor(box[:, 1].min())), 0), eh - 1)
    ymax = min(max(int(np.ceil(box[:, 1].max())), 0), eh - 1)
    poly = [(int(box[c, 0] - np.float32(xmin)), int(box[c, 1] - np.float32(ymin)))
            for c in range(4)]
    bw, bh = xmax - xmin + 1, ymax - ymin + 1
    ly, lx = np.mgrid[0:bh, 0:bw]
    neg = np.zeros((bh, bw), bool)
    pos = np.zeros((bh, bw), bool)
    for c in range(4):
        (ox, oy), (ax, ay) = poly[c], poly[(c + 1) % 4]
        cr = (ax - ox) * (ly - oy) - (ay - oy) * (lx - ox)
        neg |= cr < 0
        pos |= cr > 0
    inside = ~(neg & pos)
    vals = np.where(inside, prob[ymin:ymax + 1, xmin:xmax + 1].astype(np.float64), 0.0).ravel()
    total = 0.0
    for t in range(min(LANES, vals.size)):
        total += float(np.cumsum(vals[t::LANES])[-1])
    n = int(inside.sum())
    return total / n if n else 0.0


def unclipped(box: np.ndarray, unclip: float):
    """Step 5's grown corners (4, 2) in double and the shorter side."""
    x, y = [float(v) for v in box[:, 0]], [float(v) for v in box[:, 1]]
    twice = perim = 0.0
    for c in range(4):
        d = (c + 1) % 4
        twice += x[c] * y[d] - x[d] * y[c]
        perim += _len(x[c], y[c], x[d], y[d])
    dist = abs(twice) * 0.5 * unclip / perim
    g = []
    for c in range(4):
        nx, pv = (c + 1) % 4, (c + 3) % 4
        lu, lv = _len(x[nx], y[nx], x[c], y[c]), _len(x[pv], y[pv], x[c], y[c])
        g.append((x[c] + dist * (x[c] - x[nx]) / lu + dist * (x[c] - x[pv]) / lv,
                  y[c] + dist * (y[c] - y[nx]) / lu + dist * (y[c] - y[pv]) / lv))
    side = min(_len(*g[0], *g[1]), _len(*g[0], *g[3]))
    return np.array(g, np.float64), side


def component_record(prob: np.ndarray, labels: np.ndarray, stat, extent, dest, box_thresh,
                     unclip, min_size):
    """Steps 1-6 for one component: the record (9,) float32, or None where
    a step drops it."""
    label, _, x0, y0, cw, ch = (int(v) for v in stat)
    eh, ew = (int(v) for v in extent)
    box = labels[y0:y0 + ch, x0:x0 + cw] == label
    points = []
    for r, row in enumerate(box):
        xs = np.flatnonzero(row)
        if len(xs):
            points.append((x0 + int(xs[0]), y0 + r))
            if xs[-1] != xs[0]:
                points.append((x0 + int(xs[-1]), y0 + r))
    hull = monotone_chain(points)
    if len(hull) <= 1:
        return None
    corners, su, sv, ll = min_area_corners(hull)
    root = math.sqrt(ll)
    if min(su / root, sv / root) < min_size:
        return None
    box = mini_order(corners)
    score = box_score(prob, box, eh, ew)
    if score < box_thresh:
        return None
    grown, side = unclipped(box, unclip)
    if side < min_size + 2.0:
        return None
    out = mini_order(grown.astype(np.float32))
    dh, dw = np.float32(dest[0]), np.float32(dest[1])
    rec = np.zeros(9, np.float32)
    rec[0:8:2] = np.clip(np.rint(out[:, 0] / np.float32(ew) * dw), np.float32(0), dw)
    rec[1:8:2] = np.clip(np.rint(out[:, 1] / np.float32(eh) * dh), np.float32(0), dh)
    rec[8] = np.float32(score)
    return rec


def db_boxes_ref(prob: torch.Tensor, labels: torch.Tensor, stats: torch.Tensor,
                 count: torch.Tensor, extent: torch.Tensor, dest: torch.Tensor,
                 box_thresh: float, unclip: float, min_size: float):
    """Plain version: NumPy, one component at a time."""
    _check(prob, labels, stats, count, extent, dest)
    p, lab = prob.detach().cpu().numpy(), labels.cpu().numpy()
    st, n = stats.cpu().numpy(), count.cpu().numpy()
    ext, dst = extent.cpu().numpy(), dest.cpu().numpy()
    recs = np.zeros((*st.shape[:2], 9), np.float32)
    keep = np.zeros(st.shape[:2], np.int32)
    for b in range(st.shape[0]):
        for s in range(int(n[b])):
            rec = component_record(p[b], lab[b], st[b, s], ext[b], dst[b], float(box_thresh),
                                   float(unclip), float(min_size))
            if rec is not None:
                recs[b, s], keep[b, s] = rec, 1
    return torch.from_numpy(recs).to(prob.device), torch.from_numpy(keep).to(prob.device)


_KERNEL = _kernel.Entry("db_boxes", [PTR] * 8 + [INT, INT, INT, INT, DOUBLE, DOUBLE, DOUBLE],
                        source="craft_ccl")


def _launch(prob, labels, stats, count, extent, dest, box_thresh: float, unclip: float,
            min_size: float):
    """The op's CUDA implementation: launch the kernel or raise."""
    _check(prob, labels, stats, count, extent, dest)
    dev = prob.device
    batch, h, w = prob.shape
    cap = stats.shape[1]
    recs = torch.zeros((batch, cap, 9), dtype=torch.float32, device=dev)
    keep = torch.zeros((batch, cap), dtype=torch.int32, device=dev)
    if batch == 0 or cap == 0:
        return recs, keep
    _KERNEL(dev, prob.contiguous(), labels.contiguous(), stats.contiguous(), count.contiguous(),
            extent.contiguous(), dest.contiguous(), recs, keep, batch, h, w, cap,
            float(box_thresh), float(unclip), float(min_size))
    return recs, keep


def _fake(prob, labels, stats, count, extent, dest, box_thresh, unclip, min_size):
    _check(prob, labels, stats, count, extent, dest)
    b, k = stats.shape[:2]
    return prob.new_empty((b, k, 9)), prob.new_empty((b, k), dtype=torch.int32)


_kernel.op("db_boxes(Tensor prob, Tensor labels, Tensor stats, Tensor count, Tensor extent, "
           "Tensor dest, float box_thresh, float unclip, float min_size) -> (Tensor, Tensor)",
           cpu=db_boxes_ref, cuda=_launch, fake=_fake)


@_KERNEL.counts
def db_boxes(prob: torch.Tensor, labels: torch.Tensor, stats: torch.Tensor, count: torch.Tensor,
             extent: torch.Tensor, dest: torch.Tensor, box_thresh: float, unclip: float,
             min_size: float):
    """(recs (B, K, 9), keep (B, K)) of the kept components' boxes.

    Calls the op ``torch.ops.ctpn_torch.db_boxes``: CPU tensors run
    :func:`db_boxes_ref`; CUDA tensors launch the kernel (adding one to
    ``db_boxes.LAUNCHES`` and ``LAUNCHES_BY_DEVICE``) or raise.
    """
    _check(prob, labels, stats, count, extent, dest)
    return torch.ops.ctpn_torch.db_boxes(prob, labels, stats, count, extent, dest,
                                         float(box_thresh), float(unclip), float(min_size))
