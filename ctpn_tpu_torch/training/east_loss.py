"""EAST's training targets and loss (Zhou et al., CVPR 2017, section 3.3
and 3.4), RBOX geometry.

Targets (:func:`rbox_targets`), on the stride-4 grid of points (4x, 4y)
that the post-process restores from (``postprocess/east.py``):

* score: 1 inside each word's rectangle shrunk by 0.3 r on every side,
  r the shorter side (the paper's shrink, for the rectangles the renders
  draw: each edge moves in by 0.3 times its vertices' reference length);
* geometry, at the positive points: the distances to the top, right,
  bottom and left edges of the word's minimum-area rectangle, and its
  angle in [-pi/4, pi/4): the rectangle's side nearest the horizontal is
  "along the text";
* a mask: 0 over don't-care words (shorter side under ``min_side`` px, or
  cut by the crop's frame), 1 elsewhere.

Loss (:func:`east_loss`): class-balanced cross-entropy on the score map,
``beta = 1 - sum(Y*) / |Y*|`` per image over the mask, plus ``lambda_g``
(1) times the geometry loss on the positive points: ``-log IoU`` of the
predicted and target rectangles in the rectangle's frame, plus
``lambda_theta`` (10) times ``1 - cos(theta - theta*)``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from PIL import Image, ImageDraw

STRIDE = 4
SHRINK = 0.3


def min_area_rect(quad: np.ndarray) -> Tuple[np.ndarray, float, float, float]:
    """(center (2,), width along the text, height, angle) of the
    minimum-area rectangle of a quad (4, 2): one of its sides lies along an
    edge of the quad's hull, so each edge's direction is tried."""
    pts = np.asarray(quad, np.float64).reshape(4, 2)
    best = None
    for i in range(4):
        d = pts[(i + 1) % 4] - pts[i]
        if not np.any(d):
            continue
        a = math.atan2(d[1], d[0])
        u = np.array([math.cos(a), math.sin(a)])
        v = np.array([-u[1], u[0]])
        pu, pv = pts @ u, pts @ v
        area = (pu.max() - pu.min()) * (pv.max() - pv.min())
        if best is None or area < best[0] - 1e-9:
            c = u * (pu.max() + pu.min()) / 2 + v * (pv.max() + pv.min()) / 2
            best = (area, c, pu.max() - pu.min(), pv.max() - pv.min(), a)
    if best is None:
        return pts.mean(0), 0.0, 0.0, 0.0
    _, c, w, h, a = best
    # the side nearest the horizontal is along the text: angle in [-pi/4, pi/4)
    a = (a + math.pi / 2) % math.pi - math.pi / 2  # (-pi/2, pi/2]
    if a >= math.pi / 4:
        a, w, h = a - math.pi / 2, h, w
    elif a < -math.pi / 4:
        a, w, h = a + math.pi / 2, h, w
    return c, w, h, a


def rbox_targets(quads: Sequence[np.ndarray], dontcare: Sequence[bool], height: int,
                 width: int, min_side: float = 8.0):
    """Targets of one image of ``height`` x ``width`` with word ``quads``
    (each (8,) TL, TR, BR, BL): (score (h, w), geo (h, w, 4) top, right,
    bottom, left, angle (h, w), mask (h, w)), all float32, h = height / 4,
    w = width / 4 (rounded down)."""
    h, w = height // STRIDE, width // STRIDE
    score = np.zeros((h, w), np.float32)
    geo = np.zeros((h, w, 4), np.float32)
    angle = np.zeros((h, w), np.float32)
    mask_img = Image.new("L", (w, h), 1)
    draw = ImageDraw.Draw(mask_img)
    oy, ox = np.mgrid[0:h, 0:w].astype(np.float64) * STRIDE
    for quad, dc in zip(quads, dontcare):
        c, rw, rh, a = min_area_rect(quad)
        if dc or min(rw, rh) < min_side:
            pts = np.asarray(quad, np.float64).reshape(4, 2) / STRIDE
            draw.polygon([tuple(p) for p in pts], fill=0)
            continue
        u = np.array([math.cos(a), math.sin(a)])
        v = np.array([-u[1], u[0]])
        du = (ox - c[0]) * u[0] + (oy - c[1]) * u[1]
        dv = (ox - c[0]) * v[0] + (oy - c[1]) * v[1]
        r = SHRINK * min(rw, rh)
        inside = (np.abs(du) <= rw / 2 - r) & (np.abs(dv) <= rh / 2 - r)
        score[inside] = 1.0
        geo[inside] = np.stack([dv + rh / 2, rw / 2 - du, rh / 2 - dv, du + rw / 2],
                               -1)[inside]
        angle[inside] = a
    mask = np.asarray(mask_img, np.float32)
    return score, geo, angle, mask


def east_loss(score, geo, angle, t_score, t_geo, t_angle, mask,
              lambda_g: float = 1.0, lambda_theta: float = 10.0):
    """(total, score loss, geometry loss): the predicted maps (N, h, w),
    (N, h, w, 4), (N, h, w) against the targets of :func:`rbox_targets`."""
    eps = 1e-6
    p = score.clamp(eps, 1 - eps)
    n_pos = (t_score * mask).sum((1, 2))
    n_all = mask.sum((1, 2)).clamp(min=1)
    beta = (1 - n_pos / n_all)[:, None, None]
    ce = -(beta * t_score * torch.log(p) + (1 - beta) * (1 - t_score) * torch.log(1 - p))
    l_score = (ce * mask).sum() / mask.sum().clamp(min=1)
    pos = t_score * mask
    t_, r_, b_, l_ = t_geo.unbind(-1)
    tp, rp, bp, lp = geo.unbind(-1)
    area_t = (t_ + b_) * (l_ + r_)
    area_p = (tp + bp) * (lp + rp)
    inter = (torch.minimum(l_, lp) + torch.minimum(r_, rp)) * (
        torch.minimum(t_, tp) + torch.minimum(b_, bp))
    union = area_t + area_p - inter
    l_aabb = -torch.log((inter + 1.0) / (union + 1.0))
    l_theta = 1 - torch.cos(angle - t_angle)
    l_geo = ((l_aabb + lambda_theta * l_theta) * pos).sum() / pos.sum().clamp(min=1)
    return l_score + lambda_g * l_geo, l_score, l_geo
