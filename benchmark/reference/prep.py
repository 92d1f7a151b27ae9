"""Resize and pad in the reference: the demo's double resize.

An image (BGR, the order the network was trained on) is scaled so that
its short side is ``TEXT.SCALE`` with the long side at most
``TEXT.MAX_SCALE`` (``ctpn/demo.py``), then again to ``TEST.SCALES[0]``
and ``TEST.MAX_SIZE`` (``lib/fast_rcnn/test.py``), both bilinear, and
padded with zeros at the bottom and right into the smallest bucket that
holds it. ``im_info`` is
[height, width, second factor].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from PIL import Image


def factor(h: int, w: int, scale: int, max_scale: int) -> float:
    f = float(scale) / min(h, w)
    if f * max(h, w) > max_scale:
        f = float(max_scale) / max(h, w)
    return f


def resize(im: np.ndarray, scale: int, max_scale: int) -> Tuple[np.ndarray, float]:
    f = factor(im.shape[0], im.shape[1], scale, max_scale)
    size = (int(im.shape[1] * f), int(im.shape[0] * f))
    return np.asarray(Image.fromarray(im).resize(size, Image.BILINEAR)), f


def bucket_of(h: int, w: int, buckets: Sequence[Sequence[int]]) -> Tuple[int, int]:
    fits = [(bh * bw, bh, bw) for bh, bw in buckets if bh >= h and bw >= w]
    _, bh, bw = min(fits) if fits else max((bh * bw, bh, bw) for bh, bw in buckets)
    return bh, bw


def prep(im_bgr: np.ndarray, config: dict) -> Tuple[np.ndarray, np.ndarray, float]:
    """One BGR image -> (padded uint8 image, im_info, first factor)."""
    text, test = config["TEXT"], config["TEST"]
    once, f1 = resize(im_bgr, text["SCALE"], text["MAX_SCALE"])
    twice, f2 = resize(once, test["SCALES"][0], test["MAX_SIZE"])
    h, w = twice.shape[:2]
    bh, bw = bucket_of(h, w, config["buckets"])
    h, w = min(h, bh), min(w, bw)
    out = np.zeros((bh, bw, 3), np.uint8)
    out[:h, :w] = twice[:h, :w]
    return out, np.array([h, w, f2], np.float32), f1
