"""CTPN vertical anchor ladder and dense anchor grids (NumPy, host side).

The port's own copy of ``ctpn_tpu.ops.anchors``. Contract (reference
`lib/rpn_msr/generate_anchors.py:24-32`): 10 anchors of fixed width 16 and
heights [11,16,23,33,48,68,97,139,198,283], each centered on the 16x16 base
cell [0,0,15,15] whose center is 7.5, materialized with int truncation
(e.g. height 11 => y1=2, y2=13). The grid is built once per feature-map
shape and cached; callers move it to the device.
"""

from __future__ import annotations

import functools

import numpy as np

ANCHOR_HEIGHTS = (11, 16, 23, 33, 48, 68, 97, 139, 198, 283)
ANCHOR_WIDTH = 16
NUM_ANCHORS = len(ANCHOR_HEIGHTS)
FEAT_STRIDE = 16


@functools.lru_cache(maxsize=None)
def anchor_ladder(base_size: int = 16) -> np.ndarray:
    """(A, 4) int-truncated base anchors [x1, y1, x2, y2], A=10."""
    ctr = (base_size - 1) * 0.5  # 7.5 for the 16x16 base cell
    out = np.zeros((NUM_ANCHORS, 4), dtype=np.int32)
    for i, h in enumerate(ANCHOR_HEIGHTS):
        out[i, 0] = int(ctr - ANCHOR_WIDTH / 2.0)
        out[i, 1] = int(ctr - h / 2.0)
        out[i, 2] = int(ctr + ANCHOR_WIDTH / 2.0)
        out[i, 3] = int(ctr + h / 2.0)
    return out


@functools.lru_cache(maxsize=None)
def shifted_anchors(feat_h: int, feat_w: int, stride: int = FEAT_STRIDE) -> np.ndarray:
    """(H*W*A, 4) float32 anchors over an H x W feature map, (h, w, a) order:
    row index = ((h * W) + w) * A + a. The cached array is read-only."""
    base = anchor_ladder().astype(np.float32)  # (A, 4)
    xs = np.arange(feat_w, dtype=np.float32) * stride
    ys = np.arange(feat_h, dtype=np.float32) * stride
    shift_x, shift_y = np.meshgrid(xs, ys)  # (H, W)
    shifts = np.stack(
        [shift_x.ravel(), shift_y.ravel(), shift_x.ravel(), shift_y.ravel()], axis=1
    )  # (K, 4)
    out = np.ascontiguousarray((shifts[:, None, :] + base[None, :, :]).reshape(-1, 4))
    out.flags.writeable = False
    return out
