"""Box encode, decode and clip on tensors (the port of ``ctpn_tpu.ops.boxes``).

* ``bbox_transform`` — encode (dx, dy, dw, dh) with the +1-pixel size
  convention (`lib/fast_rcnn/bbox_transform.py:3-34`); the training targets.
* ``bbox_transform_inv`` — the CTPN decode: x-center and width are NOT
  regressed; only dy/dh apply (`lib/fast_rcnn/bbox_transform.py:50-53`).
* ``clip_boxes`` — clamp to ``[0, dim-1]`` (`bbox_transform.py:67-80`).

Sizes use the +1-pixel convention. Every function broadcasts over leading
dims and never filters: validity is carried by masks built from
:func:`box_sizes`.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

Scalar = Union[float, torch.Tensor]


def box_sizes(boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Widths/heights with the +1 pixel convention. boxes: (..., 4)."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return w, h


def bbox_transform(ex_rois: torch.Tensor, gt_rois: torch.Tensor) -> torch.Tensor:
    """Encode ``gt_rois`` relative to ``ex_rois``: (..., 4) -> (..., 4).

    No degenerate-box assert: callers mask invalid rows. Zero-size padding
    rows of ``gt_rois`` stay finite through the guarded log.
    """
    ex_w, ex_h = box_sizes(ex_rois)
    gt_w, gt_h = box_sizes(gt_rois)
    ex_cx = ex_rois[..., 0] + 0.5 * ex_w
    ex_cy = ex_rois[..., 1] + 0.5 * ex_h
    gt_cx = gt_rois[..., 0] + 0.5 * gt_w
    gt_cy = gt_rois[..., 1] + 0.5 * gt_h
    dx = (gt_cx - ex_cx) / ex_w
    dy = (gt_cy - ex_cy) / ex_h
    dw = torch.log(gt_w.clamp(min=1e-6) / ex_w)
    dh = torch.log(gt_h.clamp(min=1e-6) / ex_h)
    return torch.stack(torch.broadcast_tensors(dx, dy, dw, dh), dim=-1)


def bbox_transform_inv(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """CTPN decode: keep the anchor's x-center and width, apply dy/dh.

    boxes: (..., 4) anchors; deltas: (..., 4) (dx, dy, dw, dh), of which
    dx/dw are ignored.
    """
    w, h = box_sizes(boxes)
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    pred_cy = deltas[..., 1] * h + cy
    pred_h = torch.exp(deltas[..., 3]) * h
    x1 = cx - 0.5 * w
    y1 = pred_cy - 0.5 * pred_h
    x2 = cx + 0.5 * w
    y2 = pred_cy + 0.5 * pred_h
    return torch.stack(torch.broadcast_tensors(x1, y1, x2, y2), dim=-1)


def clip_boxes(boxes: torch.Tensor, im_h: Scalar, im_w: Scalar) -> torch.Tensor:
    """Clamp all coordinates into ``[0, im_dim - 1]``.

    ``im_h``/``im_w`` are Python numbers or tensors that broadcast against
    ``boxes[..., 0]`` (one true image size per image of a padded batch).
    """
    x = torch.clamp(boxes[..., 0::2], min=0.0)
    y = torch.clamp(boxes[..., 1::2], min=0.0)
    x = torch.minimum(x, _col(im_w - 1.0, x))
    y = torch.minimum(y, _col(im_h - 1.0, y))
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def _col(bound: Scalar, like: torch.Tensor) -> torch.Tensor:
    """``bound`` as a tensor that broadcasts against ``like`` (..., 2)."""
    t = torch.as_tensor(bound, dtype=like.dtype, device=like.device)
    return t.unsqueeze(-1) if t.ndim else t
