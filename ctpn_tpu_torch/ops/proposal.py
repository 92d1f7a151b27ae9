"""Proposal decoding on the device (the port of ``ctpn_tpu.ops.proposal``).

Fixed-shape form of the reference's `lib/rpn_msr/proposal_layer_tf.py:14-157`,
batched over images:

1. decode all H*W*A anchors with the y/h-only ``bbox_transform_inv``;
2. clip to each image's true extent inside the padded bucket;
3. validity masks: min size (``>= RPN_MIN_SIZE * im_scale`` on both sides)
   and anchor cells inside the true feature extent;
4. score sort: invalid keys become -inf, a STABLE ascending sort is flipped,
   so ties go to the larger index as in the reference's
   ``argsort()[::-1]``; keep the top ``RPN_PRE_NMS_TOP_N``;
5. greedy NMS at ``RPN_NMS_THRESH`` (stopping at ``post_nms_top_n`` kept);
6. compact the survivors, in score order, into ``post_nms_top_n`` slots;
   empty slots carry score -1 and valid False.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ctpn_tpu_torch.ops.anchors import FEAT_STRIDE, NUM_ANCHORS, shifted_anchors
from ctpn_tpu_torch.ops.boxes import bbox_transform_inv, box_sizes, clip_boxes
from ctpn_tpu_torch.ops.nms import nms_keep_sorted, take_rows
from ctpn_tpu_torch.utils.device import device_constant


class Proposals(NamedTuple):
    rois: torch.Tensor  # (N, post_n, 5) [score, x1, y1, x2, y2]
    valid: torch.Tensor  # (N, post_n) bool
    count: torch.Tensor  # (N,) int32


def proposal_layer(
    cls_prob: torch.Tensor,
    bbox_pred: torch.Tensor,
    im_info: torch.Tensor,
    pre_nms_top_n: int = 12000,
    post_nms_top_n: int = 1000,
    nms_thresh: float = 0.7,
    min_size: int = 8,
) -> Proposals:
    """Decode a batch of head outputs into scored proposals.

    cls_prob:  (N, H, W, A) fg probabilities
    bbox_pred: (N, H, W, A*4) regression deltas
    im_info:   (N, 3) [true_h, true_w, scale] per image
    """
    n_img, fh, fw, a = cls_prob.shape
    if a != NUM_ANCHORS:
        raise ValueError(f"expected {NUM_ANCHORS} anchors, got {a}")
    dev = cls_prob.device
    k = fh * fw * a
    anchors = device_constant(("anchors", fh, fw), dev, lambda: shifted_anchors(fh, fw))

    scores = cls_prob.reshape(n_img, k).float()
    deltas = bbox_pred.reshape(n_img, k, 4).float()
    im_info = im_info.float()
    im_h, im_w, im_scale = im_info[:, 0:1], im_info[:, 1:2], im_info[:, 2:3]

    boxes = bbox_transform_inv(anchors[None], deltas)
    boxes = clip_boxes(boxes, im_h, im_w)

    ws, hs = box_sizes(boxes)
    min_sz = min_size * im_scale
    valid = (ws >= min_sz) & (hs >= min_sz)

    # anchors whose grid cell lies beyond the true image extent see padded
    # pixels the reference never evaluates; drop them for parity
    idx = torch.arange(k, device=dev)
    cell_y = ((idx // (fw * a)) * FEAT_STRIDE).float()
    cell_x = (((idx // a) % fw) * FEAT_STRIDE).float()
    valid &= (cell_y[None] < im_h) & (cell_x[None] < im_w)

    sort_key = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    s_key, order = torch.sort(sort_key, dim=1, stable=True)
    lo = max(k - pre_nms_top_n, 0)
    order = order[:, lo:].flip(1)
    top_scores = s_key[:, lo:].flip(1)
    top_boxes = take_rows(boxes, order)
    top_valid = take_rows(valid, order)

    keep = nms_keep_sorted(
        top_boxes, top_valid, nms_thresh, max_keep=post_nms_top_n
    )

    # compact survivors (sorted order preserved) into post_nms_top_n slots
    n = keep.shape[1]
    pos = torch.arange(n, device=dev)
    compact = torch.sort(torch.where(keep, pos, n + pos), dim=1).indices
    if post_nms_top_n > n:  # fewer candidates than output slots: pad gather
        compact = torch.cat(
            [compact, compact.new_zeros((n_img, post_nms_top_n - n))], dim=1
        )
    compact = compact[:, :post_nms_top_n]
    count = torch.clamp(keep.sum(dim=1), max=post_nms_top_n).to(torch.int32)
    slot_valid = torch.arange(post_nms_top_n, device=dev)[None] < count[:, None]

    out_boxes = torch.where(slot_valid[..., None], take_rows(top_boxes, compact), 0.0)
    out_scores = torch.where(slot_valid, take_rows(top_scores, compact), -1.0)
    rois = torch.cat([out_scores[..., None], out_boxes], dim=-1)
    return Proposals(rois=rois, valid=slot_valid, count=count)
