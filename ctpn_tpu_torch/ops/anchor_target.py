"""Anchor-target assignment on the device: training labels and regression
targets (port of ``ctpn_tpu.ops.anchor_target``; reference
`lib/rpn_msr/anchor_target_layer_tf.py:10-276`).

Batched on a leading axis (one row per image), with the JAX package's
semantics:

* only anchors fully inside the true image take part (`:101-113`); the rest
  get label -1 and zero targets and weights (`_unmap`, `:241-244`);
* bg where max-IoU < RPN_NEGATIVE_OVERLAP, fg for every anchor that ties
  some valid gt's max IoU (guarded by ``gt_max > 0``) or reaches
  RPN_POSITIVE_OVERLAP; with RPN_CLOBBER_POSITIVES=False bg is set first
  (`:135-149`);
* dontcare areas: anchors whose summed intersection fraction exceeds
  DONTCARE_AREA_INTERSECTION_HI -> -1 (`:152-159`);
* hard gt: anchors overlapping a hard gt >= RPN_POSITIVE_OVERLAP, and each
  hard gt's own argmax anchor, -> -1 (`:163-175`);
* fg kept to RPN_FG_FRACTION * RPN_BATCHSIZE, bg to fill RPN_BATCHSIZE
  (`:181-197`), each by ranking an iid uniform draw over the eligible
  anchors; with ``ohem`` every negative stays 0 and the loss picks the
  hardest (``training/loss.py``);
* targets encode every inside anchor against its argmax gt (`:203-204`);
  inside weights on fg only, outside weights 1 on fg.

The uniform draws are an input, ``u_fg`` and ``u_bg`` of shape (B, K), so
that a caller can feed the draws of another implementation; the train step
makes them from its own ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ctpn_tpu_torch.ops.anchors import NUM_ANCHORS, shifted_anchors
from ctpn_tpu_torch.ops.boxes import bbox_transform
from ctpn_tpu_torch.ops.iou import pairwise_intersection_frac, pairwise_iou
from ctpn_tpu_torch.utils.device import device_constant


class AnchorTargets(NamedTuple):
    labels: torch.Tensor  # (B, H, W, A) int32: 1 fg, 0 bg, -1 ignore
    bbox_targets: torch.Tensor  # (B, H, W, A*4) float32
    bbox_inside_weights: torch.Tensor  # (B, H, W, A*4)
    bbox_outside_weights: torch.Tensor  # (B, H, W, A*4)


def num_anchors(feat_h: int, feat_w: int) -> int:
    """K, the anchors of one image: the length of a row of draws."""
    return feat_h * feat_w * NUM_ANCHORS


def _sample_to_cap(u: torch.Tensor, eligible: torch.Tensor, cap) -> torch.Tensor:
    """Keep at most ``cap`` eligible entries per row, those with the lowest
    draws: ranks from a stable double argsort, as ``jnp.argsort`` gives.
    ``cap`` is an int or a (B,) tensor."""
    key = torch.where(eligible, u, 2.0)  # ineligible entries sort last
    rank = torch.argsort(torch.argsort(key, dim=-1, stable=True), dim=-1, stable=True)
    if isinstance(cap, torch.Tensor):
        cap = cap[:, None]
    return eligible & (rank < cap)


def anchor_target_layer(
    gt_boxes: torch.Tensor,  # (B, G, 4) padded
    gt_valid: torch.Tensor,  # (B, G) bool
    gt_ishard: torch.Tensor,  # (B, G) bool
    dontcare: torch.Tensor,  # (B, D, 4) padded
    dontcare_valid: torch.Tensor,  # (B, D) bool
    im_info: torch.Tensor,  # (B, 3)
    u_fg: torch.Tensor,  # (B, K) uniform draws for the fg subsample
    u_bg: torch.Tensor,  # (B, K) uniform draws for the bg subsample
    feat_h: int,
    feat_w: int,
    positive_overlap: float = 0.7,
    negative_overlap: float = 0.3,
    fg_fraction: float = 0.5,
    rpn_batchsize: int = 300,
    dontcare_hi: float = 0.5,
    inside_weights: Sequence[float] = (0.0, 1.0, 0.0, 1.0),
    clobber_positives: bool = False,
    preclude_hard: bool = True,
    ohem: bool = False,
) -> AnchorTargets:
    dev = gt_boxes.device
    anchors = device_constant(("anchors", feat_h, feat_w), dev,
                              lambda: shifted_anchors(feat_h, feat_w))
    b, k = gt_boxes.shape[0], anchors.shape[0]
    im_h, im_w = im_info[:, 0:1], im_info[:, 1:2]

    inside = (
        (anchors[:, 0] >= 0)
        & (anchors[:, 1] >= 0)
        & (anchors[:, 2] < im_w)
        & (anchors[:, 3] < im_h)
    )  # (B, K)

    # IoU against the padded gt; invalid columns are 0 and never match
    overlaps = pairwise_iou(anchors, gt_boxes)  # (B, K, G)
    overlaps = torch.where(gt_valid[:, None, :] & inside[:, :, None], overlaps, 0.0)

    max_overlap, argmax_gt = overlaps.max(dim=2)  # (B, K)
    gt_max = overlaps.amax(dim=1)  # (B, G)
    is_gt_argmax = (
        (overlaps == gt_max[:, None, :])
        & (gt_valid & (gt_max > 0.0))[:, None, :]
    ).any(dim=2)

    neg = inside & (max_overlap < negative_overlap)
    pos = inside & (is_gt_argmax | (max_overlap >= positive_overlap))

    labels = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    zero, one = labels.new_zeros(()), labels.new_ones(())
    if not clobber_positives:
        labels = torch.where(neg, zero, labels)
        labels = torch.where(pos, one, labels)
    else:
        labels = torch.where(pos, one, labels)
        labels = torch.where(neg, zero, labels)

    # dontcare: summed intersection fraction over the valid areas
    dc_frac = pairwise_intersection_frac(dontcare, anchors)  # (B, D, K)
    dc_sum = torch.where(dontcare_valid[:, :, None], dc_frac, 0.0).sum(dim=1)
    labels = torch.where(inside & (dc_sum > dontcare_hi), -one, labels)

    if preclude_hard:
        hard_valid = gt_valid & gt_ishard
        hard_overlaps = torch.where(
            hard_valid[:, None, :] & inside[:, :, None], overlaps, 0.0
        )
        labels = torch.where(
            inside & (hard_overlaps.amax(dim=2) >= positive_overlap), -one, labels
        )
        # each hard gt's best anchor is excluded too; an invalid column's
        # argmax is 0 and adds 0
        hard_argmax = hard_overlaps.argmax(dim=1)  # (B, G)
        hits = torch.zeros((b, k), dtype=torch.int32, device=dev).scatter_add_(
            1, hard_argmax, hard_valid.to(torch.int32)
        )
        labels = torch.where((hits > 0) & inside, -one, labels)
        del hard_overlaps
    del overlaps

    # subsample fg to its cap, then bg to fill rpn_batchsize
    fg = labels == 1
    fg_kept = _sample_to_cap(u_fg, fg, int(fg_fraction * rpn_batchsize))
    labels = torch.where(fg & ~fg_kept, -one, labels)
    if not ohem:
        num_bg_cap = rpn_batchsize - fg_kept.sum(dim=1)
        bg = labels == 0
        bg_kept = _sample_to_cap(u_bg, bg, num_bg_cap)
        labels = torch.where(bg & ~bg_kept, -one, labels)

    # regression targets for every inside anchor against its argmax gt
    matched = torch.gather(gt_boxes, 1, argmax_gt[:, :, None].expand(b, k, 4))
    targets = bbox_transform(anchors, matched)
    targets = torch.where(inside[:, :, None], targets, 0.0).to(torch.float32)

    is_fg = (labels == 1)[:, :, None]
    iw = device_constant(("inside_weights", tuple(inside_weights)), dev,
                         lambda: np.array(inside_weights, np.float32))
    bbox_inside = torch.where(is_fg, iw, 0.0)
    bbox_outside = torch.where(is_fg, 1.0, 0.0).expand(b, k, 4)

    a = NUM_ANCHORS
    return AnchorTargets(
        labels=labels.reshape(b, feat_h, feat_w, a),
        bbox_targets=targets.reshape(b, feat_h, feat_w, a * 4),
        bbox_inside_weights=bbox_inside.reshape(b, feat_h, feat_w, a * 4),
        bbox_outside_weights=bbox_outside.reshape(b, feat_h, feat_w, a * 4),
    )
