"""Host-side NumPy reference implementations (oracles).

The port's own copy of ``ctpn_tpu.utils.host_ref`` (NumPy only, float64
where the original is); the port imports nothing of the JAX package.

Fresh NumPy implementations of the exact behavioral contracts of the
reference's host/Cython geometry kernels. They serve two roles:

1. test oracles for the fixed-shape on-device ops (`tests/` compare every
   device op against these on random inputs);
2. a pure-host fallback path, playing the role the reference's
   ``py_cpu_nms`` fallback plays in `lib/fast_rcnn/nms_wrapper.py:23-47`.

Contracts implemented (file:line cites into the reference repository):

* :func:`py_nms`            — greedy NMS, +1 areas, suppress at ``>= thresh``
                              (`lib/utils/cython_nms.pyx:17-68`).
* :func:`bbox_overlaps_np`  — dense pairwise IoU (`lib/utils/bbox.pyx:15-55`).
* :func:`bbox_intersections_np` — intersection / query-area
                              (`lib/utils/bbox.pyx:57-94`).
* :func:`bbox_transform_np` / :func:`bbox_transform_inv_np` /
  :func:`clip_boxes_np`     — (`lib/fast_rcnn/bbox_transform.py:3-80`),
                              including the CTPN y/h-only decode.
"""

from __future__ import annotations

import numpy as np


def bbox_overlaps_np(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """(N, K) pairwise IoU with +1 pixel areas."""
    boxes = np.asarray(boxes, dtype=np.float64)
    query = np.asarray(query, dtype=np.float64)
    iw = (
        np.minimum(boxes[:, None, 2], query[None, :, 2])
        - np.maximum(boxes[:, None, 0], query[None, :, 0])
        + 1.0
    )
    ih = (
        np.minimum(boxes[:, None, 3], query[None, :, 3])
        - np.maximum(boxes[:, None, 1], query[None, :, 1])
        + 1.0
    )
    inter = np.maximum(iw, 0.0) * np.maximum(ih, 0.0)
    area_b = (boxes[:, 2] - boxes[:, 0] + 1.0) * (boxes[:, 3] - boxes[:, 1] + 1.0)
    area_q = (query[:, 2] - query[:, 0] + 1.0) * (query[:, 3] - query[:, 1] + 1.0)
    union = area_b[:, None] + area_q[None, :] - inter
    out = np.where(inter > 0, inter / union, 0.0)
    return out


def bbox_intersections_np(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """(N, K) intersection area / query box area."""
    boxes = np.asarray(boxes, dtype=np.float64)
    query = np.asarray(query, dtype=np.float64)
    iw = (
        np.minimum(boxes[:, None, 2], query[None, :, 2])
        - np.maximum(boxes[:, None, 0], query[None, :, 0])
        + 1.0
    )
    ih = (
        np.minimum(boxes[:, None, 3], query[None, :, 3])
        - np.maximum(boxes[:, None, 1], query[None, :, 1])
        + 1.0
    )
    inter = np.maximum(iw, 0.0) * np.maximum(ih, 0.0)
    area_q = (query[:, 2] - query[:, 0] + 1.0) * (query[:, 3] - query[:, 1] + 1.0)
    return inter / area_q[None, :]


def py_nms(dets: np.ndarray, thresh: float) -> list:
    """Greedy NMS over (N, 5) [x1,y1,x2,y2,score]; returns kept indices.

    Tie order follows ``argsort()[::-1]`` (descending index on equal score),
    suppression triggers at IoU ``>= thresh``.
    """
    x1, y1, x2, y2 = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    scores = dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort(kind="stable")[::-1]
    suppressed = np.zeros(dets.shape[0], dtype=bool)
    keep = []
    for pos in range(len(order)):
        i = order[pos]
        if suppressed[i]:
            continue
        keep.append(int(i))
        rest = order[pos + 1 :]
        rest = rest[~suppressed[rest]]
        if rest.size == 0:
            continue
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[rest] - inter)
        suppressed[rest[ovr >= thresh]] = True
    return keep


def bbox_transform_np(ex_rois: np.ndarray, gt_rois: np.ndarray) -> np.ndarray:
    ex_w = ex_rois[:, 2] - ex_rois[:, 0] + 1.0
    ex_h = ex_rois[:, 3] - ex_rois[:, 1] + 1.0
    ex_cx = ex_rois[:, 0] + 0.5 * ex_w
    ex_cy = ex_rois[:, 1] + 0.5 * ex_h
    gt_w = gt_rois[:, 2] - gt_rois[:, 0] + 1.0
    gt_h = gt_rois[:, 3] - gt_rois[:, 1] + 1.0
    gt_cx = gt_rois[:, 0] + 0.5 * gt_w
    gt_cy = gt_rois[:, 1] + 0.5 * gt_h
    dx = (gt_cx - ex_cx) / ex_w
    dy = (gt_cy - ex_cy) / ex_h
    dw = np.log(gt_w / ex_w)
    dh = np.log(gt_h / ex_h)
    return np.stack([dx, dy, dw, dh], axis=1)


def bbox_transform_inv_np(boxes: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    """CTPN decode: x/width from anchors, y/height regressed."""
    boxes = boxes.astype(deltas.dtype, copy=False)
    w = boxes[:, 2] - boxes[:, 0] + 1.0
    h = boxes[:, 3] - boxes[:, 1] + 1.0
    cx = boxes[:, 0] + 0.5 * w
    cy = boxes[:, 1] + 0.5 * h
    dy = deltas[:, 1]
    dh = deltas[:, 3]
    pred_cy = dy * h + cy
    pred_h = np.exp(dh) * h
    out = np.zeros_like(deltas)
    out[:, 0] = cx - 0.5 * w
    out[:, 1] = pred_cy - 0.5 * pred_h
    out[:, 2] = cx + 0.5 * w
    out[:, 3] = pred_cy + 0.5 * pred_h
    return out


def clip_boxes_np(boxes: np.ndarray, im_shape) -> np.ndarray:
    out = boxes.copy()
    out[:, 0::2] = np.clip(out[:, 0::2], 0, im_shape[1] - 1)
    out[:, 1::2] = np.clip(out[:, 1::2], 0, im_shape[0] - 1)
    return out


def proposal_layer_np(
    cls_prob: np.ndarray,
    bbox_pred: np.ndarray,
    im_info,
    anchors: np.ndarray,
    pre_nms_top_n: int = 12000,
    post_nms_top_n: int = 1000,
    nms_thresh: float = 0.7,
    min_size: int = 8,
):
    """Host oracle of the reference proposal pipeline.

    Mirrors `lib/rpn_msr/proposal_layer_tf.py:14-157` step for step on
    (H, W, A) fg probs / (H, W, A*4) deltas for ONE image. Returns the (M, 5)
    [score, x1, y1, x2, y2] blob.
    """
    k = anchors.shape[0]
    scores = cls_prob.reshape(k).astype(np.float32)
    deltas = bbox_pred.reshape(k, 4).astype(np.float32)
    proposals = bbox_transform_inv_np(anchors.astype(np.float32), deltas)
    proposals = clip_boxes_np(proposals, im_info[:2])
    ws = proposals[:, 2] - proposals[:, 0] + 1
    hs = proposals[:, 3] - proposals[:, 1] + 1
    msz = min_size * im_info[2]
    keep = np.where((ws >= msz) & (hs >= msz))[0]
    proposals, scores = proposals[keep], scores[keep]
    order = scores.ravel().argsort(kind="stable")[::-1]
    if pre_nms_top_n > 0:
        order = order[:pre_nms_top_n]
    proposals, scores = proposals[order], scores[order]
    keep = py_nms(np.hstack([proposals, scores[:, None]]), nms_thresh)
    if post_nms_top_n > 0:
        keep = keep[:post_nms_top_n]
    proposals, scores = proposals[keep], scores[keep]
    return np.hstack([scores[:, None], proposals]).astype(np.float32)


def anchor_target_np(
    anchors: np.ndarray,
    gt_boxes: np.ndarray,
    gt_ishard: np.ndarray,
    dontcare: np.ndarray,
    im_info,
    positive_overlap: float = 0.7,
    negative_overlap: float = 0.3,
    dontcare_hi: float = 0.5,
    preclude_hard: bool = True,
):
    """Host oracle of the label-assignment stage of the reference
    `anchor_target_layer` (`anchor_target_layer_tf.py:82-175`), BEFORE
    subsampling (which is random in both implementations).

    Returns (labels, argmax_gt, inside_mask) over ALL anchors, with the
    unmap fill (-1) applied. Diverges from the reference in one guarded
    spot: a gt whose max overlap is exactly 0 does not promote anchors to
    fg (the reference's ``overlaps == gt_max`` comparison would mark every
    zero-overlap anchor — a known faster-rcnn quirk we do not reproduce).
    """
    k = anchors.shape[0]
    inside = np.where(
        (anchors[:, 0] >= 0)
        & (anchors[:, 1] >= 0)
        & (anchors[:, 2] < im_info[1])
        & (anchors[:, 3] < im_info[0])
    )[0]
    an = anchors[inside]
    labels = np.full(len(inside), -1, dtype=np.int64)
    overlaps = bbox_overlaps_np(an, gt_boxes[:, :4])
    argmax_gt = overlaps.argmax(axis=1)
    max_overlaps = overlaps[np.arange(len(inside)), argmax_gt]
    gt_max = overlaps.max(axis=0)
    labels[max_overlaps < negative_overlap] = 0
    gt_argmax = np.where((overlaps == gt_max[None, :]) & (gt_max[None, :] > 0))[0]
    labels[gt_argmax] = 1
    labels[max_overlaps >= positive_overlap] = 1
    if dontcare is not None and len(dontcare) > 0:
        frac = bbox_intersections_np(dontcare, an)
        labels[frac.sum(axis=0) > dontcare_hi] = -1
    if preclude_hard and gt_ishard is not None and gt_ishard.sum() > 0:
        hard = gt_boxes[gt_ishard.astype(bool), :4]
        ho = bbox_overlaps_np(hard, an)
        labels[ho.max(axis=0) >= positive_overlap] = -1
        labels[ho.argmax(axis=1)] = -1
    full = np.full(k, -1, dtype=np.int64)
    full[inside] = labels
    full_argmax = np.zeros(k, dtype=np.int64)
    full_argmax[inside] = argmax_gt
    inside_mask = np.zeros(k, dtype=bool)
    inside_mask[inside] = True
    return full, full_argmax, inside_mask
