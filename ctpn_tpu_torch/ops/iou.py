"""Pairwise IoU and intersection on tensors, +1 pixel convention (port of
``ctpn_tpu.ops.iou``).

* :func:`pairwise_iou`               ~ ``bbox_overlaps`` (`lib/utils/bbox.pyx:15-55`)
* :func:`pairwise_intersection_frac` ~ ``bbox_intersections`` (`lib/utils/bbox.pyx:57-94`)

Every function broadcasts over leading dims: ``boxes`` (..., N, 4) against
``query`` (..., K, 4) gives (..., N, K). The operation order is the JAX
package's (``bw*bh + qw*qh - inter``, then one division), and each
elementwise op is its own kernel, so nothing is contracted into an FMA: the
anchor-target layer compares these IoUs with ``==`` and against 0.7/0.3.
"""

from __future__ import annotations

import torch


def _sizes(b: torch.Tensor):
    return b[..., 2] - b[..., 0] + 1.0, b[..., 3] - b[..., 1] + 1.0


def pairwise_intersection(boxes: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """(..., N, K) intersection areas; a negative overlap counts 0."""
    iw = (
        torch.minimum(boxes[..., :, None, 2], query[..., None, :, 2])
        - torch.maximum(boxes[..., :, None, 0], query[..., None, :, 0])
        + 1.0
    )
    ih = (
        torch.minimum(boxes[..., :, None, 3], query[..., None, :, 3])
        - torch.maximum(boxes[..., :, None, 1], query[..., None, :, 1])
        + 1.0
    )
    return iw.clamp_(min=0.0) * ih.clamp_(min=0.0)


def pairwise_iou(boxes: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """(..., N, K) IoU between ``boxes`` (..., N, 4) and ``query`` (..., K, 4)."""
    inter = pairwise_intersection(boxes, query)
    bw, bh = _sizes(boxes)
    qw, qh = _sizes(query)
    union = (bw * bh)[..., :, None] + (qw * qh)[..., None, :] - inter
    return inter / union.clamp_(min=1e-10)


def pairwise_intersection_frac(boxes: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """(..., N, K) intersection normalised by the QUERY box's area (the
    dontcare masking of the anchor-target layer: the query is the anchor)."""
    inter = pairwise_intersection(boxes, query)
    qw, qh = _sizes(query)
    return inter / (qw * qh).clamp(min=1e-10)[..., None, :]
