"""Greedy NMS on the device (the port of ``ctpn_tpu.ops.nms``), batched over
images.

Semantics as in the reference: boxes sorted by score descending, a box is
suppressed when its IoU with an already-kept earlier box is ``>= thresh``,
areas use the +1 pixel convention, and invalid (padding) boxes neither
survive nor suppress.

``cfg.TPU.NMS_FUSED`` selects the route of :func:`nms_keep_sorted`:

* True (default): the fused kernel (``ops/nms_fused.py``), build and
  resolve in one launch with an early exit at ``max_keep``;
* False: two phases, as the JAX package runs them on the TPU. The
  suppression bitmask kernel (``ops/nms_bitmask.py``) builds the (N, N/32)
  words; the resolve kernel (``ops/nms_resolve.py``) finds the greedy keep
  set from them, the unique solution of ``keep[i] = valid[i] and not
  any(keep[j] and bit(j, i) for j < i)``. Both phases stay on the device:
  two launches and no device-to-host sync.

The resolve's plain versions, :func:`nms_fixed_point` and
:func:`nms_fixed_point_blocked` (fixed-point sweeps with one host sync
each, counted in their ``SWEEPS``), live in ``ops/nms_resolve.py`` and are
re-exported here; only CPU tensors reach them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.ops import nms_bitmask, nms_fused
from ctpn_tpu_torch.ops.nms_resolve import (  # noqa: F401  (re-exported)
    nms_fixed_point,
    nms_fixed_point_blocked,
    nms_resolve,
    or_reduce,
)

def nms_keep_sorted(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    thresh: float,
    max_keep: Optional[int] = None,
) -> torch.Tensor:
    """Batched greedy-NMS keep mask, boxes (B, K, 4) already score-sorted.

    ``max_keep``: callers that consume only the first K survivors (the
    proposal layer's ``RPN_POST_NMS_TOP_N``) pass K so the fused kernel
    stops early; the first K keep flags are identical either way, and the
    bitmask route resolves every box.
    """
    if cfg.TPU.NMS_FUSED:
        return nms_fused.nms_keep_sorted_fused(boxes, valid, thresh, max_keep)
    mask = nms_bitmask.suppression_bitmask(boxes, valid, thresh)
    return nms_resolve(mask, valid)


def _score_order(scores: torch.Tensor) -> torch.Tensor:
    """Reference order ``np.argsort(scores)[::-1]``: score descending, ties
    by descending original index (a stable ascending sort, flipped)."""
    return torch.sort(scores, dim=1, stable=True).indices.flip(1)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``x`` (N, K, ...) along dim 1 by ``idx`` (N, M)."""
    if x.ndim == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    thresh: float,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy-NMS keep mask (B, N) bool in the ORIGINAL box order.

    boxes (B, N, 4) f32, scores (B, N). Equivalent to the reference's
    ``nms(np.hstack((boxes, scores)), t)`` (`nms_wrapper.py:11-20`) as a
    membership mask.
    """
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    order = _score_order(scores)
    keep_sorted = nms_keep_sorted(
        take_rows(boxes, order).contiguous(), take_rows(valid, order), thresh
    )
    return torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)


def nms_keep_indices(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    thresh: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded keep indices in score-descending order and the valid count.

    Returns ``(indices (B, max_out) int32, count (B,) int32)``; entries at
    or beyond ``count`` are 0.
    """
    batch, n = scores.shape
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    order = _score_order(scores)
    keep_sorted = nms_keep_sorted(
        take_rows(boxes, order).contiguous(), take_rows(valid, order), thresh,
        max_keep=max_out,
    )
    count = torch.clamp(keep_sorted.sum(dim=1), max=max_out).to(torch.int32)
    # compact: kept sorted positions first, sorted order preserved
    pos = torch.arange(n, device=scores.device)
    compact = torch.sort(torch.where(keep_sorted, pos, n + pos), dim=1).indices
    if max_out > n:
        compact = torch.cat([compact, compact.new_zeros((batch, max_out - n))], 1)
    idx = torch.gather(order, 1, compact[:, :max_out])
    slot_valid = torch.arange(max_out, device=scores.device)[None] < count[:, None]
    return torch.where(slot_valid, idx, 0).to(torch.int32), count
