"""Greedy-NMS dispatch (the port of ``ctpn_tpu.ops.nms.nms_keep_sorted``).

Semantics as in the reference: boxes sorted by score descending, a box is
suppressed when its IoU with an already-kept earlier box is ``>= thresh``,
areas use the +1 pixel convention, and invalid (padding) boxes neither
survive nor suppress.

``cfg.TPU.NMS_FUSED`` (default True) selects the fused kernel, which is the
only NMS the port has so far: the bitmask kernel that the JAX package runs
with ``NMS_FUSED = False`` is still to be ported (ROADMAP queue B, item 2).
"""

from __future__ import annotations

from typing import Optional

import torch

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.ops import nms_fused


def nms_keep_sorted(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    thresh: float,
    max_keep: Optional[int] = None,
) -> torch.Tensor:
    """Batched greedy-NMS keep mask, boxes (B, K, 4) already score-sorted.

    ``max_keep``: callers that consume only the first K survivors (the
    proposal layer's ``RPN_POST_NMS_TOP_N``) pass K so the kernel stops
    early; the first K keep flags are identical either way.
    """
    if not cfg.TPU.NMS_FUSED:
        raise NotImplementedError(
            "TPU.NMS_FUSED = False selects the bitmask NMS kernel, which is "
            "not ported yet (ROADMAP queue B, item 2)"
        )
    return nms_fused.nms_keep_sorted_fused(boxes, valid, thresh, max_keep)
