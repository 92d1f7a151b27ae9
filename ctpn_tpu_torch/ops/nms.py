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
  words; :func:`nms_fixed_point_blocked` resolves the greedy keep set from
  them in plain PyTorch (it is jnp in the JAX package, not Pallas).

Greedy keep is the unique solution of ``keep[i] = valid[i] and not
any(keep[j] and bit(j, i) for j < i)``. The resolve iterates it from
"all valid" until nothing changes. Each sweep asks the host once, for the
whole batch, whether anything changed: that is one device-to-host sync per
sweep, counted in ``nms_fixed_point.SWEEPS`` and
``nms_fixed_point_blocked.SWEEPS``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.ops import nms_bitmask, nms_fused

BITS = nms_bitmask.BITS


def or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR of ``x`` over ``dim`` (PyTorch has no OR reduction): a
    halving tree of ``bitwise_or``. ``x.shape[dim]`` must be positive."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        half = n // 2
        y = x.narrow(dim, 0, half) | x.narrow(dim, half, half)
        if n % 2:
            y = torch.cat([y, x.narrow(dim, n - 1, 1)], dim)
        x = y
    return x.squeeze(dim)


def _bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """(B, W) int32 words -> (B, n) bool, bit k of word w = column 32w+k."""
    idx = torch.arange(n, device=words.device)
    shift = (idx % BITS).to(torch.int32)
    return ((words[:, idx // BITS] >> shift) & 1) != 0


def nms_fixed_point(mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Resolve the greedy keep set from a suppression bitmask.

    mask: (B, N, W) int32, row i's bits = boxes i suppresses (all j > i);
    valid: (B, N) bool. Returns keep (B, N) bool in the same (sorted)
    order. Every sweep ORs the whole mask under the active rows.
    """
    n = mask.shape[1]
    active = valid
    for _ in range(n):
        supp = or_reduce(torch.where(active[..., None], mask, 0), 1)
        new = valid & ~_bits(supp, n)
        nms_fixed_point.SWEEPS += 1
        changed = bool((new != active).any())  # one host sync per sweep
        active = new
        if not changed:
            break
    return active


nms_fixed_point.SWEEPS = 0


def nms_fixed_point_blocked(
    mask: torch.Tensor, valid: torch.Tensor, block: int = 1024
) -> torch.Tensor:
    """Block-sequential greedy resolve: each mask row is read once.

    Boxes are taken in score-ordered blocks. A small fixed point over the
    block's own columns resolves it exactly (suppression from earlier blocks
    arrives through the accumulated word vector); then the kept rows' masks
    fold into that vector. Same output as :func:`nms_fixed_point`.
    """
    if block % BITS or block < BITS:
        raise ValueError(f"block must be a positive multiple of {BITS}, got {block}")
    batch, n, words = mask.shape
    supp = mask.new_zeros((batch, words))
    keep = torch.zeros_like(valid)
    bw = block // BITS
    for r0 in range(0, n, block):
        rows = mask[:, r0:r0 + block]  # (B, r, W)
        r = rows.shape[1]
        w0, lw = r0 // BITS, nms_bitmask.num_words(r)
        base = valid[:, r0:r0 + r] & ~_bits(supp[:, w0:w0 + lw], r)
        local = rows[:, :, w0:w0 + lw]
        active = base
        for _ in range(r):
            sw = or_reduce(torch.where(active[..., None], local, 0), 1)
            new = base & ~_bits(sw, r)
            nms_fixed_point_blocked.SWEEPS += 1
            changed = bool((new != active).any())  # one host sync per sweep
            active = new
            if not changed:
                break
        keep[:, r0:r0 + r] = active
        if r0 + block < n:  # later blocks read columns from w0 + bw on
            fold = or_reduce(torch.where(active[..., None], rows[:, :, w0 + bw:], 0), 1)
            supp[:, w0 + bw:] |= fold
    return keep


nms_fixed_point_blocked.SWEEPS = 0


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
    return nms_fixed_point_blocked(mask, valid)


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
