"""Vectorized text-line connector, H and O modes (port of
``ctpn_tpu.postprocess.connector``), batched over images.

The reference walks per-column Python lists
(`lib/text_connector/text_proposal_graph_builder.py`, `other.py`); here the
whole pipeline is fixed-shape tensor ops over the padded proposal set:

1. **Pairwise candidates** — "j is a successor candidate of i": vertical
   overlap >= 0.7, size similarity >= 0.7,
   0 < col_j - col_i <= MAX_HORIZONTAL_GAP.
2. **Nearest-column rule** — candidates restricted to the nearest candidate
   column (mirrored for precursors).
3. **Mutual-best edges** — best successor by score (ties -> lowest index,
   as ``np.argmax``), kept iff the source's score >= the best precursor
   score of the target. Steps 1-3 are the ``ctpn_torch::successors`` op
   (``ops/successors.py``): on the card one kernel that tests each node's
   neighbours in column order, and writes no (N, P, P) tensor.
4. **Chain membership** — every node's successor path, walked by the
   ``ctpn_torch::chain_walk`` op (``ops/chain_walk.py``) as far as
   ``2 ** ceil(log2(min(P, max_len)))`` successors: the reach of the JAX
   connector's boolean squarings of (I + S). Shared tails belong to every
   chain that reaches them, as in the reference (`other.py:16-29`).
5. **Per-chain least squares** — the walk sums each chain's features
   (x centered on the image, y, their squares and products, scores) in
   path order, in float64 rounded once to float32: the covariance form
   cancels leading digits.
6. **Records** — H mode: the axis-aligned box of the top and bottom fits,
   clipped to the image. O mode: a quadrilateral around the fitted centre
   line (half the mean proposal height + 1.25 on each side), its short
   edges shifted along the line by the slope compensation; not clipped,
   as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ctpn_tpu_torch.ops.chain_walk import chain_walk
from ctpn_tpu_torch.ops.successors import successors


class TextLines(NamedTuple):
    recs: torch.Tensor  # (N, max_lines, 9) float32 quadrilateral + score
    valid: torch.Tensor  # (N, max_lines) bool
    count: torch.Tensor  # (N,) int32


def build_successors(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    max_gap: int = 50,
    min_v_overlaps: float = 0.7,
    min_size_sim: float = 0.7,
) -> torch.Tensor:
    """(N, P) int32 successor index per node (or -1): the kept graph edges,
    from the ``ctpn_torch::successors`` op (``ops/successors.py``)."""
    return successors(boxes, scores, valid, max_gap, min_v_overlaps, min_size_sim)


def walk_steps(p: int, max_len: Optional[int] = None) -> int:
    """Successors each chain walk follows: ``2 ** rounds`` with ``rounds =
    ceil(log2(min(P, max_len)))`` (at least 1), the reach of the JAX
    connector's squarings. ``max_len`` bounds the path length: every edge
    advances >= 1 proposal column, so the image's 16-px column count is a
    valid bound."""
    bound = min(p, max_len) if max_len else p
    return 2 ** max(1, math.ceil(math.log2(max(bound, 2))))


def _fit(cnt, sx, sy, sxx, sxy):
    """Per-chain least squares of y against globally-centered x, from the
    chain sums of x, y, x*x and x*y.

    Returns (slope, mean_x, mean_y, degenerate) per row; evaluate with
    ``my + slope * (x_eval_c - mx)``. Degenerate = all member x equal (the
    reference then takes the head's y — the caller substitutes).
    """
    mx = sx / cnt
    my = sy / cnt
    sxx = sxx - cnt * mx * mx
    sxy = sxy - cnt * mx * my
    degenerate = sxx <= 1e-6
    slope = torch.where(
        degenerate, 0.0, sxy / torch.where(degenerate, 1.0, sxx)
    )
    return slope, mx, my, degenerate


def connect_text_lines(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    im_info: torch.Tensor,
    mode: str = "H",
    max_lines: int = 128,
    max_gap: int = 50,
    min_v_overlaps: float = 0.7,
    min_size_sim: float = 0.7,
    min_ratio: float = 0.5,
    line_min_score: float = 0.9,
    min_width: float = 32.0,
    max_chain_len: Optional[int] = None,
) -> TextLines:
    """Group proposals into text lines and emit 9-float records.

    boxes: (N, P, 4), scores/valid: (N, P), im_info: (N, 3) [h, w, scale].
    Records are [x0, y0, x1, y0, x0, y1, x1, y1, score] in H mode and the
    quadrilateral [xa, ya, xb, yb, xc, yc, xd, yd, score] in O mode,
    compacted in ascending head index (the reference's emission order).
    """
    if mode not in ("H", "O"):
        raise ValueError(f"mode must be 'H' or 'O', got {mode!r}")
    n, p = scores.shape
    dev = boxes.device
    succ = build_successors(
        boxes, scores, valid, max_gap, min_v_overlaps, min_size_sim
    )
    x1, y1, x2, y2 = boxes.unbind(-1)
    im_h, im_w = im_info[:, 0:1], im_info[:, 1:2]
    xbar = im_w * 0.5
    if mode == "H":
        x1c = x1 - xbar
        feats = [x1c, y1, y2, x1c * x1c, x1c * y1, x1c * y2, scores]
    else:
        cx = (x1 + x2) * 0.5
        cy = (y1 + y2) * 0.5
        cxc = cx - xbar
        feats = [cxc, cy, cxc * cxc, cxc * cy, y2 - y1, scores]
    sums, cnt, min_x1, max_x2, is_start = chain_walk(
        succ, torch.stack(feats, dim=-1), x1, x2, walk_steps(p, max_chain_len)
    )
    sums = sums.unbind(-1)
    mean_score = sums[-1] / cnt

    if mode == "H":
        slope_t, mx_t, my_t, deg_t = _fit(cnt, sums[0], sums[1], sums[3], sums[4])
        slope_b, mx_b, my_b, deg_b = _fit(cnt, sums[0], sums[2], sums[3], sums[5])
        offset = (x2 - x1) * 0.5  # head proposal half width
        x_left_c = min_x1 + offset - xbar
        x_right_c = max_x2 - offset - xbar
        lt_y = torch.where(deg_t, y1, my_t + slope_t * (x_left_c - mx_t))
        rt_y = torch.where(deg_t, y1, my_t + slope_t * (x_right_c - mx_t))
        lb_y = torch.where(deg_b, y2, my_b + slope_b * (x_left_c - mx_b))
        rb_y = torch.where(deg_b, y2, my_b + slope_b * (x_right_c - mx_b))

        # reference clips through other.clip_boxes before record assembly
        lx0 = torch.minimum(torch.clamp(min_x1, min=0.0), im_w - 1.0)
        lx1 = torch.minimum(torch.clamp(max_x2, min=0.0), im_w - 1.0)
        ly0 = torch.minimum(torch.clamp(torch.minimum(lt_y, rt_y), min=0.0), im_h - 1.0)
        ly1 = torch.minimum(torch.clamp(torch.maximum(lb_y, rb_y), min=0.0), im_h - 1.0)
        recs = torch.stack(
            [lx0, ly0, lx1, ly0, lx0, ly1, lx1, ly1, mean_score], dim=-1
        )
    else:
        k, mx_c, my_c, deg_c = _fit(cnt, sums[0], sums[1], sums[2], sums[3])
        height = sums[4] / cnt + 2.5

        def center_y(x):  # degenerate chains take the node's own centre
            return torch.where(deg_c, cy, my_c + k * (x - xbar - mx_c))

        xa, ya = min_x1, center_y(min_x1) - height / 2
        xb, yb = max_x2, center_y(max_x2) - height / 2
        xc, yc = min_x1, center_y(min_x1) + height / 2
        xd, yd = max_x2, center_y(max_x2) + height / 2
        # slope compensation: the vertical half-height projected onto the
        # centre line's direction shifts the short edges
        dis_x = xb - xa
        dis_y = yb - ya
        width = torch.clamp(torch.sqrt(dis_x * dis_x + dis_y * dis_y), min=1e-6)
        f1 = (yc - ya) * dis_y / width
        ddx = torch.abs(f1 * dis_x / width)
        ddy = torch.abs(f1 * dis_y / width)
        neg = k < 0
        recs = torch.stack([
            torch.where(neg, xa - ddx, xa), torch.where(neg, ya + ddy, ya),
            torch.where(neg, xb, xb + ddx), torch.where(neg, yb, yb + ddy),
            torch.where(neg, xc, xc - ddx), torch.where(neg, yc, yc - ddy),
            torch.where(neg, xd + ddx, xd), torch.where(neg, yd - ddy, yd),
            mean_score,
        ], dim=-1)

    # final filter (reference detectors.py:37-49)
    heights_f = (
        torch.abs(recs[..., 5] - recs[..., 1]) + torch.abs(recs[..., 7] - recs[..., 3])
    ) / 2.0 + 1.0
    widths_f = (
        torch.abs(recs[..., 2] - recs[..., 0]) + torch.abs(recs[..., 6] - recs[..., 4])
    ) / 2.0 + 1.0
    keep = (
        is_start
        & (widths_f / heights_f > min_ratio)
        & (recs[..., 8] > line_min_score)
        & (widths_f > min_width)
    )

    # compact heads (ascending head index = reference emission order)
    idx = torch.arange(p, device=dev)
    order = torch.sort(torch.where(keep, idx, p + idx), dim=1).indices
    if max_lines > p:  # fewer proposals than line slots: pad gather indices
        order = torch.cat([order, order.new_zeros((n, max_lines - p))], dim=1)
    order = order[:, :max_lines]
    cnt_lines = torch.clamp(keep.sum(dim=1), max=max_lines).to(torch.int32)
    slot_valid = torch.arange(max_lines, device=dev)[None] < cnt_lines[:, None]
    gathered = torch.gather(recs, 1, order[..., None].expand(-1, -1, 9))
    out = torch.where(slot_valid[..., None], gathered, 0.0)
    return TextLines(recs=out.float(), valid=slot_valid, count=cnt_lines)
