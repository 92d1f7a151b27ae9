"""Vectorized text-line connector, H mode (port of
``ctpn_tpu.postprocess.connector``), batched over images.

The reference walks per-column Python lists
(`lib/text_connector/text_proposal_graph_builder.py`, `other.py`); here the
whole pipeline is fixed-shape tensor ops over the padded proposal set:

1. **Pairwise candidates** — (N, P, P) "j is a successor candidate of i":
   vertical overlap >= 0.7, size similarity >= 0.7,
   0 < col_j - col_i <= MAX_HORIZONTAL_GAP.
2. **Nearest-column rule** — candidates restricted to the nearest candidate
   column (mirrored for precursors).
3. **Mutual-best edges** — best successor by score (ties -> lowest index,
   as ``np.argmax``), kept iff the source's score >= the best precursor
   score of the target.
4. **Chain membership** — the successor-path reachability matrix R[s, j]
   by boolean squarings of (I + S); shared tails belong to every chain
   that reaches them, as in the reference (`other.py:16-29`).
5. **Per-chain least squares** — chain sums are rows of ``R @ F``; x is
   centered on the image before squaring. These matmuls run in true f32
   (TF32 off): the covariance form cancels leading digits.

The oriented (``mode="O"``) connector is not ported yet (ROADMAP A7).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Tuple

import torch


class TextLines(NamedTuple):
    recs: torch.Tensor  # (N, max_lines, 9) float32 quadrilateral + score
    valid: torch.Tensor  # (N, max_lines) bool
    count: torch.Tensor  # (N,) int32


@contextlib.contextmanager
def _full_f32_matmul():
    """Float32 matmuls in full precision on the card (no TF32), restored
    on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _pairwise_candidates(
    boxes, valid, max_gap, min_v_overlaps, min_size_sim
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, P, P) bool: j is a successor candidate of i; and (N, P) columns."""
    y1, y2 = boxes[..., 1], boxes[..., 3]
    h = y2 - y1 + 1.0
    col = torch.floor(boxes[..., 0]).to(torch.int32)

    inter = (
        torch.minimum(y2[:, :, None], y2[:, None, :])
        - torch.maximum(y1[:, :, None], y1[:, None, :])
        + 1.0
    )
    min_h = torch.minimum(h[:, :, None], h[:, None, :])
    max_h = torch.maximum(h[:, :, None], h[:, None, :])
    v_ov = torch.clamp(inter, min=0.0) / min_h
    sim = min_h / max_h
    meet = (v_ov >= min_v_overlaps) & (sim >= min_size_sim)

    dcol = col[:, None, :] - col[:, :, None]  # col_j - col_i
    pairv = valid[:, :, None] & valid[:, None, :]
    return meet & pairv & (dcol > 0) & (dcol <= max_gap), col


def build_successors(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    max_gap: int = 50,
    min_v_overlaps: float = 0.7,
    min_size_sim: float = 0.7,
) -> torch.Tensor:
    """(N, P) int32 successor index per node (or -1): the kept graph edges."""
    cand, col = _pairwise_candidates(
        boxes, valid, max_gap, min_v_overlaps, min_size_sim
    )
    big = 1 << 30
    neg_inf = torch.tensor(-float("inf"), device=boxes.device)

    # successor side: restrict to nearest candidate column of i
    cand_col = torch.where(cand, col[:, None, :], big)
    min_col = cand_col.min(dim=2).values
    succ_sel = cand & (col[:, None, :] == min_col[:, :, None])
    has_succ = succ_sel.any(dim=2)
    succ_scores = torch.where(succ_sel, scores[:, None, :], neg_inf)
    best_j = torch.argmax(succ_scores, dim=2)  # ties -> lowest index

    # precursor side: restrict to nearest candidate column of j (from below)
    prec_col = torch.where(cand, col[:, :, None], -big)
    max_col = prec_col.max(dim=1).values
    prec_sel = cand & (col[:, :, None] == max_col[:, None, :])
    prec_scores = torch.where(prec_sel, scores[:, :, None], neg_inf)
    prec_best = prec_scores.max(dim=1).values

    edge = has_succ & (scores >= torch.gather(prec_best, 1, best_j))
    return torch.where(edge, best_j, -1).to(torch.int32)


def chain_reachability(
    succ: torch.Tensor, max_len: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Successor-path reachability: R[s, j] = 1 iff j is on the path
    s -> succ[s] -> ... (inclusive of s), by
    ``ceil(log2(min(P, max_len)))`` boolean squarings of (I + S).

    Returns (R float32 (N, P, P), is_start bool (N, P)); start nodes have an
    out-edge and no in-edge, one emitted line per start row. ``max_len``
    bounds the path length: every edge advances >= 1 proposal column, so
    the image's 16-px column count is a valid bound.
    """
    p = succ.shape[1]
    idx = torch.arange(p, device=succ.device)
    has_out = succ >= 0
    edge = (succ[:, :, None] == idx) & has_out[:, :, None]
    has_in = edge.any(dim=1)
    m = (edge | torch.eye(p, dtype=torch.bool, device=succ.device)).float()
    bound = min(p, max_len) if max_len else p
    rounds = max(1, math.ceil(math.log2(max(bound, 2))))
    # 0/1 operands and integer sums < 2^24: exact in any matmul precision
    for _ in range(rounds):
        m = (torch.bmm(m, m) > 0.0).float()
    return m, has_out & ~has_in


def _rowdot(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(N, P, P) @ (N, P) -> (N, P)."""
    return torch.bmm(r, v[..., None])[..., 0]


def _fit(r, cnt, xc, y):
    """Per-chain least squares of y against globally-centered x.

    Returns (slope, mean_x, mean_y, degenerate) per row; evaluate with
    ``my + slope * (x_eval_c - mx)``. Degenerate = all member x equal (the
    reference then takes the head's y — the caller substitutes).
    """
    mx = _rowdot(r, xc) / cnt
    my = _rowdot(r, y) / cnt
    sxx = _rowdot(r, xc * xc) - cnt * mx * mx
    sxy = _rowdot(r, xc * y) - cnt * mx * my
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
    Records are [x0, y0, x1, y0, x0, y1, x1, y1, score], compacted in
    ascending head index (the reference's emission order).
    """
    if mode != "H":
        raise NotImplementedError(
            f"connector mode {mode!r}: only 'H' is ported (O mode is "
            "ROADMAP A7)"
        )
    n, p = scores.shape
    dev = boxes.device
    with _full_f32_matmul():
        succ = build_successors(
            boxes, scores, valid, max_gap, min_v_overlaps, min_size_sim
        )
        r, is_start = chain_reachability(succ, max_chain_len)

        x1, y1, x2, y2 = boxes.unbind(-1)
        im_h, im_w = im_info[:, 0:1], im_info[:, 1:2]
        cnt = torch.clamp(r.sum(dim=2), min=1.0)
        xbar = im_w * 0.5
        x1c = x1 - xbar
        member = r > 0.0
        inf = torch.tensor(float("inf"), device=dev)
        min_x1 = torch.where(member, x1[:, None, :], inf).min(dim=2).values
        max_x2 = torch.where(member, x2[:, None, :], -inf).max(dim=2).values
        mean_score = _rowdot(r, scores) / cnt

        offset = (x2 - x1) * 0.5  # head proposal half width
        slope_t, mx_t, my_t, deg_t = _fit(r, cnt, x1c, y1)
        slope_b, mx_b, my_b, deg_b = _fit(r, cnt, x1c, y2)

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
