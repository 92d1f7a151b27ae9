"""Host (NumPy) text-connector oracle.

The port's own copy of ``ctpn_tpu.postprocess.oracle``; it reads the port's
config (``ctpn_tpu_torch.config.cfg``).

Fresh implementation of the reference's text-line grouping semantics, used as
the test oracle for the vectorized on-device connector and as a host fallback
path. Contracts implemented (file:line into the reference repository):

* graph building — nearest-column successor search within
  ``MAX_HORIZONTAL_GAP``, vertical-IoU >= ``MIN_V_OVERLAPS``, size-similarity
  >= ``MIN_SIZE_SIM``, mutual-best edge by score
  (`lib/text_connector/text_proposal_graph_builder.py:10-78`);
* chain walking from head nodes (no in-edge, has out-edge)
  (`lib/text_connector/other.py:16-29`);
* H-mode line fitting — least-squares of top/bottom edges evaluated at
  x-extent ± half-proposal-width, axis-aligned 9-float records
  (`lib/text_connector/text_proposal_connector.py:13-64`);
* O-mode — center-line fit, mean height + 2.5, slope-compensated rotated
  quadrilateral (`lib/text_connector/text_proposal_connector_oriented.py:24-105`);
* detector facade — score > 0.7 filter, sort, NMS 0.2, connect,
  width/height/score line filter (`lib/text_connector/detectors.py:19-49`).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.utils.host_ref import py_nms


def _meet_v_iou(boxes: np.ndarray, heights: np.ndarray, i: int, j: int) -> bool:
    h1, h2 = heights[i], heights[j]
    y0 = max(boxes[i, 1], boxes[j, 1])
    y1 = min(boxes[i, 3], boxes[j, 3])
    overlap = max(0.0, y1 - y0 + 1) / min(h1, h2)
    sim = min(h1, h2) / max(h1, h2)
    return overlap >= cfg.TEXT.MIN_V_OVERLAPS and sim >= cfg.TEXT.MIN_SIZE_SIM


def build_graph_np(boxes: np.ndarray, scores: np.ndarray, im_size) -> np.ndarray:
    """(N, N) bool adjacency of kept mutual-best successor edges."""
    n = len(boxes)
    heights = boxes[:, 3] - boxes[:, 1] + 1
    im_w = int(im_size[1])
    table: List[List[int]] = [[] for _ in range(im_w)]
    for idx in range(n):
        table[int(boxes[idx, 0])].append(idx)

    max_gap = cfg.TEXT.MAX_HORIZONTAL_GAP

    def successions(i):
        res = []
        for col in range(int(boxes[i, 0]) + 1, min(int(boxes[i, 0]) + max_gap + 1, im_w)):
            for j in table[col]:
                if _meet_v_iou(boxes, heights, j, i):
                    res.append(j)
            if res:
                return res
        return res

    def precursors(j):
        res = []
        for col in range(int(boxes[j, 0]) - 1, max(int(boxes[j, 0]) - max_gap, 0) - 1, -1):
            for i in table[col]:
                if _meet_v_iou(boxes, heights, i, j):
                    res.append(i)
            if res:
                return res
        return res

    graph = np.zeros((n, n), dtype=bool)
    for i in range(n):
        succs = successions(i)
        if not succs:
            continue
        j = succs[int(np.argmax(scores[succs]))]
        if scores[i] >= np.max(scores[precursors(j)]):
            graph[i, j] = True
    return graph


def sub_graphs_np(graph: np.ndarray) -> List[List[int]]:
    """Chains walked from head nodes (no in-edge, has out-edge)."""
    out = []
    for idx in range(graph.shape[0]):
        if not graph[:, idx].any() and graph[idx, :].any():
            v = idx
            chain = [v]
            while graph[v, :].any():
                v = int(np.flatnonzero(graph[v, :])[0])
                chain.append(v)
            out.append(chain)
    return out


def _fit_y(X, Y, x1, x2):
    if np.all(X == X[0]):
        return Y[0], Y[0]
    p = np.poly1d(np.polyfit(X, Y, 1))
    return p(x1), p(x2)


def _clip_lines(lines: np.ndarray, im_size) -> np.ndarray:
    lines[:, 0::2] = np.clip(lines[:, 0::2], 0, im_size[1] - 1)
    lines[:, 1::2] = np.clip(lines[:, 1::2], 0, im_size[0] - 1)
    return lines


def get_text_lines_h_np(boxes, scores, im_size) -> np.ndarray:
    """(M, 9) axis-aligned text-line records (H mode)."""
    groups = sub_graphs_np(build_graph_np(boxes, scores, im_size))
    lines = np.zeros((len(groups), 5), np.float32)
    for g, members in enumerate(groups):
        tlb = boxes[members]
        x0 = np.min(tlb[:, 0])
        x1 = np.max(tlb[:, 2])
        offset = (tlb[0, 2] - tlb[0, 0]) * 0.5
        lt_y, rt_y = _fit_y(tlb[:, 0], tlb[:, 1], x0 + offset, x1 - offset)
        lb_y, rb_y = _fit_y(tlb[:, 0], tlb[:, 3], x0 + offset, x1 - offset)
        score = scores[members].sum() / float(len(members))
        lines[g] = [x0, min(lt_y, rt_y), x1, max(lb_y, rb_y), score]
    lines = _clip_lines(lines, im_size)
    recs = np.zeros((len(lines), 9), np.float64)
    for g, (xmin, ymin, xmax, ymax, score) in enumerate(lines):
        recs[g] = [xmin, ymin, xmax, ymin, xmin, ymax, xmax, ymax, score]
    return recs


def get_text_lines_o_np(boxes, scores, im_size) -> np.ndarray:
    """(M, 9) oriented quadrilateral records (O mode)."""
    groups = sub_graphs_np(build_graph_np(boxes, scores, im_size))
    recs = np.zeros((len(groups), 9), np.float64)
    for g, members in enumerate(groups):
        tlb = boxes[members]
        X = (tlb[:, 0] + tlb[:, 2]) / 2
        Y = (tlb[:, 1] + tlb[:, 3]) / 2
        z1 = np.polyfit(X, Y, 1)
        x0 = np.min(tlb[:, 0])
        x1 = np.max(tlb[:, 2])
        offset = (tlb[0, 2] - tlb[0, 0]) * 0.5
        lt_y, rt_y = _fit_y(tlb[:, 0], tlb[:, 1], x0 + offset, x1 - offset)
        lb_y, rb_y = _fit_y(tlb[:, 0], tlb[:, 3], x0 + offset, x1 - offset)
        score = scores[members].sum() / float(len(members))
        height = np.mean(tlb[:, 3] - tlb[:, 1]) + 2.5
        k, b = z1[0], z1[1]
        b_top = b - height / 2
        b_bot = b + height / 2
        xa, ya = x0, k * x0 + b_top
        xb, yb = x1, k * x1 + b_top
        xc, yc = x0, k * x0 + b_bot
        xd, yd = x1, k * x1 + b_bot
        # slope compensation: project the vertical half-height onto the
        # fitted center line's direction to shift the short edges
        run = xb - xa
        rise = yb - ya
        width = np.sqrt(run * run + rise * rise)
        proj = (yc - ya) * rise / width
        dx = np.fabs(proj * run / width)
        dy = np.fabs(proj * rise / width)
        if k < 0:
            xa -= dx
            ya += dy
            xd += dx
            yd -= dy
        else:
            xb += dx
            yb += dy
            xc -= dx
            yc -= dy
        recs[g] = [xa, ya, xb, yb, xc, yc, xd, yd, score]
    return recs


def filter_lines_np(recs: np.ndarray) -> np.ndarray:
    """Indices of lines passing the detector's final filter."""
    if len(recs) == 0:
        return np.zeros(0, dtype=np.int64)
    heights = (np.abs(recs[:, 5] - recs[:, 1]) + np.abs(recs[:, 7] - recs[:, 3])) / 2.0 + 1
    widths = (np.abs(recs[:, 2] - recs[:, 0]) + np.abs(recs[:, 6] - recs[:, 4])) / 2.0 + 1
    scores = recs[:, 8]
    return np.flatnonzero(
        (widths / heights > cfg.TEXT.MIN_RATIO)
        & (scores > cfg.TEXT.LINE_MIN_SCORE)
        & (widths > cfg.TEXT.TEXT_PROPOSALS_WIDTH * cfg.TEXT.MIN_NUM_PROPOSALS)
    )


def detect_np(text_proposals: np.ndarray, scores: np.ndarray, size, mode=None) -> np.ndarray:
    """Full host detector facade (reference `detectors.py:19-35`)."""
    mode = mode or cfg.TEST.DETECT_MODE
    keep = np.flatnonzero(scores > cfg.TEXT.TEXT_PROPOSALS_MIN_SCORE)
    boxes, sc = text_proposals[keep], scores[keep]
    order = sc.ravel().argsort(kind="stable")[::-1]
    boxes, sc = boxes[order], sc[order]
    keep = py_nms(
        np.hstack([boxes, sc[:, None]]).astype(np.float32),
        cfg.TEXT.TEXT_PROPOSALS_NMS_THRESH,
    )
    boxes, sc = boxes[keep], sc[keep]
    if len(boxes) == 0:
        return np.zeros((0, 9))
    if mode == "H":
        recs = get_text_lines_h_np(boxes, sc, size)
    else:
        recs = get_text_lines_o_np(boxes, sc, size)
    return recs[filter_lines_np(recs)]
