"""Proposals and text lines in NumPy: the reference.

For one image, from the network's (H, W, A) foreground probabilities and
(H, W, A*4) deltas on the padded bucket:

* the proposal layer (eragonruan/text-detection-ctpn
  ``lib/rpn_msr/proposal_layer_tf.py``): anchors of width 16 and ten
  heights per 16-px cell, the y/h-only decode, clipping to the image's
  extent inside the bucket, the min-size test, cells outside the extent
  dropped, the top ``RPN_PRE_NMS_TOP_N`` by score, greedy NMS at
  ``RPN_NMS_THRESH`` (+1-px areas, suppress at IoU >= thresh), the first
  ``RPN_POST_NMS_TOP_N`` kept;
* the detector (``lib/text_connector/detectors.py``): proposals scoring
  over ``TEXT_PROPOSALS_MIN_SCORE``, NMS at ``TEXT_PROPOSALS_NMS_THRESH``,
  the H-mode connector (``text_proposal_graph_builder.py``,
  ``text_proposal_connector.py``) and the final line filter.

Straightforward loops, float64 where the geometry allows; nothing of the
program is imported.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def anchors(feat_h: int, feat_w: int, heights, width: int, stride: int) -> np.ndarray:
    """(H*W*A, 4) anchors, row ((h * W) + w) * A + a, int-truncated around
    the 16x16 base cell's centre 7.5 (``generate_anchors.py``)."""
    ctr = (stride - 1) * 0.5
    base = np.array([[int(ctr - width / 2.0), int(ctr - h / 2.0),
                      int(ctr + width / 2.0), int(ctr + h / 2.0)] for h in heights],
                    np.float32)
    ys, xs = np.meshgrid(np.arange(feat_h) * stride, np.arange(feat_w) * stride,
                         indexing="ij")
    shifts = np.stack([xs, ys, xs, ys], -1).reshape(-1, 1, 4).astype(np.float32)
    return (shifts + base[None]).reshape(-1, 4)


def greedy_nms(boxes: np.ndarray, thresh: float, cap: int = 0) -> Tuple[List[int], int]:
    """Greedy NMS over score-sorted (K, 4) boxes. Returns the kept indices
    (at most ``cap`` when ``cap`` > 0) and the IoU pair tests greedy NMS
    needs: each candidate visited against the boxes kept before it."""
    b = boxes.astype(np.float64)
    areas = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    alive = np.ones(len(b), bool)
    keep: List[int] = []
    tests = 0
    for i in range(len(b)):
        if cap and len(keep) >= cap:
            break
        tests += len(keep)
        if not alive[i]:
            continue
        keep.append(i)
        rest = np.flatnonzero(alive[i + 1:]) + i + 1
        if rest.size == 0:
            continue
        w = np.maximum(0.0, np.minimum(b[i, 2], b[rest, 2])
                       - np.maximum(b[i, 0], b[rest, 0]) + 1)
        h = np.maximum(0.0, np.minimum(b[i, 3], b[rest, 3])
                       - np.maximum(b[i, 1], b[rest, 1]) + 1)
        inter = w * h
        iou = inter / (areas[i] + areas[rest] - inter)
        alive[rest[iou >= thresh]] = False
    return keep, tests


def proposals(prob: np.ndarray, deltas: np.ndarray, im_info, model_cfg: dict,
              test_cfg: dict) -> Tuple[np.ndarray, int, int]:
    """(M, 5) [score, x1, y1, x2, y2] proposals, score-sorted, of one image
    of the padded bucket; with the candidates' count and the pair tests of
    the NMS."""
    fh, fw, a = prob.shape
    stride = model_cfg["feat_stride"]
    anc = anchors(fh, fw, model_cfg["anchor_heights"], model_cfg["anchor_width"], stride)
    scores = prob.reshape(-1).astype(np.float32)
    d = deltas.reshape(-1, 4).astype(np.float32)
    aw = anc[:, 2] - anc[:, 0] + 1.0
    ah = anc[:, 3] - anc[:, 1] + 1.0
    cx = anc[:, 0] + 0.5 * aw
    cy = anc[:, 1] + 0.5 * ah
    pcy = d[:, 1] * ah + cy
    ph = np.exp(d[:, 3]) * ah
    boxes = np.stack([cx - 0.5 * aw, pcy - 0.5 * ph, cx + 0.5 * aw, pcy + 0.5 * ph], 1)
    im_h, im_w, scale = (float(v) for v in im_info)
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, im_w - 1)
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, im_h - 1)
    ws = boxes[:, 2] - boxes[:, 0] + 1
    hs = boxes[:, 3] - boxes[:, 1] + 1
    min_sz = test_cfg["RPN_MIN_SIZE"] * scale
    idx = np.arange(len(scores))
    cell_y = (idx // (fw * a)) * stride
    cell_x = ((idx // a) % fw) * stride
    valid = (ws >= min_sz) & (hs >= min_sz) & (cell_y < im_h) & (cell_x < im_w)
    key = np.where(valid, scores, -np.inf)
    order = np.argsort(key, kind="stable")[::-1][:test_cfg["RPN_PRE_NMS_TOP_N"]]
    order = order[valid[order]]
    keep, tests = greedy_nms(boxes[order], test_cfg["RPN_NMS_THRESH"],
                             cap=test_cfg["RPN_POST_NMS_TOP_N"])
    sel = order[keep]
    return np.concatenate([scores[sel, None], boxes[sel]], 1), len(order), tests


# ------------------------------------------------------------- connector


def _v_iou_ok(boxes, heights, i, j, text_cfg) -> bool:
    h1, h2 = heights[i], heights[j]
    y0 = max(boxes[i, 1], boxes[j, 1])
    y1 = min(boxes[i, 3], boxes[j, 3])
    overlap = max(0.0, y1 - y0 + 1) / min(h1, h2)
    sim = min(h1, h2) / max(h1, h2)
    return overlap >= text_cfg["MIN_V_OVERLAPS"] and sim >= text_cfg["MIN_SIZE_SIM"]


def _graph(boxes, scores, im_w: int, text_cfg) -> np.ndarray:
    n = len(boxes)
    heights = boxes[:, 3] - boxes[:, 1] + 1
    table: List[List[int]] = [[] for _ in range(im_w)]
    for i in range(n):
        table[int(boxes[i, 0])].append(i)
    gap = text_cfg["MAX_HORIZONTAL_GAP"]

    def successions(i):
        for col in range(int(boxes[i, 0]) + 1, min(int(boxes[i, 0]) + gap + 1, im_w)):
            res = [j for j in table[col] if _v_iou_ok(boxes, heights, j, i, text_cfg)]
            if res:
                return res
        return []

    def precursors(j):
        for col in range(int(boxes[j, 0]) - 1, max(int(boxes[j, 0]) - gap, 0) - 1, -1):
            res = [i for i in table[col] if _v_iou_ok(boxes, heights, i, j, text_cfg)]
            if res:
                return res
        return []

    graph = np.zeros((n, n), bool)
    for i in range(n):
        succ = successions(i)
        if not succ:
            continue
        j = succ[int(np.argmax(scores[succ]))]
        if scores[i] >= np.max(scores[precursors(j)]):
            graph[i, j] = True
    return graph


def _chains(graph: np.ndarray) -> List[List[int]]:
    out = []
    for s in range(graph.shape[0]):
        if not graph[:, s].any() and graph[s, :].any():
            chain, v = [s], s
            while graph[v, :].any():
                v = int(np.flatnonzero(graph[v, :])[0])
                chain.append(v)
            out.append(chain)
    return out


def _fit(xs, ys, x1, x2):
    if np.all(xs == xs[0]):
        return ys[0], ys[0]
    p = np.poly1d(np.polyfit(xs, ys, 1))
    return p(x1), p(x2)


def text_lines(props: np.ndarray, im_info, text_cfg: dict) -> np.ndarray:
    """(L, 9) H-mode line records [x0,y0,x1,y0,x0,y1,x1,y1,score] from the
    (M, 5) proposals, in the padded bucket's pixels."""
    scores, boxes = props[:, 0].astype(np.float64), props[:, 1:5].astype(np.float64)
    keep = scores > text_cfg["TEXT_PROPOSALS_MIN_SCORE"]
    boxes, scores = boxes[keep], scores[keep]
    order = np.argsort(scores, kind="stable")[::-1]
    boxes, scores = boxes[order], scores[order]
    kept, _ = greedy_nms(boxes, text_cfg["TEXT_PROPOSALS_NMS_THRESH"])
    boxes, scores = boxes[kept], scores[kept]
    if len(boxes) == 0:
        return np.zeros((0, 9))
    im_h, im_w = float(im_info[0]), float(im_info[1])
    recs = []
    for members in _chains(_graph(boxes, scores, int(im_w), text_cfg)):
        b = boxes[members]
        x0, x1 = b[:, 0].min(), b[:, 2].max()
        off = (b[0, 2] - b[0, 0]) * 0.5
        lt, rt = _fit(b[:, 0], b[:, 1], x0 + off, x1 - off)
        lb, rb = _fit(b[:, 0], b[:, 3], x0 + off, x1 - off)
        score = scores[members].sum() / float(len(members))
        y0, y1 = min(lt, rt), max(lb, rb)
        x0, x1 = np.clip([x0, x1], 0, im_w - 1)
        y0, y1 = np.clip([y0, y1], 0, im_h - 1)
        recs.append([x0, y0, x1, y0, x0, y1, x1, y1, score])
    recs = np.asarray(recs, np.float64).reshape(-1, 9)
    height = (np.abs(recs[:, 5] - recs[:, 1]) + np.abs(recs[:, 7] - recs[:, 3])) / 2 + 1
    width = (np.abs(recs[:, 2] - recs[:, 0]) + np.abs(recs[:, 6] - recs[:, 4])) / 2 + 1
    ok = ((width / height > text_cfg["MIN_RATIO"])
          & (recs[:, 8] > text_cfg["LINE_MIN_SCORE"])
          & (width > text_cfg["TEXT_PROPOSALS_WIDTH"] * text_cfg["MIN_NUM_PROPOSALS"]))
    return recs[ok]

