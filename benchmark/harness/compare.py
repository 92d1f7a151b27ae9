"""How the program's answers are held against the reference's.

Lines and proposals are boxes whose edges move in whole anchor columns when
a score near a threshold moves: one more proposal over 0.7 widens a line by
16 px, one less splits it. So a pointwise tolerance would fail every sound
bfloat16 run. The numbers, pooled over the sampled images, are instead:

* the share of boxes of both sides left unpaired, in percent, when boxes
  are paired one-to-one, greedily by IoU, at IoU >= ``iou``
  (``100 * (P + R - 2 * paired) / (P + R)``);
* the mean gap of paired boxes' scores, and of their four edges in pixels;
* the mean gap of every box's edges to the box of the other side that
  overlaps it most, capped at 16 px (one anchor column), a box with no
  counterpart counting the cap (:func:`nearest_gaps`).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np


def hull(recs: np.ndarray) -> np.ndarray:
    """(L, 9) records -> (L, 4) axis-aligned boxes [x0, y0, x1, y1]."""
    recs = np.asarray(recs, np.float64).reshape(-1, 9)
    xs, ys = recs[:, 0:8:2], recs[:, 1:8:2]
    return np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], 1)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(P, Q) IoU of boxes with +1-px areas."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    iw = np.minimum(a[:, None, 2], b[None, :, 2]) - np.maximum(a[:, None, 0], b[None, :, 0]) + 1
    ih = np.minimum(a[:, None, 3], b[None, :, 3]) - np.maximum(a[:, None, 1], b[None, :, 1]) + 1
    inter = np.maximum(iw, 0) * np.maximum(ih, 0)
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def paired(a: np.ndarray, b: np.ndarray, iou: float) -> List[Tuple[int, int]]:
    """(i, j) of boxes paired one-to-one, highest IoU first, at IoU >= ``iou``."""
    m = iou_matrix(a, b)
    if m.size == 0:
        return []
    cand = np.argwhere(m >= iou)
    order = np.argsort(-m[cand[:, 0], cand[:, 1]], kind="stable")
    used_a, used_b, out = set(), set(), []
    for i, j in cand[order]:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            out.append((int(i), int(j)))
    return out


def nearest_gaps(a: np.ndarray, b: np.ndarray, cap: float) -> List[float]:
    """For every box of either side, the mean gap of its four edges to the
    box of the other side that overlaps it most, at most ``cap`` pixels;
    ``cap`` where nothing overlaps it. A box that one side adds or leaves
    out counts, as does one that moved."""
    m = iou_matrix(a, b)
    out = []
    for boxes, others, ious in ((a, b, m), (b, a, m.T)):
        for i in range(len(boxes)):
            if len(others) == 0 or ious[i].max() <= 0:
                out.append(cap)
                continue
            j = int(np.argmax(ious[i]))
            out.append(min(cap, float(np.abs(boxes[i] - others[j]).mean())))
    return out


class Tally:
    """Pooled counts of one kind of box over the sampled images, and the
    gaps between paired boxes: of their scores, and of their four edges in
    pixels (the mean over the pairs)."""

    def __init__(self, iou: float, cap_px: float = 16.0):
        self.iou = iou
        self.cap_px = cap_px
        self.prog = self.ref = self.paired = 0
        self.score_gaps: List[float] = []
        self.edge_gaps: List[float] = []
        self.nearest_gaps: List[float] = []

    def add(self, prog_boxes: np.ndarray, ref_boxes: np.ndarray,
            prog_scores=None, ref_scores=None) -> None:
        self.prog += len(prog_boxes)
        self.ref += len(ref_boxes)
        self.nearest_gaps += nearest_gaps(prog_boxes, ref_boxes, self.cap_px)
        pairs = paired(prog_boxes, ref_boxes, self.iou)
        self.paired += len(pairs)
        for i, j in pairs:
            self.edge_gaps.append(float(np.abs(prog_boxes[i] - ref_boxes[j]).mean()))
            if prog_scores is not None:
                self.score_gaps.append(abs(float(prog_scores[i]) - float(ref_scores[j])))

    def unpaired_pct(self) -> float:
        total = self.prog + self.ref
        return 100.0 * (total - 2 * self.paired) / total if total else 0.0

    def edge_gap_px(self) -> float:
        return float(np.mean(self.edge_gaps)) if self.edge_gaps else 0.0

    def nearest_gap_px(self) -> float:
        return float(np.mean(self.nearest_gaps)) if self.nearest_gaps else 0.0

    def score_gap(self) -> float:
        return float(np.mean(self.score_gaps)) if self.score_gaps else 0.0

    def counts(self) -> Dict[str, int]:
        return {"program": self.prog, "reference": self.ref, "paired": self.paired}


def detector_props(props: np.ndarray, min_score: float) -> np.ndarray:
    """The proposals the detector takes: (M, 5) [score, box] rows over
    ``min_score``."""
    props = np.asarray(props, np.float64).reshape(-1, 5)
    return props[props[:, 0] > min_score]


def tally_props(pairs: Iterable[Tuple[np.ndarray, np.ndarray]], iou: float,
                min_score: float) -> Tally:
    t = Tally(iou)
    for prog, ref in pairs:
        p, r = detector_props(prog, min_score), detector_props(ref, min_score)
        t.add(p[:, 1:5], r[:, 1:5], p[:, 0], r[:, 0])
    return t


def tally_lines(pairs: Iterable[Tuple[np.ndarray, np.ndarray]], iou: float) -> Tally:
    t = Tally(iou)
    for prog, ref in pairs:
        prog = np.asarray(prog, np.float64).reshape(-1, 9)
        ref = np.asarray(ref, np.float64).reshape(-1, 9)
        t.add(hull(prog), hull(ref), prog[:, 8], ref[:, 8])
    return t
