"""How EAST's answers are held against the reference's: quads paired by
polygon IoU.

A merged quad or a record moves as a whole when a cell near the score
threshold (0.8) crosses it or a fold near the IoU threshold (0.2) goes the
other way: the walk then merges a run of cells differently. So a pointwise
tolerance would fail sound bfloat16 runs, and the numbers, pooled over the
sampled images, are:

* the share of quads of both sides left unpaired, in percent, when quads
  are paired one to one, greedily by IoU, at IoU >= ``iou``
  (``100 * (P + R - 2 * paired) / (P + R)``): of the merged quads
  (``merged_unpaired_pct``) and of the records (``quads_unpaired_pct``);
* the mean score gap of paired records (``quad_score_gap``);
* the mean gap of every record's eight coordinates to the record of the
  other side that overlaps it most, capped at 16 px, a record with no
  counterpart counting the cap (``quad_gap_px``).

The IoU is the reference's (``reference/east.py::quad_iou``), taken only
where the quads' axis-aligned extents meet.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from reference.east import quad_iou

CAP_PX = 16.0


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(P, Q) polygon IoU of quads (P, 8) and (Q, 8)."""
    m = np.zeros((len(a), len(b)), np.float64)
    if len(a) == 0 or len(b) == 0:
        return m
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    lo_a, hi_a = np.stack([a[:, 0::2].min(1), a[:, 1::2].min(1)], 1), np.stack(
        [a[:, 0::2].max(1), a[:, 1::2].max(1)], 1)
    lo_b, hi_b = np.stack([b[:, 0::2].min(1), b[:, 1::2].min(1)], 1), np.stack(
        [b[:, 0::2].max(1), b[:, 1::2].max(1)], 1)
    meet = np.all((lo_a[:, None] <= hi_b[None]) & (lo_b[None] <= hi_a[:, None]), -1)
    i, j = np.nonzero(meet)
    if len(i):
        m[i, j] = quad_iou(a[i], b[j])
    return m


def paired(m: np.ndarray, iou: float) -> List[Tuple[int, int]]:
    """(i, j) paired one to one, highest IoU first, at IoU >= ``iou``."""
    cand = np.argwhere(m >= iou)
    order = np.argsort(-m[cand[:, 0], cand[:, 1]], kind="stable")
    used_a, used_b, out = set(), set(), []
    for i, j in cand[order]:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            out.append((int(i), int(j)))
    return out


class QuadTally:
    """Pooled counts of one kind of quad over the sampled images, the
    score gaps of pairs and the nearest-record gaps."""

    def __init__(self, iou: float):
        self.iou = iou
        self.prog = self.ref = self.paired = 0
        self.score_gaps: List[float] = []
        self.nearest: List[float] = []

    def add(self, prog: np.ndarray, ref: np.ndarray, prog_scores=None, ref_scores=None):
        prog = np.asarray(prog, np.float64).reshape(-1, 8)
        ref = np.asarray(ref, np.float64).reshape(-1, 8)
        self.prog += len(prog)
        self.ref += len(ref)
        m = iou_matrix(prog, ref)
        pairs = paired(m, self.iou)
        self.paired += len(pairs)
        if prog_scores is not None:
            self.score_gaps += [abs(float(prog_scores[i]) - float(ref_scores[j]))
                                for i, j in pairs]
        for boxes, others, ious in ((prog, ref, m), (ref, prog, m.T)):
            for i in range(len(boxes)):
                if len(others) == 0 or ious[i].max() <= 0:
                    self.nearest.append(CAP_PX)
                    continue
                j = int(np.argmax(ious[i]))
                self.nearest.append(min(CAP_PX, float(np.abs(boxes[i] - others[j]).mean())))

    def unpaired_pct(self) -> float:
        total = self.prog + self.ref
        return 100.0 * (total - 2 * self.paired) / total if total else 0.0

    def score_gap(self) -> float:
        return float(np.mean(self.score_gaps)) if self.score_gaps else 0.0

    def nearest_gap_px(self) -> float:
        return float(np.mean(self.nearest)) if self.nearest else 0.0

    def counts(self) -> Dict[str, int]:
        return {"program": self.prog, "reference": self.ref, "paired": self.paired}


def tally(pairs, iou: float) -> Tuple[QuadTally, QuadTally]:
    """(merged quads, records) tallied over per-image pairs of the
    program's and the reference's ``(merged (k, 9) [score sum, quad],
    records (l, 9) [quad, score])``."""
    merged, recs = QuadTally(iou), QuadTally(iou)
    for (pm, pr), (rm, rr) in pairs:
        pm, rm = np.asarray(pm).reshape(-1, 9), np.asarray(rm).reshape(-1, 9)
        pr, rr = np.asarray(pr).reshape(-1, 9), np.asarray(rr).reshape(-1, 9)
        merged.add(pm[:, 1:], rm[:, 1:])
        recs.add(pr[:, :8], rr[:, :8], pr[:, 8], rr[:, 8])
    return merged, recs
