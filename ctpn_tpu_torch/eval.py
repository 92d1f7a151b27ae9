"""Evaluation: box-level agreement between result sets.

The port's own copy of ``ctpn_tpu.eval`` (NumPy only); console script
``ctpn-torch-eval CANDIDATE_DIR REFERENCE_DIR [--iou 0.5]``.

The reference publishes no metrics and ships only golden outputs
(`data/results/res_*.txt`, SURVEY.md §6). This module implements the
box-level agreement measure the parity gate is defined in (>= 99.5%
agreement vs the reference outputs): greedy IoU matching of line boxes
between two `res_*.txt` directories, reporting precision/recall/F-measure
of the candidate set against the reference set.

``res_*.txt`` format (reference `demo.py:44-51`): one line per text box,
``min_x,min_y,max_x,max_y`` integers, CRLF-terminated.
"""

from __future__ import annotations

import glob
import os.path as osp
from typing import Dict

import numpy as np


def read_res_txt(path: str) -> np.ndarray:
    boxes = []
    with open(path) as f:
        for line in f:
            parts = [p for p in line.strip().replace("\r", "").split(",") if p]
            if len(parts) >= 4:
                boxes.append([float(v) for v in parts[:4]])
    return np.asarray(boxes, dtype=np.float64).reshape(-1, 4)


def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    iw = np.minimum(a[:, None, 2], b[None, :, 2]) - np.maximum(
        a[:, None, 0], b[None, :, 0]
    )
    ih = np.minimum(a[:, None, 3], b[None, :, 3]) - np.maximum(
        a[:, None, 1], b[None, :, 1]
    )
    inter = np.maximum(iw, 0) * np.maximum(ih, 0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def merge_words_to_lines(
    boxes: np.ndarray, max_gap: float = 50.0, min_v_overlap: float = 0.7
) -> np.ndarray:
    """Merge per-word ground-truth boxes into connector-reachable line
    segments.

    CTPN emits text LINES: the connector joins proposals whose horizontal
    gap is <= ``TEXT.MAX_HORIZONTAL_GAP`` and whose vertical overlap ratio
    is >= ``TEXT.MIN_V_OVERLAPS`` (reference
    `lib/text_connector/text_proposal_graph_builder.py:36-61`). Word-level
    ground truth (ICDAR-style) therefore cannot be matched 1:1 against line
    detections; this merges words with the same rule the connector uses, so
    the merged GT is exactly the set of line segments a perfect detector
    could produce.

    ``boxes``: (N, 4) x0,y0,x1,y1. Returns (M, 4) merged boxes, M <= N.
    """

    def joinable(a, b):
        gap = max(a[0], b[0]) - min(a[2], b[2])  # <0 when overlapping
        if gap > max_gap:
            return False
        ih = min(a[3], b[3]) - max(a[1], b[1])
        hmin = min(a[3] - a[1], b[3] - b[1])
        return hmin > 0 and ih / hmin >= min_v_overlap

    return _merge_transitive(boxes, joinable)


def merge_words_to_lines_geometric(
    boxes: np.ndarray, gap_frac: float = 0.75, min_v_overlap: float = 0.5
) -> np.ndarray:
    """Geometry-only GT line merge, independent of the connector's rule.

    Two words belong to the same line when their horizontal gap is at most
    ``gap_frac`` x the smaller word's height (a space-scale gap at the
    text's own size) and their vertical extents overlap by at least
    ``min_v_overlap`` of the smaller height. Nothing here derives from the
    detector's connector thresholds (``TEXT.MAX_HORIZONTAL_GAP``,
    ``MIN_V_OVERLAPS``, size similarity), so scoring detections against
    this merge does not share the detector's inductive bias —
    ``merge_words_to_lines`` flatters the F numbers by construction.
    Report both; quality claims should quote this one.
    """

    def joinable(a, b):
        hmin = min(a[3] - a[1], b[3] - b[1])
        if hmin <= 0:
            return False
        gap = max(a[0], b[0]) - min(a[2], b[2])
        if gap > gap_frac * hmin:
            return False
        ih = min(a[3], b[3]) - max(a[1], b[1])
        return ih / hmin >= min_v_overlap

    return _merge_transitive(boxes, joinable)


def _merge_transitive(boxes: np.ndarray, joinable) -> np.ndarray:
    """Union boxes under the transitive closure of a pairwise predicate and
    return each group's bounding box."""
    n = len(boxes)
    if n == 0:
        return np.zeros((0, 4))
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        for j in range(i + 1, n):
            if joinable(boxes[i], boxes[j]):
                parent[find(i)] = find(j)
    groups: Dict[int, list] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    merged = [
        [
            boxes[g, 0].min(),
            boxes[g, 1].min(),
            boxes[g, 2].max(),
            boxes[g, 3].max(),
        ]
        for g in (np.asarray(idx) for idx in groups.values())
    ]
    return np.asarray(merged, dtype=np.float64)


def match_boxes(cand: np.ndarray, ref: np.ndarray, iou_thresh: float = 0.5):
    """Greedy one-to-one matching by descending IoU. Returns matched count."""
    iou = _iou_xyxy(cand, ref)
    matched = 0
    used_c, used_r = set(), set()
    pairs = [
        (iou[i, j], i, j)
        for i in range(len(cand))
        for j in range(len(ref))
        if iou[i, j] >= iou_thresh
    ]
    for v, i, j in sorted(pairs, reverse=True):
        if i in used_c or j in used_r:
            continue
        used_c.add(i)
        used_r.add(j)
        matched += 1
    return matched


def compare_result_dirs(
    cand_dir: str, ref_dir: str, iou_thresh: float = 0.5
) -> Dict[str, float]:
    """Aggregate precision/recall/F over all res_*.txt stems in ref_dir."""
    total_c = total_r = total_m = 0
    per_file = {}
    for ref_path in sorted(glob.glob(osp.join(ref_dir, "res_*.txt"))):
        name = osp.basename(ref_path)
        cand_path = osp.join(cand_dir, name)
        ref = read_res_txt(ref_path)
        cand = read_res_txt(cand_path) if osp.exists(cand_path) else np.zeros((0, 4))
        m = match_boxes(cand, ref, iou_thresh)
        total_c += len(cand)
        total_r += len(ref)
        total_m += m
        per_file[name] = (len(cand), len(ref), m)
    precision = total_m / max(total_c, 1)
    recall = total_m / max(total_r, 1)
    f = 2 * precision * recall / max(precision + recall, 1e-9)
    return {
        "precision": precision,
        "recall": recall,
        "f_measure": f,
        "candidate_boxes": total_c,
        "reference_boxes": total_r,
        "matched": total_m,
        "per_file": per_file,
    }


def main(argv=None):  # pragma: no cover - thin CLI
    import argparse
    import json

    p = argparse.ArgumentParser(description="Compare res_*.txt result dirs")
    p.add_argument("candidate")
    p.add_argument("reference")
    p.add_argument("--iou", type=float, default=0.5)
    args = p.parse_args(argv)
    out = compare_result_dirs(args.candidate, args.reference, args.iou)
    out.pop("per_file")
    print(json.dumps(out, indent=2))


if __name__ == "__main__":  # pragma: no cover
    main()
