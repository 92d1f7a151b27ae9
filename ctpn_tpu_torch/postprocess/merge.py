"""Scale-aware text-line union: merge fragmented line records.

The port's own copy of ``ctpn_tpu.postprocess.merge`` (NumPy, on the host).

The reference connector joins proposals whose horizontal gap is at most a
FIXED 50 px (`lib/text_connector/text_proposal_graph_builder.py:36-40`,
``MAX_HORIZONTAL_GAP``). That constant is sized for body text at the
SCALE=600 resize (line heights ~20-30 px); on display-scale text (100+ px
line height) inter-word gaps exceed it and one banner line fragments into
several records — the reference's own checkpoint compensates by scoring
the whitespace between large words as text, a behavior a corpus with
per-word ground truth does not teach (docs/TRAINING.md round 5).

This stage closes the gap in GEOMETRY rather than in the classifier: a
second union pass over the final line records joins lines whose horizontal
gap is at most ``gap_ratio`` x the smaller line's height — a scale-FREE
version of the reference's rule (50 px at a 25-px body line is gap ratio
2.0; the default 1.25 is stricter) — and whose vertical extents overlap by
at least ``min_v_overlap`` of the smaller height.

Runs on the host over <= MAX_LINES records per image (trivially small next
to the device program); enabled by default for the demo/serving surface via
``cfg.TEXT.LINE_MERGE_GAP_RATIO``, set 0 for reference-exact output (the
golden-parity gate does: tests/test_golden.py).
"""

from __future__ import annotations

import numpy as np


def merge_line_records(
    recs: np.ndarray, gap_ratio: float, min_v_overlap: float = 0.5
) -> np.ndarray:
    """Union text-line records under the scale-aware join rule.

    ``recs``: (N, 9) float records ``[xa, ya, xb, yb, xc, yc, xd, yd,
    score]`` (H mode: axis-aligned TL TR BL BR corners; O mode:
    slope-adjusted quad). Returns (M, 9), M <= N: singleton groups keep
    their original record (incl. O-mode slope); merged groups emit the
    group's axis-aligned hull with a width-weighted mean score.
    """
    recs = np.asarray(recs, dtype=np.float64)
    n = len(recs)
    if n <= 1 or gap_ratio <= 0:
        return recs
    xs, ys = recs[:, 0:8:2], recs[:, 1:8:2]
    hull = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1)
    heights = hull[:, 3] - hull[:, 1]

    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        for j in range(i + 1, n):
            hmin = min(heights[i], heights[j])
            if hmin <= 0:
                continue
            gap = max(hull[i, 0], hull[j, 0]) - min(hull[i, 2], hull[j, 2])
            if gap > gap_ratio * hmin:
                continue
            iv = min(hull[i, 3], hull[j, 3]) - max(hull[i, 1], hull[j, 1])
            if iv / hmin >= min_v_overlap:
                parent[find(i)] = find(j)

    groups = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    out = []
    for idx in groups.values():
        if len(idx) == 1:
            out.append(recs[idx[0]])
            continue
        g = np.asarray(idx)
        x0, y0 = hull[g, 0].min(), hull[g, 1].min()
        x1, y1 = hull[g, 2].max(), hull[g, 3].max()
        w = np.maximum(hull[g, 2] - hull[g, 0], 1e-9)
        score = float((recs[g, 8] * w).sum() / w.sum())
        out.append([x0, y0, x1, y0, x0, y1, x1, y1, score])
    # keep a deterministic order: by top edge then left edge
    out = np.asarray(out, dtype=np.float64).reshape(-1, 9)
    order = np.lexsort((out[:, 0], out[:, 1]))
    return out[order]


def maybe_merge_line_records(recs: np.ndarray) -> np.ndarray:
    """Apply :func:`merge_line_records` per the global config gate."""
    from ctpn_tpu_torch.config import cfg

    ratio = float(getattr(cfg.TEXT, "LINE_MERGE_GAP_RATIO", 0.0))
    if ratio <= 0:
        return recs
    return merge_line_records(
        recs, ratio, float(getattr(cfg.TEXT, "LINE_MERGE_MIN_V_OVERLAP", 0.5))
    )
