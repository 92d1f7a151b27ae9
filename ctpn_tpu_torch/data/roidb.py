"""Roidb enrichment (port of ``ctpn_tpu.data.roidb``; reference
`lib/roi_data_layer/roidb.py` + `lib/fast_rcnn/train.py:184-198`).

``prepare_roidb`` attaches image path/size and dense max-class/max-overlap
fields with the reference's sanity checks (`roidb.py:7-35`).
``get_training_roidb`` applies the flip augmentation then prepares
(`train.py:184-198`).

The reference also precomputes normalized per-roi regression targets on the
host (`add_bbox_regression_targets`, `roidb.py:37-105`); in the RPN-only
CTPN recipe those values are never consumed by the loss (targets come from
the anchor-target layer), and the port computes anchor targets on the
device — so that precompute is intentionally not carried over. The
normalization constants remain available at cfg.TRAIN.BBOX_NORMALIZE_*.
"""

from __future__ import annotations

from typing import List

import numpy as np
from PIL import Image

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.data.voc import PascalVOC


def prepare_roidb(imdb: PascalVOC) -> None:
    """Attach image metadata and dense best-overlap fields to every entry.

    Semantics of the reference enrichment (`lib/roi_data_layer/roidb.py:7-35`):
    each roi gains the class index of its best-overlapping gt box plus that
    overlap value, and a roi must be background (class 0) exactly when its
    best overlap is zero. Flip augmentation repeats images, so sizes are
    memoized per path rather than recomputed per entry.
    """
    size_of: dict = {}
    for i, entry in enumerate(imdb.roidb):
        path = imdb.image_path_at(i)
        if path not in size_of:
            with Image.open(path) as im:
                size_of[path] = im.size
        overlaps = entry["gt_overlaps"]
        best = overlaps.argmax(axis=1)
        entry.update(
            image=path,
            width=size_of[path][0],
            height=size_of[path][1],
            max_classes=best,
            max_overlaps=overlaps.max(axis=1),
        )
        fg = entry["max_overlaps"] > 0
        if np.any(best[~fg] != 0) or np.any(best[fg] == 0):
            raise AssertionError(
                f"roidb entry {i}: background/class disagreement "
                "(a zero-overlap roi carries a foreground class or vice versa)"
            )


def get_training_roidb(imdb: PascalVOC) -> List[dict]:
    """Flip-augment (if enabled) and prepare (`train.py:184-198`)."""
    if cfg.TRAIN.USE_FLIPPED:
        imdb.append_flipped_images()
    prepare_roidb(imdb)
    return imdb.roidb
