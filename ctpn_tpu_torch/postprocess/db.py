"""DBNet's post-process on the device (MhLiao/DB
``structure/representers/seg_detector_representer.py::boxes_from_bitmap``,
the representer's defaults), in two kernels' ops: components of the
binarized probability map, then a scored, unclipped minimum-area box per
component, in the original image's pixels.

Every step is tensor code or a kernel's op, with no host sync and no
tensor made from host data, so the captured program holds all of it:

1. the extent: each image's resized rows and columns (``im_info``'s first
   two), clipped to the map; the bucket's padding past them is not read;
2. ``ops/ccl.py::ccl_label``: a pixel is on over ``TEXT.DB_THRESH``; its
   8-connected components (a component's outer border, which
   ``cv2.findContours`` traces, has the hull of its pixels; the borders of
   its holes are left out: a hole's box scores under the threshold by
   construction), every one kept, in raster order, at most
   ``TPU.DB_MAX_BOXES`` (564: DB's ``max_candidates`` is 100, which the
   benchmark's renders pass; the rest are counted in ``overflow``);
3. ``ops/db_boxes.py::db_boxes``: each component's minimum-area box, its
   short side (``TEXT.DB_MIN_SIZE``), its mean probability
   (``TEXT.DB_BOX_THRESH``), the unclip (``TEXT.DB_UNCLIP_RATIO``) and
   the grown short side, mapped to the original size (``im_info``'s last
   two); the kept boxes moved to the front of their image's rows in
   component order. A record is the four corners and the box's score.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ctpn_tpu_torch.ops.ccl import ccl_label
from ctpn_tpu_torch.ops.db_boxes import db_boxes


class DBText(NamedTuple):
    """The map and the components (the ``Proposals`` of DB)."""

    maps: torch.Tensor  # (B, H, W) float32 probabilities
    rois: torch.Tensor  # (B, K, 5) float32 [area, x, y, w, h] in map pixels
    valid: torch.Tensor  # (B, K) bool
    count: torch.Tensor  # (B,) int32 components taken
    overflow: torch.Tensor  # (B,) int32 components past K, dropped
    on: torch.Tensor  # (B,) int32 pixels on
    labelled: torch.Tensor  # (B,) int32 components labelled


class DBRecords(NamedTuple):
    """The detections (the ``TextLines`` of DB)."""

    recs: torch.Tensor  # (B, K, 9) float32 [x1, y1, ..., x4, y4, score], original pixels
    valid: torch.Tensor  # (B, K) bool
    count: torch.Tensor  # (B,) int32
    overflow: torch.Tensor  # (B,) int32 components past K, dropped


def map_extent(im_info: torch.Tensor, prob: torch.Tensor) -> torch.Tensor:
    """(B, 2) int32 rows and columns of the map inside each image's resized
    extent (``im_info`` [h, w, original h, original w])."""
    hw = im_info[:, :2].to(torch.int32)
    return torch.stack([hw[:, 0].clamp(max=prob.shape[1]), hw[:, 1].clamp(max=prob.shape[2])],
                       1)


def compacted(recs: torch.Tensor, keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kept rows of ``recs`` (B, K, 9) first, in their order, zeros
    after; and the count kept per image."""
    kept = keep.bool()
    pos = torch.where(kept, torch.cumsum(keep, 1) - 1, recs.shape[1])
    out = recs.new_zeros((recs.shape[0], recs.shape[1] + 1, recs.shape[2]))
    out.scatter_(1, pos[..., None].expand(-1, -1, recs.shape[2]).to(torch.int64), recs)
    return out[:, :-1], kept.sum(1, dtype=torch.int32)


def db_postprocess(prob: torch.Tensor, im_info: torch.Tensor, kw, mark
                   ) -> Tuple[DBText, DBRecords]:
    """Steps 1-3, calling ``mark`` after ``label`` and ``boxes``. ``kw``:
    :func:`db_kwargs`."""
    extent = map_extent(im_info, prob)
    labels, stats, _, count, over, on, labelled = ccl_label(
        prob[..., None], extent, kw["thresh"], 0.0, 0.0, 1, kw["max_boxes"], connectivity=8)
    mark("label")
    recs, keep = db_boxes(prob, labels, stats, count, extent, im_info[:, 2:4].contiguous(),
                          kw["box_thresh"], kw["unclip_ratio"], kw["min_size"])
    recs, kept = compacted(recs, keep)
    mark("boxes")
    slots = torch.arange(stats.shape[1], device=prob.device)[None]
    return (DBText(prob, stats[..., 1:].float(), slots < count[:, None], count, over, on,
                   labelled),
            DBRecords(recs, slots < kept[:, None], kept, over))


def db_kwargs() -> dict:
    """The post-process's settings from the cfg."""
    from ctpn_tpu_torch.config import cfg

    t = cfg.TEXT
    return dict(thresh=float(t.DB_THRESH), box_thresh=float(t.DB_BOX_THRESH),
                unclip_ratio=float(t.DB_UNCLIP_RATIO), min_size=float(t.DB_MIN_SIZE),
                max_boxes=int(cfg.TPU.DB_MAX_BOXES))
