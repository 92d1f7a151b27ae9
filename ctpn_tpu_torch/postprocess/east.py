"""EAST's post-process on the device (argman/EAST ``eval.py::detect``, in
tensors): score threshold, raster compaction, RBOX restore, then the
locality-aware walk and quad NMS.

Every step is tensor code or a kernel's op, with no host sync and no
tensor made from host data, so the captured program holds all of it:

1. :func:`decode`: the cells whose score passes ``TEXT.SCORE_MAP_THRESH``
   (strictly) inside the image's resized extent (the bucket's padding is
   not read), compacted in raster order (y, then x: stable) into a buffer
   that holds the whole stride-4 map, so no cell is dropped, each with its
   restored rectangle (:func:`restore_rbox`);
2. ``ops/lanms.py::lanms_walk``: the walk folds them into merged quads (at
   most ``TPU.EAST_MAX_MERGED``; the rest are counted in ``overflow``);
3. :func:`quad_nms`: a stable sort of the merged quads by score sum, the
   quad suppression bitmask (``ops/quad_nms.py``) at ``TEXT.NMS_THRESH``,
   ``ctpn_torch::nms_resolve``, and the kept quads compacted into records
   (at most ``TPU.EAST_MAX_RECORDS``; the rest counted). A record's score
   is its merged quad's score sum over the cells it folds.

argman/EAST's ``box_thresh`` filter (the mean score map inside each box)
is not in the paper and is left out.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ctpn_tpu_torch.models.east import STRIDE, EASTOutputs
from ctpn_tpu_torch.ops.lanms import lanms_walk
from ctpn_tpu_torch.ops.nms_resolve import nms_resolve
from ctpn_tpu_torch.ops.quad_nms import quad_bitmask


class EastQuads(NamedTuple):
    """The merged quads, sorted by score sum (the ``Proposals`` of EAST)."""

    rois: torch.Tensor  # (B, K, 9) float32 [score sum, x1, y1, ..., x4, y4]
    valid: torch.Tensor  # (B, K) bool
    count: torch.Tensor  # (B,) int32
    overflow: torch.Tensor  # (B,) int32 merged quads past K, dropped
    cells: torch.Tensor  # (B,) int32 cells over the score threshold


class EastRecords(NamedTuple):
    """The detections (the ``TextLines`` of EAST)."""

    recs: torch.Tensor  # (B, L, 9) float32 [x1, y1, ..., x4, y4, score]
    valid: torch.Tensor  # (B, L) bool
    count: torch.Tensor  # (B,) int32
    overflow: torch.Tensor  # (B,) int32 records past L, dropped


def restore_rbox(ox: torch.Tensor, oy: torch.Tensor, geo: torch.Tensor,
                 angle: torch.Tensor) -> torch.Tensor:
    """(..., 8) quads TL, TR, BR, BL of the rectangles whose edges lie at
    ``geo`` (..., 4: top, right, bottom, left) from the points (ox, oy),
    turned by ``angle``: along the text u = (cos, sin), across it
    v = (-sin, cos)."""
    c, s = torch.cos(angle), torch.sin(angle)
    t, r, b, l = geo.unbind(-1)
    return torch.stack([
        ox - l * c + t * s, oy - l * s - t * c,
        ox + r * c + t * s, oy + r * s - t * c,
        ox + r * c - b * s, oy + r * s + b * c,
        ox - l * c - b * s, oy - l * s + b * c,
    ], -1)


def decode(outs: EASTOutputs, im_info: torch.Tensor, thresh: float
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cells (B, M, 9) ``[score, quad]`` in raster order, count (B,)
    int32) with M the map's cells; slots past the count are zero."""
    score = outs.score
    batch, h, w = score.shape
    dev = score.device
    ys = torch.arange(h, device=dev, dtype=torch.float32) * STRIDE
    xs = torch.arange(w, device=dev, dtype=torch.float32) * STRIDE
    oy, ox = ys[:, None].expand(h, w), xs[None, :].expand(h, w)
    inside = (oy[None] < im_info[:, 0, None, None]) & (ox[None] < im_info[:, 1, None, None])
    hit = (score > thresh) & inside
    quads = restore_rbox(ox, oy, outs.geo, outs.angle)
    vals = torch.cat([score[..., None], quads], -1).reshape(batch, h * w, 9)
    hit = hit.reshape(batch, h * w)
    pos = torch.cumsum(hit, 1) - 1
    dest = torch.where(hit, pos, h * w)  # the last slot takes the rest
    cells = torch.zeros((batch, h * w + 1, 9), dtype=torch.float32, device=dev)
    cells.scatter_(1, dest[..., None].expand(-1, -1, 9), vals)
    return cells[:, :h * w], hit.sum(1, dtype=torch.int32)


def quad_nms(merged: torch.Tensor, ncells: torch.Tensor, count: torch.Tensor,
             thresh: float, max_records: int) -> Tuple[torch.Tensor, torch.Tensor, EastRecords]:
    """Sort, bitmask, resolve, records: (sorted merged quads (B, K, 9),
    their valid flags, :class:`EastRecords`)."""
    batch, k = merged.shape[:2]
    dev = merged.device
    valid = torch.arange(k, device=dev)[None] < count[:, None]
    key = torch.where(valid, merged[..., 0], float("-inf"))
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    rois = merged.gather(1, order[..., None].expand(-1, -1, 9))
    n = ncells.gather(1, order)
    keep = nms_resolve(quad_bitmask(rois[..., 1:].contiguous(), valid, thresh), valid)
    recs_all = torch.cat([rois[..., 1:], (rois[..., 0] / n.clamp(min=1).float())[..., None]], -1)
    pos = torch.cumsum(keep, 1) - 1
    dest = torch.where(keep & (pos < max_records), pos, max_records)
    recs = torch.zeros((batch, max_records + 1, 9), dtype=torch.float32, device=dev)
    recs.scatter_(1, dest[..., None].expand(-1, -1, 9), recs_all)
    total = keep.sum(1, dtype=torch.int32)
    kept = total.clamp(max=max_records)
    rvalid = torch.arange(max_records, device=dev)[None] < kept[:, None]
    return rois, valid, EastRecords(recs[:, :max_records], rvalid, kept, total - kept)


def east_postprocess(outs: EASTOutputs, im_info: torch.Tensor, kw, mark
                     ) -> Tuple[EastQuads, EastRecords]:
    """Steps 1-3, calling ``mark`` after ``decode``, ``lanms`` and
    ``quad_nms``. ``kw``: :func:`east_kwargs`."""
    cells, ncount = decode(outs, im_info, kw["score_thresh"])
    mark("decode")
    merged, ncells, count, over = lanms_walk(cells, ncount, kw["nms_thresh"], kw["max_merged"])
    mark("lanms")
    rois, valid, recs = quad_nms(merged, ncells, count, kw["nms_thresh"], kw["max_records"])
    mark("quad_nms")
    return EastQuads(rois, valid, count, over, ncount), recs


def east_kwargs() -> dict:
    """The post-process's settings from the cfg."""
    from ctpn_tpu_torch.config import cfg

    return dict(score_thresh=float(cfg.TEXT.SCORE_MAP_THRESH),
                nms_thresh=float(cfg.TEXT.NMS_THRESH),
                max_merged=int(cfg.TPU.EAST_MAX_MERGED),
                max_records=int(cfg.TPU.EAST_MAX_RECORDS))
