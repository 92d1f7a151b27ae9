"""CRAFT's post-process on the device (clovaai/CRAFT-pytorch
``craft_utils.py::getDetBoxes_core``, in two kernels' ops): connected
components of the thresholded maps, then a minimum-area box per kept
component.

Every step is tensor code or a kernel's op, with no host sync and no
tensor made from host data, so the captured program holds all of it:

1. :func:`map_extent`: the rows and columns of the stride-2 maps that the
   image's resized extent covers, ``ceil(h / 2)`` and ``ceil(w / 2)``; the
   bucket's padding past them is not read, so it cannot change an image's
   boxes;
2. ``ops/ccl.py::ccl_label``: a pixel is on over ``TEXT.LOW_TEXT``
   (region) or ``TEXT.LINK_THRESHOLD`` (affinity); its 4-connected
   components, those with area >= ``TEXT.MIN_COMPONENT_AREA`` and largest
   region score >= ``TEXT.TEXT_THRESHOLD`` kept in raster order (at most
   ``TPU.CRAFT_MAX_BOXES``; the rest are counted in ``overflow``);
3. ``ops/craft_boxes.py::craft_boxes``: each kept component's box in the
   bucket's pixels (the map's times 2). A record is the box's four corners
   and the component's largest region score.

Left out, as in clovaai's defaults: polygon mode (``--poly``) and the
LinkRefiner.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ctpn_tpu_torch.models.craft import STRIDE
from ctpn_tpu_torch.ops.ccl import ccl_label
from ctpn_tpu_torch.ops.craft_boxes import craft_boxes


class CraftText(NamedTuple):
    """The maps and the kept components (the ``Proposals`` of CRAFT)."""

    maps: torch.Tensor  # (B, H/2, W/2, 2) float32 [region, affinity]
    rois: torch.Tensor  # (B, K, 6) float32 [score, area, x, y, w, h] in map pixels
    valid: torch.Tensor  # (B, K) bool
    count: torch.Tensor  # (B,) int32 components kept
    overflow: torch.Tensor  # (B,) int32 kept components past K, dropped
    on: torch.Tensor  # (B,) int32 pixels on
    labelled: torch.Tensor  # (B,) int32 components labelled


class CraftRecords(NamedTuple):
    """The detections (the ``TextLines`` of CRAFT)."""

    recs: torch.Tensor  # (B, K, 9) float32 [x1, y1, ..., x4, y4, score]
    valid: torch.Tensor  # (B, K) bool
    count: torch.Tensor  # (B,) int32
    overflow: torch.Tensor  # (B,) int32 boxes past K, dropped


def map_extent(im_info: torch.Tensor, maps: torch.Tensor) -> torch.Tensor:
    """(B, 2) int32 rows and columns of the maps inside each image's
    resized extent (``im_info`` [h, w, scale])."""
    hw = torch.div(im_info[:, :2] + 1, STRIDE, rounding_mode="floor").to(torch.int32)
    return torch.stack([hw[:, 0].clamp(max=maps.shape[1]), hw[:, 1].clamp(max=maps.shape[2])],
                       1)


def craft_postprocess(maps: torch.Tensor, im_info: torch.Tensor, kw, mark
                      ) -> Tuple[CraftText, CraftRecords]:
    """Steps 1-3, calling ``mark`` after ``label`` and ``boxes``. ``kw``:
    :func:`craft_kwargs`."""
    extent = map_extent(im_info, maps)
    labels, stats, score, count, over, on, labelled = ccl_label(
        maps, extent, kw["low_text"], kw["link_threshold"], kw["text_threshold"],
        kw["min_area"], kw["max_boxes"])
    mark("label")
    recs = craft_boxes(maps, labels, stats, score, count, extent, kw["low_text"], float(STRIDE))
    mark("boxes")
    valid = torch.arange(stats.shape[1], device=maps.device)[None] < count[:, None]
    rois = torch.cat([score[..., None], stats[..., 1:].float()], -1)
    return (CraftText(maps, rois, valid, count, over, on, labelled),
            CraftRecords(recs, valid, count, over))


def craft_kwargs() -> dict:
    """The post-process's settings from the cfg."""
    from ctpn_tpu_torch.config import cfg

    t = cfg.TEXT
    return dict(text_threshold=float(t.TEXT_THRESHOLD), low_text=float(t.LOW_TEXT),
                link_threshold=float(t.LINK_THRESHOLD), min_area=int(t.MIN_COMPONENT_AREA),
                max_boxes=int(cfg.TPU.CRAFT_MAX_BOXES))
