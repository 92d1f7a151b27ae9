"""EAST with the VGG16 trunk and RBOX geometry (Zhou et al., "EAST: An
Efficient and Accurate Scene Text Detector", CVPR 2017, section 3.2 and
Fig. 3).

The trunk is CTPN's ``VGG16Trunk`` with a fifth pool (``pool_last``); its
pool2-pool5 outputs (strides 4, 8, 16, 32) feed a U-shaped merge branch:
at each of three stages the branch's map is unpooled 2x (bilinear, to the
skip's size, half-pixel centres), concatenated with the next tap, and run
through a 1x1 and a 3x3 conv of 128, 64 and 32 channels; a 3x3 conv of 32
follows, then the 1x1 heads at stride 4 (float32):

* ``score``: sigmoid, (N, H/4, W/4);
* ``geo``: the distances from the cell to the top, right, bottom and left
  edges of its rotated rectangle, ``sigmoid * text_scale`` (512), (N, H/4,
  W/4, 4);
* ``angle``: the rectangle's rotation, ``(sigmoid - 0.5) * pi / 2``,
  (N, H/4, W/4), in radians; positive turns the text's direction from +x
  towards +y (clockwise on the image).

No batch norm, as in the paper's figure (argman/EAST's would fold into the
conv biases at inference). Every conv has its ReLU and, with gradients off
in bfloat16, its bias and ReLU run as the ``conv_epilogue`` op
(``vgg.Conv3x3.conv_relu``), and each unpool with its concatenation as
the ``resize_concat`` op on the card (``vgg.upsample_concat``).
``per_image_tail`` runs the convs of block 5 and of the whole merge branch
one image at a time, so that an image's maps do not depend on its slot in
the batch: at 736x1280, batch 32, on the H100, the batched merge convs
moved the merge output by one bf16 step against the image alone, and 7 of
64 images' records with it, while the batched blocks 1-4 left every tap
equal.

Input: (N, H, W, 3) float32, BGR, minus CTPN's pixel means (the trunk is
CTPN's). The unpool samples with half-pixel centres (``align_corners=
False``); argman/EAST's TF1 ``resize_bilinear`` samples without the
half-pixel offset.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ctpn_tpu_torch.models.vgg import VGG_STAGES, Conv1x1, Conv3x3, VGG16Trunk, upsample_concat

MERGE_WIDTHS: Tuple[int, int, int] = (128, 64, 32)
OUT_WIDTH = 32
TEXT_SCALE = 512.0
STRIDE = 4


class EASTOutputs(NamedTuple):
    score: torch.Tensor  # (N, H/4, W/4) float32
    geo: torch.Tensor  # (N, H/4, W/4, 4) float32: top, right, bottom, left
    angle: torch.Tensor  # (N, H/4, W/4) float32 radians


class EAST(nn.Module):
    """EAST-VGG16 (RBOX). ``trunk_stages`` and ``widths`` default to the
    published widths (tests substitute narrow ones)."""

    def __init__(
        self,
        dtype: torch.dtype = torch.bfloat16,
        trunk_stages: Optional[Tuple[Tuple[int, int, int], ...]] = None,
        widths: Tuple[int, int, int] = MERGE_WIDTHS,
        out_width: int = OUT_WIDTH,
        text_scale: float = TEXT_SCALE,
        per_image_tail: bool = False,
    ):
        super().__init__()
        stages = tuple(trunk_stages or VGG_STAGES)
        self.dtype = dtype
        self.text_scale = float(text_scale)
        self.trunk = VGG16Trunk(stages, per_image_tail=per_image_tail, pool_last=True)
        taps = [ch for _, _, ch in stages][1:]  # pool2 .. pool5
        cin = taps[-1]
        for k, (w, skip) in enumerate(zip(widths, taps[-2::-1]), start=2):
            self.add_module(f"merge{k}_1x1", Conv1x1(cin + skip, w, per_image=per_image_tail))
            self.add_module(f"merge{k}_3x3", Conv3x3(w, w, per_image=per_image_tail))
            cin = w
        self.out_conv = Conv3x3(cin, out_width, per_image=per_image_tail)
        self.heads = nn.Linear(out_width, 6)  # score, 4 distances, angle

    def trunk_taps(self, images: torch.Tensor):
        """images (N, H, W, 3) -> [pool2, pool3, pool4, pool5] NCHW."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last) if x.is_cuda else x.contiguous()
        return self.trunk(x, taps=True)

    def merge(self, taps) -> torch.Tensor:
        """The merge branch and the last conv: (N, 32, H/4, W/4)."""
        h = taps[-1]
        for k, skip in enumerate(taps[-2::-1], start=2):
            h = getattr(self, f"merge{k}_1x1").conv_relu(upsample_concat(h, skip))
            h = getattr(self, f"merge{k}_3x3").conv_relu(h)
        return self.out_conv.conv_relu(h)

    def head(self, h: torch.Tensor) -> EASTOutputs:
        y = self.heads(h.permute(0, 2, 3, 1).float())  # (N, H/4, W/4, 6)
        return EASTOutputs(
            score=torch.sigmoid(y[..., 0]),
            geo=torch.sigmoid(y[..., 1:5]) * self.text_scale,
            angle=(torch.sigmoid(y[..., 5]) - 0.5) * (math.pi / 2),
        )

    def forward(self, images: torch.Tensor) -> EASTOutputs:
        """images: (N, H, W, 3) float32, BGR, pixel-mean subtracted."""
        return self.head(self.merge(self.trunk_taps(images)))
