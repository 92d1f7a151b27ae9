"""CRAFT with the VGG16-BN trunk (Baek et al., "Character Region
Awareness for Text Detection", CVPR 2019; clovaai/CRAFT-pytorch
``craft.py``, ``basenet/vgg16_bn.py``).

The trunk is CTPN's ``VGG16Trunk`` built to ``conv5_2`` (``conv5_3`` and
pool5 never run). Its batch norms fold into the convs' weights and biases
at load (``utils/weights.py::craft_params_from_clovaai``), so every conv
here is a plain conv with a bias. clovaai slices torchvision's
``vgg16_bn.features`` at 12, 19, 29 and 39, and torchvision's ReLUs work
in place, so the five taps are:

* relu(``conv2_2``), 128 channels, stride 2 (before pool2);
* relu(``conv3_2``), 256, stride 4;
* relu(``conv4_2``), 512, stride 8;
* ``conv5_2`` after its batch norm and before its ReLU, 512, stride 16;
* ``fc7``: a 3x3/1 max-pool (padding 1) of the pre-ReLU ``conv5_2``,
  ``fc6`` (3x3, 1024, dilation 6, padding 6) and ``fc7`` (1x1, 1024),
  neither with a ReLU.

The U-net decoder: four ``double_conv`` blocks (a 1x1 conv to ``mid``, a
3x3 conv to ``out``, each with its ReLU) of (mid, out) (512, 256), (256,
128), (128, 64), (64, 32). The first reads ``cat(fc7, conv5_2)``; before
each later one the running map is resized bilinearly to the next tap's
size (``align_corners=False``) and concatenated with it. ``conv_cls``:
3x3 32, 3x3 32, 3x3 16, 1x1 16, each with its ReLU, then a 1x1 conv to
two channels with no activation, in float32 (``cls_out``, a ``Linear``
over the channels): the region and affinity maps at stride 2, no sigmoid.

Every conv with a ReLU runs ``Conv3x3.conv_relu`` (the ``conv_epilogue``
op in bfloat16 inference), and each block's input ``vgg.upsample_concat``
(the ``resize_concat`` op on the card: block 1's a copy, the others' a
resize, written into the concatenated buffer in one pass); ``conv2_2``'s
pool runs after its epilogue as its own pass, and ``conv5_2``, ``fc6`` and ``fc7`` are convs with their
bias and nothing after. The trunk's one walk (``VGG16Trunk.forward``)
reads the taps. ``per_image_tail`` runs block 5's convs (stride 16) one
image at a time (``VGG16Trunk``'s): batched, cuDNN sums each image's
``conv5_1`` and ``conv5_2`` in another order at batch 32 than alone. The
decoder's convs, from ``fc6`` (stride 16) to ``conv_cls`` (stride 2),
gave every image the same bits at batch 32, alone and in a rolled batch,
on the card (``scripts/torch_craft_slot_dependence.py``), so they, the
resizes, the concats and the pools run on the whole batch.

Input: (N, H, W, 3) float32, normalised as the weights were trained (the
shipped weights: BGR minus CTPN's pixel means).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctpn_tpu_torch.models.vgg import Conv1x1, Conv3x3, VGG16Trunk, upsample_concat

# VGG16's convs up to conv5_2
CRAFT_STAGES: Tuple[Tuple[int, int, int], ...] = (
    (1, 2, 64),
    (2, 2, 128),
    (3, 3, 256),
    (4, 3, 512),
    (5, 2, 512),
)
# tapped after their ReLU, and conv5_2, the trunk's last conv, before it
TAPS = ("conv2_2", "conv3_2", "conv4_2", "conv5_2")
FC_WIDTH = 1024
UP_WIDTHS: Tuple[Tuple[int, int], ...] = ((512, 256), (256, 128), (128, 64), (64, 32))
CLS_WIDTHS: Tuple[int, int, int, int] = (32, 32, 16, 16)
STRIDE = 2


class CRAFT(nn.Module):
    """CRAFT (VGG16-BN, batch norms folded). ``trunk_stages``, ``fc_width``,
    ``up_widths`` and ``cls_widths`` default to the published widths (the
    tests substitute narrow ones)."""

    def __init__(
        self,
        dtype: torch.dtype = torch.bfloat16,
        trunk_stages: Optional[Tuple[Tuple[int, int, int], ...]] = None,
        fc_width: int = FC_WIDTH,
        up_widths: Tuple[Tuple[int, int], ...] = UP_WIDTHS,
        cls_widths: Tuple[int, int, int, int] = CLS_WIDTHS,
        per_image_tail: bool = False,
    ):
        super().__init__()
        stages = tuple(trunk_stages or CRAFT_STAGES)
        self.dtype = dtype
        self.trunk = VGG16Trunk(stages, per_image_tail=per_image_tail)
        c2, c3, c4, c5 = (ch for block, _, ch in stages if block >= 2)
        self.fc6 = Conv3x3(c5, fc_width, dilation=6)
        self.fc7 = Conv1x1(fc_width, fc_width)
        cin = fc_width
        for k, ((mid, out), skip) in enumerate(zip(up_widths, (c5, c4, c3, c2)), start=1):
            self.add_module(f"up{k}_1x1", Conv1x1(cin + skip, mid))
            self.add_module(f"up{k}_3x3", Conv3x3(mid, out))
            cin = out
        w1, w2, w3, w4 = cls_widths
        self.cls1 = Conv3x3(cin, w1)
        self.cls2 = Conv3x3(w1, w2)
        self.cls3 = Conv3x3(w2, w3)
        self.cls4 = Conv1x1(w3, w4)
        self.cls_out = nn.Linear(w4, 2)  # region, affinity

    def trunk_taps(self, images: torch.Tensor) -> List[torch.Tensor]:
        """images (N, H, W, 3) -> [conv2_2, conv3_2, conv4_2, conv5_2] NCHW,
        the first three after their ReLU, conv5_2 before it."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last) if x.is_cuda else x.contiguous()
        return self.trunk(x, taps=TAPS, last_relu=False)

    def maps(self, taps: List[torch.Tensor]) -> torch.Tensor:
        """The decoder and the head: (N, H/2, W/2, 2) [region, affinity]."""
        return self.head(self.decoder(taps))

    def decoder(self, taps: List[torch.Tensor]) -> torch.Tensor:
        """slice5, the four ``double_conv`` blocks and ``conv_cls``'s convs
        with a ReLU: (N, 16, H/2, W/2) in the compute dtype."""
        c2, c3, c4, c5 = taps
        h = self.fc7(self.fc6(F.max_pool2d(c5, 3, 1, 1)))
        for k, skip in enumerate((c5, c4, c3, c2), start=1):
            h = getattr(self, f"up{k}_1x1").conv_relu(upsample_concat(h, skip))
            h = getattr(self, f"up{k}_3x3").conv_relu(h)
        for conv in (self.cls1, self.cls2, self.cls3, self.cls4):
            h = conv.conv_relu(h)
        return h

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """The last 1x1 conv in float32: (N, H/2, W/2, 2) [region, affinity]."""
        return self.cls_out(h.permute(0, 2, 3, 1).float())

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (N, H, W, 3) float32, normalised -> (N, H/2, W/2, 2)."""
        return self.maps(self.trunk_taps(images))
