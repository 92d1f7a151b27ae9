"""The CTPN detection model: trunk + rpn conv + BiLSTM + anchor heads
(port of ``ctpn_tpu.models.ctpn``).

Output contract per image (A = 10 vertical anchors), NHWC float32 as in
the JAX package:

* ``bbox_pred``  (N, H, W, A*4) — (dx, dy, dw, dh) per anchor, of which only
  dy/dh are consumed by the decode.
* ``cls_score``  (N, H, W, A*2) — (bg, fg) logits per anchor, channel layout
  [a0_bg, a0_fg, a1_bg, a1_fg, ...].
* ``cls_prob``   (N, H, W, A) — fg probability per anchor (softmax over
  each (bg, fg) pair).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ctpn_tpu_torch.models.rnn import BiLSTM
from ctpn_tpu_torch.models.vgg import VGG_STAGES, Conv3x3, VGG16Trunk
from ctpn_tpu_torch.ops.anchors import NUM_ANCHORS


class CTPNOutputs(NamedTuple):
    bbox_pred: torch.Tensor  # (N, H, W, A*4) float32
    cls_score: torch.Tensor  # (N, H, W, A*2) float32
    cls_prob: torch.Tensor  # (N, H, W, A) float32 fg probabilities


class CTPN(nn.Module):
    """CTPN forward network (feature extraction through head tensors).

    ``dtype`` is the compute dtype of the convs and the BiLSTM projections;
    the recurrence and the heads run in float32. ``trunk_stages``,
    ``lstm_hidden`` and ``rpn_channels`` default to the published widths.
    ``per_image_tail`` runs the stride-16 convs (the last block and
    ``rpn_conv``) one image at a time, so that an image's outputs do not
    depend on its slot in the batch (``vgg.Conv3x3``).
    """

    def __init__(
        self,
        num_anchors: int = NUM_ANCHORS,
        lstm_hidden: int = 128,
        dtype: torch.dtype = torch.bfloat16,
        trunk_stages: Optional[Tuple[Tuple[int, int, int], ...]] = None,
        rpn_channels: int = 512,
        fused_stem: bool = False,
        per_image_tail: bool = False,
    ):
        super().__init__()
        self.num_anchors = num_anchors
        self.dtype = dtype
        self.trunk = VGG16Trunk(trunk_stages or VGG_STAGES, fused_stem=fused_stem,
                                per_image_tail=per_image_tail)
        self.rpn_conv = Conv3x3(self.trunk.out_channels, rpn_channels,
                                per_image=per_image_tail)
        self.bilstm = BiLSTM(rpn_channels, hidden=lstm_hidden, d_out=rpn_channels)
        self.rpn_bbox_pred = nn.Linear(rpn_channels, num_anchors * 4)
        self.rpn_cls_score = nn.Linear(rpn_channels, num_anchors * 2)

    def forward(self, images: torch.Tensor, remat: bool = False) -> CTPNOutputs:
        """images: (N, H, W, 3) float32, BGR, pixel-mean subtracted.

        ``remat`` (training, ``TPU.REMAT``) rematerialises the backbone in
        the backward pass one VGG block at a time: each block keeps only its
        input, and the backward runs it once more. The values are the same.
        The head (``rpn_conv``, the BiLSTM, the heads) keeps its activations:
        they are small, and recomputing the BiLSTM's 57-step loop costs as
        much host time as running it.
        """
        x = images.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view of NHWC
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        else:
            x = x.contiguous()
        feat = self.trunk(x, remat=remat)
        rpn = self.rpn_conv.conv_relu(feat).permute(0, 2, 3, 1)  # NHWC
        lstm_o = self.bilstm(rpn)  # (N, H, W, C) float32

        bbox_pred = self.rpn_bbox_pred(lstm_o)
        cls_score = self.rpn_cls_score(lstm_o)
        n, h, w, _ = cls_score.shape
        probs = torch.softmax(cls_score.reshape(n, h, w, self.num_anchors, 2), -1)
        return CTPNOutputs(
            bbox_pred=bbox_pred, cls_score=cls_score, cls_prob=probs[..., 1]
        )
