"""DBNet with the deformable ResNet-50 trunk (Liao et al., "Real-time
Scene Text Detection with Differentiable Binarization", AAAI 2020;
MhLiao/DB ``decoders/seg_detector.py::SegDetector``).

The trunk is ``models/resnet.py::ResNet50DCN`` (c2-c5 at strides 4-32).
The neck (``inner`` 256 channels, every conv without a bias):

* ``in_k = conv1x1(c_k)`` to ``inner``;
* ``out4 = up2(in5) + in4``, ``out3 = up2(out4) + in3``, ``out2 = up2(out3)
  + in2``, ``up2`` a nearest-neighbour x2 upsample;
* ``p5 = up8(conv3x3(in5))``, ``p4 = up4(conv3x3(out4))``, ``p3 =
  up2(conv3x3(out3))``, ``p2 = conv3x3(out2)``, each to ``inner / 4``,
  the upsamples nearest;
* ``fuse = cat(p5, p4, p3, p2)``: ``inner`` channels at stride 4.

The binarize head: a 3x3 conv to ``inner / 4`` with its batch norm and
ReLU, a 2x2/2 transposed conv (``inner / 4`` to ``inner / 4``) with its
batch norm and ReLU, and a 2x2/2 transposed conv to one channel and the
sigmoid: the probability map at stride 1 (the card runs the last as a
float32 matmul, TF32 off in the captured program). The threshold branch runs in
training only, so it is not here.

The batch norms fold into the convs at load
(``utils/weights.py::db_params_from_mhliao``). The head's first conv and
transposed conv run ``conv_relu`` (the ``conv_epilogue`` op in bfloat16
inference); the last transposed conv and the sigmoid run in float32, as
EAST's and CRAFT's heads do. The neck's upsamples, sums and concat are
PyTorch's passes.

Input: (N, H, W, 3) float32 normalised as the weights were trained (DB's
own: BGR minus ``RGB_MEAN``, over 255), H and W multiples of 32 as DB's
resize makes them (on other sizes each upsample goes to the size of the
map it meets, nearest).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctpn_tpu_torch.models.resnet import (STAGE_WITH_DCN, STAGES, STEM_WIDTH, ConvK, Mark,
                                          ResNet50DCN, _no_mark)
from ctpn_tpu_torch.ops.conv_epilogue import conv_epilogue

INNER = 256


def up(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour upsample of ``x`` to ``like``'s size: by 2, 4 or 8
    on the published inputs (sides multiples of 32), and defined on any
    other size too."""
    if x.shape[-2:] == like.shape[-2:]:
        return x
    return F.interpolate(x, size=like.shape[-2:], mode="nearest")


class ConvT2x2(nn.ConvTranspose2d):
    """A 2x2/2 transposed conv whose float32 parameters cast to the
    input's dtype, with ``conv_relu`` as ``Conv3x3``'s."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 2, stride=2)

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        b = self.bias.to(x.dtype) if bias else None
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, stride=2)

    def conv_relu(self, x: torch.Tensor) -> torch.Tensor:
        """``relu(convT(x) + bias)``: with gradients off and bfloat16, the
        ``conv_epilogue`` op after the bias-free product on CUDA (after the
        product with its bias on the CPU, as ``Conv3x3.conv_relu``);
        otherwise the separate passes."""
        if torch.is_grad_enabled() or x.dtype != torch.bfloat16:
            return F.relu(self(x))
        if x.is_cuda:
            y, b = self(x, bias=False), self.bias.to(x.dtype)
        else:
            y, b = self(x), None
        return conv_epilogue(y.contiguous(memory_format=torch.channels_last), b, False)


class DBNet(nn.Module):
    """DBNet-ResNet50-DCN (batch norms folded). ``stages``, ``stem_width``
    and ``inner`` default to the published widths (the tests substitute
    narrow ones)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 stages: Sequence[Tuple[int, int]] = STAGES,
                 stage_with_dcn: Sequence[bool] = STAGE_WITH_DCN, stem_width: int = STEM_WIDTH,
                 inner: int = INNER):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNet50DCN(stages, stage_with_dcn, stem_width)
        self.decoder = nn.Module()
        quarter = inner // 4
        for k, cin in enumerate(self.backbone.out_channels, start=2):
            self.decoder.add_module(f"in{k}", ConvK(cin, inner, 1, bias=False))
            self.decoder.add_module(f"out{k}", ConvK(inner, quarter, 3, bias=False))
        self.decoder.bin_conv = ConvK(inner, quarter, 3)
        self.decoder.bin_up1 = ConvT2x2(quarter, quarter)
        self.decoder.bin_up2 = ConvT2x2(quarter, 1)

    @property
    def sites(self) -> int:
        return self.backbone.sites

    def trunk(self, images: torch.Tensor, mark: Mark = _no_mark) -> List[torch.Tensor]:
        """images (N, H, W, 3) -> [c2, c3, c4, c5] NCHW in the compute dtype."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last) if x.is_cuda else x.contiguous()
        return self.backbone(x, mark)

    def neck(self, feats: List[torch.Tensor], mark: Mark = _no_mark) -> torch.Tensor:
        """The FPN: (N, inner, H/4, W/4) in the compute dtype. ``mark`` is
        called after each part, the stage clock's children of ``neck``
        (``utils/timer.py``'s ``DB_STAGES``): ``neck.lateral`` (the 1x1
        convs), ``neck.topdown`` (the upsample-and-add passes),
        ``neck.smooth`` (the 3x3 convs) and ``neck.fuse`` (the upsamples
        to stride 4 and the concat)."""
        d = self.decoder
        in2, in3, in4, in5 = (getattr(d, f"in{k}")(f) for k, f in zip((2, 3, 4, 5), feats))
        mark("neck.lateral")
        out4 = up(in5, in4) + in4
        out3 = up(out4, in3) + in3
        out2 = up(out3, in2) + in2
        mark("neck.topdown")
        p5, p4, p3, p2 = d.out5(in5), d.out4(out4), d.out3(out3), d.out2(out2)
        mark("neck.smooth")
        fuse = torch.cat([up(p5, p2), up(p4, p2), up(p3, p2), p2], 1)
        mark("neck.fuse")
        return fuse

    def head(self, fuse: torch.Tensor, mark: Mark = _no_mark) -> torch.Tensor:
        """The binarize head: (N, H, W) float32 probabilities at stride 1.
        ``mark`` is called after each part, the stage clock's children of
        ``head``: ``head.conv`` (the 3x3 conv and the first transposed
        conv) and ``head.map`` (the float32 transposed conv to stride 1 and
        the sigmoid)."""
        prob = torch.sigmoid(self.head_logits(fuse, mark))
        mark("head.map")
        return prob

    def head_logits(self, fuse: torch.Tensor, mark: Mark = _no_mark) -> torch.Tensor:
        """The binarize head before its sigmoid, (N, H, W) float32. The last
        transposed conv (one output channel) is a float32 matmul of each
        stride-2 pixel's channels with the (C, 4) kernel, its four outputs
        the 2x2 pixels it covers; ``mark("head.conv")`` is called before
        it."""
        d = self.decoder
        h = d.bin_up1.conv_relu(d.bin_conv.conv_relu(fuse))
        mark("head.conv")
        n, c, hh, ww = h.shape
        w = d.bin_up2.weight.float().reshape(c, 4)
        y = h.float().permute(0, 2, 3, 1).reshape(-1, c) @ w + d.bin_up2.bias.float()
        return y.view(n, hh, ww, 2, 2).permute(0, 1, 3, 2, 4).reshape(n, 2 * hh, 2 * ww)

    def forward(self, images: torch.Tensor, mark: Optional[Mark] = None) -> torch.Tensor:
        """images: (N, H, W, 3) float32, normalised -> (N, H, W) float32."""
        return self.head(self.neck(self.trunk(images, mark or _no_mark)))
