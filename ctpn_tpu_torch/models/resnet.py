"""ResNet-50 with modulated deformable convs: DBNet's trunk (MhLiao/DB
``backbones/resnet.py::deformable_resnet50``; He et al., CVPR 2016; Zhu et
al., CVPR 2019).

The stem is a 7x7/2 conv to 64 channels, its ReLU, and a 3x3/2 max-pool
(padding 1). Four stages of bottlenecks follow, of (blocks, planes) (3,
64), (4, 128), (6, 256), (3, 512). A bottleneck is ``relu(conv3(relu(conv2(
relu(conv1(x))))) + identity)``: conv1 1x1 to ``planes``, conv2 3x3
``planes`` to ``planes`` at the stage's stride (the v1.5 layout: 1 in
stage 1, 2 in the first block of the others), conv3 1x1 to ``4 planes``.
The identity of each stage's first block is a strided 1x1 projection.
``stage_with_dcn`` (False, True, True, True) makes conv2 of every block of
stages 2-4 a modulated deformable conv (``ops/deform_conv.py``): 13 sites.
Its offsets and masks come from ``conv2_offset``, a 3x3 conv at the same
stride to 27 channels with a bias, computed in the compute dtype and read
in float32. The trunk answers with c2-c5, the stages' outputs (256, 512,
1024 and 2048 channels at strides 4, 8, 16 and 32).

The batch norms fold into the convs' weights and biases at load
(``utils/weights.py::db_params_from_mhliao``), so every conv here carries
its own bias. Every conv with a ReLU after it (the stem, each bottleneck's
conv1 and conv2) runs ``Conv3x3.conv_relu``: the ``conv_epilogue`` op in
bfloat16 inference, the deformable convs' through
:meth:`DeformConv3x3.conv_relu`. In bfloat16 inference a bottleneck ends
in the ``residual_epilogue`` op: conv3's bias, the projection's bias, the
sum with the identity and its ReLU in one pass (:meth:`Bottleneck.forward`).

``PER_IMAGE_OFFSETS``: the stages (1-based) whose offset convs run one
image at a time (``Conv3x3``'s ``per_image``), so that an image's maps do
not depend on its slot in the batch. On the card at batch 32 and
736x1312, cuDNN gave stage 2's offset convs (27 channels at stride 8)
other bits for an image alone than in the batch, and no other conv of the
network moved, alone or in a rolled batch (random weights; the
deformable convs' GEMMs run per image whatever it is).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctpn_tpu_torch.models.vgg import Conv3x3
from ctpn_tpu_torch.ops.conv_epilogue import conv_epilogue
from ctpn_tpu_torch.ops.deform_conv import OFFSETS, deform_conv, deform_conv_ref
from ctpn_tpu_torch.ops.residual_epilogue import residual_epilogue

STAGES: Tuple[Tuple[int, int], ...] = ((3, 64), (4, 128), (6, 256), (3, 512))
STAGE_WITH_DCN: Tuple[bool, ...] = (False, True, True, True)
PER_IMAGE_OFFSETS: Tuple[int, ...] = (2,)  # stage 2's offset convs: see above
STEM_WIDTH = 64
EXPANSION = 4

Mark = Callable[[str], None]


def _no_mark(name: str) -> None:
    pass


class ConvK(Conv3x3):
    """A k x k conv at ``stride`` with padding k // 2, with ``Conv3x3``'s
    dtype cast, ``per_image`` and ``conv_relu``; ``bias=False`` makes one
    without a bias (DBNet's neck)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bias: bool = True,
                 per_image: bool = False):
        nn.Conv2d.__init__(self, cin, cout, k, stride=stride, padding=k // 2, bias=bias)
        self.per_image = per_image


class DeformConv3x3(nn.Module):
    """A bottleneck's modulated deformable conv2 (no bias of its own; the
    folded batch norm's): ``weight`` (O, C, 3, 3), ``bias`` (O,)."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def conv_relu(self, x: torch.Tensor, om: torch.Tensor) -> torch.Tensor:
        """``relu(deform_conv(x, om) + bias)``, ``om`` (N, 27, Ho, Wo)
        float32. With gradients off and a bfloat16 input: the
        ``deform_conv`` op, then the ``conv_epilogue`` op adds the bias and
        applies the ReLU (the product is rounded to bf16 first, as cuDNN's
        conv is before PyTorch adds its bias); otherwise the plain version's
        separate passes."""
        w = self.weight.to(x.dtype)
        if torch.is_grad_enabled() or x.dtype != torch.bfloat16:
            y = deform_conv_ref(x, om, w, self.stride)
            return F.relu(y + self.bias.to(x.dtype).view(1, -1, 1, 1))
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        y = deform_conv(x, om, w, self.stride)
        return conv_epilogue(y.contiguous(memory_format=torch.channels_last),
                             self.bias.to(x.dtype), False)


class Bottleneck(nn.Module):
    """ResNet's bottleneck (v1.5: the stride on conv2); ``dcn`` makes conv2
    deformable, with its offset conv ``conv2_offset``. With gradients off
    and a bfloat16 input the block ends in the ``residual_epilogue`` op on
    conv3's and the projection's :meth:`Conv3x3.bias_apart` splits, with
    the bits of the passes it replaces; otherwise (training, float32) in
    those passes."""

    def __init__(self, cin: int, planes: int, stride: int, dcn: bool,
                 offsets_alone: bool = False):
        super().__init__()
        self.dcn = dcn
        self.conv1 = ConvK(cin, planes, 1)
        if dcn:
            self.conv2_offset = ConvK(planes, OFFSETS, 3, stride, per_image=offsets_alone)
            self.conv2 = DeformConv3x3(planes, planes, stride)
        else:
            self.conv2 = ConvK(planes, planes, 3, stride)
        self.conv3 = ConvK(planes, planes * EXPANSION, 1)
        self.downsample = None
        if stride != 1 or cin != planes * EXPANSION:
            self.downsample = ConvK(cin, planes * EXPANSION, 1, stride)

    def forward(self, x: torch.Tensor, site: Optional[int] = None,
                mark: Mark = _no_mark) -> torch.Tensor:
        out = self.conv1.conv_relu(x)
        if self.dcn:
            mark(f"dcn{site:02d}_in")
            om = self.conv2_offset(out).float()
            out = self.conv2.conv_relu(out, om)
            mark(f"dcn{site:02d}_out")
        else:
            out = self.conv2.conv_relu(out)
        if torch.is_grad_enabled() or x.dtype != torch.bfloat16:
            identity = x if self.downsample is None else self.downsample(x)
            return F.relu(self.conv3(out) + identity)
        y, bias = self.conv3.bias_apart(out)
        if self.downsample is None:
            identity, identity_bias = x.contiguous(memory_format=torch.channels_last), None
        else:
            identity, identity_bias = self.downsample.bias_apart(x)
        return residual_epilogue(y, bias, identity, identity_bias)


class ResNet50DCN(nn.Module):
    """DBNet's trunk on NCHW tensors: (N, 3, H, W) -> [c2, c3, c4, c5].
    ``stages`` and ``stem_width`` default to the published widths (the
    tests substitute narrow ones)."""

    def __init__(self, stages: Sequence[Tuple[int, int]] = STAGES,
                 stage_with_dcn: Sequence[bool] = STAGE_WITH_DCN, stem_width: int = STEM_WIDTH):
        super().__init__()
        self.conv1 = ConvK(3, stem_width, 7, stride=2)
        cin = stem_width
        self.sites = 0
        self.out_channels: List[int] = []
        for idx, ((blocks, planes), dcn) in enumerate(zip(stages, stage_with_dcn)):
            stride = 1 if idx == 0 else 2
            alone = idx + 1 in PER_IMAGE_OFFSETS
            layer = nn.ModuleList()
            for b in range(blocks):
                s = stride if b == 0 else 1
                layer.append(Bottleneck(cin, planes, s, dcn, alone))
                cin = planes * EXPANSION
                self.sites += int(dcn)
            self.add_module(f"layer{idx + 1}", layer)
            self.out_channels.append(cin)

    def forward(self, x: torch.Tensor, mark: Mark = _no_mark) -> List[torch.Tensor]:
        """c2-c5; ``mark`` is called before and after each deformable site
        (``dcnNN_in``, ``dcnNN_out``: ``utils/timer.py``'s ``DB_STAGES``)."""
        x = F.max_pool2d(self.conv1.conv_relu(x), 3, 2, 1)
        outs, site = [], 0
        for idx in range(len(self.out_channels)):
            for block in getattr(self, f"layer{idx + 1}"):
                if block.dcn:
                    site += 1
                x = block(x, site if block.dcn else None, mark)
            outs.append(x)
        return outs
