"""VGG16 convolutional trunk (13 convs, 4 pools, stride 16).

Port of ``ctpn_tpu.models.vgg``: 3x3 SAME convs + ReLU, 2x2/2 VALID
max-pools after blocks 1-4 (block 5 keeps full resolution, total stride
16). Parameters are float32; each conv casts them to the input's compute
dtype (bfloat16 by default), as flax's ``dtype`` does. Inside, the convs
run NCHW; on CUDA the activations are kept channels_last for cuDNN.

The JAX package's two block-1 variants map as follows:

* ``fused_stem`` (the Pallas stem kernel) is not ported yet and raises.
* ``packed_stem`` packs image pairs into channels through block-diagonal
  weights, a TPU lane-layout trick whose output equals the stock block;
  here it runs the stock convs.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# (block, reps, channels) for VGG16's conv layers
VGG_STAGES: Tuple[Tuple[int, int, int], ...] = (
    (1, 2, 64),
    (2, 2, 128),
    (3, 3, 256),
    (4, 3, 512),
    (5, 3, 512),
)


class Conv3x3(nn.Conv2d):
    """3x3 SAME conv whose float32 parameters cast to the input's dtype."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(
            x, self.weight.to(x.dtype), self.bias.to(x.dtype), padding=1
        )


class VGG16Trunk(nn.Module):
    """Feature extractor on NCHW tensors: (N, 3, H, W) -> (N, C, H/16, W/16).

    ``stages`` defaults to VGG16; tests substitute a narrow ladder with the
    same stride-16 pooling structure.
    """

    def __init__(
        self,
        stages: Tuple[Tuple[int, int, int], ...] = VGG_STAGES,
        fused_stem: bool = False,
    ):
        super().__init__()
        if fused_stem:
            raise NotImplementedError(
                "TPU.FUSED_STEM selects the fused stem kernel, which is not "
                "ported yet (ROADMAP queue B, item 3)"
            )
        self.stages = tuple(stages)
        cin = 3  # BGR
        for block, reps, ch in self.stages:
            for rep in range(1, reps + 1):
                self.add_module(f"conv{block}_{rep}", Conv3x3(cin, ch))
                cin = ch
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block, reps, _ in self.stages:
            for rep in range(1, reps + 1):
                x = F.relu(getattr(self, f"conv{block}_{rep}")(x))
            if block < 5:  # pools 1-4 only: stride 16 at conv5_3
                x = F.max_pool2d(x, 2, 2)
        return x
