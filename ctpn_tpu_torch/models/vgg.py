"""VGG16 convolutional trunk (13 convs, 4 pools, stride 16).

Port of ``ctpn_tpu.models.vgg``: 3x3 SAME convs + ReLU, 2x2/2 VALID
max-pools after blocks 1-4 (block 5 keeps full resolution, total stride
16). EAST (``models/east.py``) builds the trunk with ``pool_last``, which
pools after block 5 too (stride 32), and reads the outputs of pools 2-5
(``forward(taps=True)``); CRAFT (``models/craft.py``) builds it to
``conv5_2`` and reads named convs inside the blocks
(``forward(taps=("conv2_2", ...), last_relu=False)``).
Parameters are float32; each conv casts them to the input's compute
dtype (bfloat16 by default), as flax's ``dtype`` does. Inside, the convs
run NCHW; on CUDA the activations are kept channels_last for cuDNN.

The JAX package's two block-1 variants map as follows:

* ``fused_stem`` routes block 1 (when it has two convs) through
  ``ops/stem_fused.py``: the hand-written CUDA kernel on the card, its
  plain version on the CPU. Same parameters (``conv1_1``/``conv1_2``), so
  one state dict loads either route. The block computes in bf16 whatever
  the compute dtype, and its output is cast back to the input's dtype, as
  in the JAX package.
* ``packed_stem`` packs image pairs into channels through block-diagonal
  weights, a TPU lane-layout trick whose output equals the stock block;
  here it runs the stock convs.

``per_image_tail`` runs the last block's convs (stride 16) one image at a
time (``Conv3x3``), so that an image's features do not depend on its slot
in the batch.

In inference (gradients off) in bfloat16, each conv's bias, ReLU and the
pool after it run as one pass, the op ``ops/conv_epilogue.py``
(``Conv3x3.conv_relu``), with the bits of the separate passes; training and
float32 keep the separate passes. :func:`upsample_concat`, the skip input
of EAST's and CRAFT's decoders, runs the same way on the card: the op
``ops/resize_concat.py`` in inference in bfloat16, else the resize and the
concatenation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ctpn_tpu_torch.ops.conv_epilogue import conv_epilogue
from ctpn_tpu_torch.ops.resize_concat import resize_concat
from ctpn_tpu_torch.ops.stem_fused import fused_stem_block

# (block, reps, channels) for VGG16's conv layers
VGG_STAGES: Tuple[Tuple[int, int, int], ...] = (
    (1, 2, 64),
    (2, 2, 128),
    (3, 3, 256),
    (4, 3, 512),
    (5, 3, 512),
)


class Conv3x3(nn.Conv2d):
    """3x3 SAME conv whose float32 parameters cast to the input's dtype
    (``dilation`` > 1: CRAFT's fc6, padded by its dilation).

    ``per_image`` runs one conv per image of the batch. cuDNN splits the
    reduction of a small-spatial conv (the stride-16 layers, 38x57 at
    608x912) by output tile, so at batch 8 the images at the end of the
    batch are summed in another order than the others: an image's features,
    and so its line records, would depend on its slot in the batch. One
    image per conv gives every slot the same sums.
    """

    def __init__(self, cin: int, cout: int, per_image: bool = False, dilation: int = 1):
        super().__init__(cin, cout, 3, padding=dilation, dilation=dilation)
        self.per_image = per_image

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        """The conv (at its stride); ``bias=False`` leaves the bias out."""
        w = self.weight.to(x.dtype)
        b = self.bias.to(x.dtype) if bias and self.bias is not None else None
        kw = dict(stride=self.stride, padding=self.padding, dilation=self.dilation)
        if self.per_image and x.shape[0] > 1:
            return torch.cat([F.conv2d(x[i:i + 1], w, b, **kw) for i in range(x.shape[0])])
        return F.conv2d(x, w, b, **kw)

    def bias_apart(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The conv's output in ``channels_last`` and the bias an epilogue op
        still has to add, so that the op gives the bits of the conv with its
        bias and PyTorch's passes after it: on CUDA, PyTorch's cuDNN conv
        rounds its output to bf16 and then adds the bias, so the conv runs
        without its bias and the bias is handed on; the CPU's conv sums the
        bias into its float32 accumulator, so there the conv keeps it and
        None is handed on."""
        if x.is_cuda:
            y, b = self(x, bias=False), self.bias.to(x.dtype)
        else:
            y, b = self(x), None
        return y.contiguous(memory_format=torch.channels_last), b

    def conv_relu(self, x: torch.Tensor, pool: bool = False) -> torch.Tensor:
        """ReLU of the conv, then the 2x2/2 max-pool if ``pool``.

        With gradients off and a bfloat16 input, the passes after the conv
        are one, the op :func:`~ctpn_tpu_torch.ops.conv_epilogue.conv_epilogue`
        on :meth:`bias_apart`'s split, and the bits stay those of the
        separate passes. Otherwise (training, for which the op has no
        backward; float32) the separate passes run.
        """
        if torch.is_grad_enabled() or x.dtype != torch.bfloat16:
            y = F.relu(self(x))
            return F.max_pool2d(y, 2, 2) if pool else y
        return conv_epilogue(*self.bias_apart(x), pool)


def upsample_concat(h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """A U-shaped decoder's skip input: ``h`` resized bilinearly to
    ``skip``'s size (``align_corners=False``; no resize when the sizes
    agree), then concatenated with ``skip`` along the channels.

    With gradients off and bfloat16 on CUDA, one pass, the op
    :func:`~ctpn_tpu_torch.ops.resize_concat.resize_concat`, with the bits
    of the separate passes; otherwise (training, float32, the CPU)
    ``F.interpolate`` and ``torch.cat``.
    """
    if torch.is_grad_enabled() or h.dtype != torch.bfloat16 or not h.is_cuda:
        if h.shape[-2:] != skip.shape[-2:]:
            h = F.interpolate(h, size=skip.shape[-2:], mode="bilinear", align_corners=False)
        return torch.cat([h, skip], 1)
    return resize_concat(h.contiguous(memory_format=torch.channels_last),
                         skip.contiguous(memory_format=torch.channels_last))


class Conv1x1(Conv3x3):
    """1x1 conv with :class:`Conv3x3`'s dtype cast, ``per_image`` and
    ``conv_relu`` (EAST's merge branch)."""

    def __init__(self, cin: int, cout: int, per_image: bool = False):
        nn.Conv2d.__init__(self, cin, cout, 1, padding=0)
        self.per_image = per_image


class VGG16Trunk(nn.Module):
    """Feature extractor on NCHW tensors: (N, 3, H, W) -> (N, C, H/16, W/16).

    ``stages`` defaults to VGG16; tests substitute a narrow ladder with the
    same stride-16 pooling structure. ``fused_stem`` routes block 1
    through the fused stem kernel. ``pool_last`` pools after the last
    block too (stride 32, EAST's pool5), through the same pooled epilogue.
    """

    def __init__(
        self,
        stages: Tuple[Tuple[int, int, int], ...] = VGG_STAGES,
        fused_stem: bool = False,
        per_image_tail: bool = False,
        pool_last: bool = False,
    ):
        super().__init__()
        self.stages = tuple(stages)
        self.fused_stem = fused_stem
        self.pool_last = pool_last
        last = self.stages[-1][0]
        cin = 3  # BGR
        for block, reps, ch in self.stages:
            for rep in range(1, reps + 1):
                conv = Conv3x3(cin, ch, per_image=per_image_tail and block == last)
                self.add_module(f"conv{block}_{rep}", conv)
                cin = ch
        self.out_channels = cin

    def forward(self, x: torch.Tensor, remat: bool = False, taps=False,
                last_relu: bool = True):
        """``remat`` keeps only each block's input for the backward pass and
        recomputes the block there (training; same values). A block draws
        no random numbers, so the generator's state is not stashed: that
        would read the CUDA generator inside a captured step.

        ``taps`` True returns the list of the outputs of blocks 2 to the
        last (after their pools: with ``pool_last``, pool2-pool5 at strides
        4, 8, 16 and 32) in place of the last output alone. ``taps`` a tuple
        of conv names (``"conv2_2"``, ...; not in a fused block 1) returns
        those convs' outputs, after their ReLU and before any pool after
        them, in the trunk's order. ``last_relu=False`` leaves the ReLU off
        the last conv (CRAFT reads ``conv5_2`` before it)."""
        names = () if isinstance(taps, bool) else tuple(taps)
        outs = []
        for block, reps, _ in self.stages:
            bare = not last_relu and block == self.stages[-1][0]
            if block == 1 and self.fused_stem and reps == 2:
                x, read = self._fused_block1(x), ()
            elif remat:
                x, *read = checkpoint(self._block, block, reps, x, names, bare,
                                      use_reentrant=False, preserve_rng_state=False)
            else:
                x, *read = self._block(block, reps, x, names, bare)
            outs += read
            if taps is True and block >= 2:
                outs.append(x)
        return outs if taps is True or names else x

    def _block(self, block: int, reps: int, x: torch.Tensor, names=(), bare_last=False):
        """The block's convs: (output, outputs of the convs in ``names``);
        ``bare_last`` runs its last conv without its ReLU."""
        read = []
        for rep in range(1, reps + 1):
            name = f"conv{block}_{rep}"
            conv = getattr(self, name)
            # pools 1-4, after the block's last conv: stride 16 at conv5_3;
            # with pool_last a fifth, stride 32
            pool = rep == reps and (block < 5 or self.pool_last)
            tapped, bare = name in names, bare_last and rep == reps
            x = conv(x) if bare else conv.conv_relu(x, pool=pool and not tapped)
            if tapped:
                read.append(x)
            if pool and (tapped or bare):  # pooled after the read
                x = F.max_pool2d(x, 2, 2)
        return (x, *read)

    def _fused_block1(self, x: torch.Tensor) -> torch.Tensor:
        y = fused_stem_block(
            x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last),
            self.conv1_1.weight, self.conv1_1.bias,
            self.conv1_2.weight, self.conv1_2.bias,
        )
        return y.to(x.dtype)
