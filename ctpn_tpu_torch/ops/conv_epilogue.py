"""A VGG conv's epilogue in one pass: bias, ReLU and the 2x2/2 max-pool.

Replaces no Pallas kernel: on the TPU, XLA fuses the trunk's bias, ReLU and
pool into the convolution. On the card PyTorch runs cuDNN's conv without
the bias, then adds the bias, applies the ReLU and pools in three passes
over the activations; this op is those three passes in one.

* :func:`conv_epilogue` is the wrapper around the op
  ``torch.ops.ctpn_torch.conv_epilogue``. A CUDA tensor launches the
  hand-written kernel ``ops/csrc/conv_epilogue.cu`` (a thread per 16-byte
  vector of 8 channels of an output pixel, streaming loads, a grid-stride
  loop over the pixels); a CPU tensor runs the plain version. There is no
  fallback from one to the other.
* :func:`conv_epilogue_ref` is the plain PyTorch version: the three
  passes as the trunk ran them.

Contract (both versions): ``y`` (N, C, H, W) bf16 in ``channels_last``
memory, C a multiple of 8; ``bias`` (C,) bf16 on ``y``'s device, or None
for none; ``ValueError`` otherwise. The output, in ``channels_last``, is
``relu(bf16(float(y) + float(bias)))``, of ``y``'s shape, or with ``pool``
its 2x2/2 max-pool (floor: an odd last row or column is dropped),
(N, C, H // 2, W // 2). The kernel gives the plain version's bits: each
element is rounded and clamped as PyTorch's add and ReLU do (a NaN passes,
signed zeros as ``clamp_min`` leaves them), and the window is scanned as
PyTorch's max-pool scans it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ctpn_tpu_torch.ops import _kernel
from ctpn_tpu_torch.ops._kernel import INT, PTR

VEC = 8  # bf16 channels per 16-byte vector of the kernel


def _check(y: torch.Tensor, bias: Optional[torch.Tensor], pool: bool) -> None:
    if y.ndim != 4:
        raise ValueError(f"y must be (N, C, H, W), got {tuple(y.shape)}")
    if y.dtype != torch.bfloat16:
        raise ValueError(f"y must be bfloat16, got {y.dtype}")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_epilogue: unsupported device {y.device}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("y must be channels_last")
    c, h, w = y.shape[1:]
    if c % VEC or c == 0:
        raise ValueError(f"C must be a positive multiple of {VEC}, got {c}")
    if pool and (h < 2 or w < 2):
        raise ValueError(f"a 2x2 pool needs H, W >= 2, got {h}x{w}")
    if bias is None:
        return
    if tuple(bias.shape) != (c,) or bias.dtype != torch.bfloat16:
        raise ValueError(f"bias must be ({c},) bfloat16, got {tuple(bias.shape)} {bias.dtype}")
    if bias.device != y.device:
        raise ValueError(f"bias must be on {y.device}, got {bias.device}")


def _out_like(y: torch.Tensor, pool: bool) -> torch.Tensor:
    n, c, h, w = y.shape
    if pool:
        h, w = h // 2, w // 2
    return torch.empty((n, c, h, w), dtype=torch.bfloat16, device=y.device,
                       memory_format=torch.channels_last)


def conv_epilogue_ref(y: torch.Tensor, bias: Optional[torch.Tensor], pool: bool) -> torch.Tensor:
    """Plain PyTorch version, on any device: the bias add, ``F.relu`` and
    ``F.max_pool2d`` as separate passes."""
    _check(y, bias, pool)
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    y = F.relu(y)
    if pool:
        y = F.max_pool2d(y, 2, 2)
    return y.contiguous(memory_format=torch.channels_last)


_KERNEL = _kernel.Entry("conv_epilogue", [PTR, PTR, PTR, INT, INT, INT, INT, INT])


def _launch(y: torch.Tensor, bias: Optional[torch.Tensor], pool: bool) -> torch.Tensor:
    """The op's CUDA implementation: launch the kernel or raise."""
    _check(y, bias, pool)
    if bias is not None and not bias.is_contiguous():
        raise ValueError("conv_epilogue: bias must be contiguous on CUDA")
    if y.data_ptr() % 16:
        raise ValueError("conv_epilogue: y must be 16-byte aligned on CUDA")
    out = _out_like(y, pool)
    n, c, ho, wo = out.shape
    if n * ho * wo >= 2 ** 31:
        raise ValueError(f"conv_epilogue: {n * ho * wo} output pixels, at most 2**31 - 1")
    if out.numel() == 0:
        return out
    h, w = y.shape[2:]
    _KERNEL(y.device, y, bias, out, n, c, h, w, int(pool))
    return out


def _fake(y, bias, pool):
    _check(y, bias, pool)
    return _out_like(y, pool)


_kernel.op("conv_epilogue(Tensor y, Tensor? bias, bool pool) -> Tensor",
           cpu=conv_epilogue_ref, cuda=_launch, fake=_fake)


@_KERNEL.counts
def conv_epilogue(y: torch.Tensor, bias: Optional[torch.Tensor], pool: bool) -> torch.Tensor:
    """``relu(y + bias)``, then the 2x2/2 max-pool if ``pool``: (N, C, H, W)
    bf16 channels_last -> the same, or (N, C, H // 2, W // 2).

    Calls the op ``torch.ops.ctpn_torch.conv_epilogue``: CPU tensors run
    :func:`conv_epilogue_ref`; CUDA tensors launch the kernel (adding one
    to ``conv_epilogue.LAUNCHES`` and ``LAUNCHES_BY_DEVICE``, see
    ``ops/_launches.py``) or raise.
    """
    _check(y, bias, pool)
    return torch.ops.ctpn_torch.conv_epilogue(y, bias, pool)
