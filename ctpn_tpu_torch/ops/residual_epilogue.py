"""The tail of a ResNet bottleneck in one pass: conv3's bias, the identity's
bias, the residual sum and the ReLU.

Replaces no Pallas kernel: the JAX package runs no ResNet. On the card
PyTorch runs DBNet's bottleneck (``models/resnet.py``) as a cuDNN conv3
without its bias, the broadcast add of the bias, the same for the strided
projection of a stage's first block, the sum with the identity and the
ReLU: four passes over the block's widest map. This op is those passes in
one.

* :func:`residual_epilogue` is the wrapper around the op
  ``torch.ops.ctpn_torch.residual_epilogue``. A CUDA tensor launches the
  hand-written kernel ``residual_epilogue_kernel`` of
  ``ops/csrc/conv_epilogue.cu`` (a thread per 16-byte vector of 8
  channels of a pixel, streaming loads of both inputs, a grid-stride loop
  over the pixels); a CPU tensor runs the plain version. There is no
  fallback from one to the other.
* :func:`residual_epilogue_ref` is the plain PyTorch version: the passes
  as the bottleneck ran them.

Contract (both versions): ``y`` and ``identity`` (N, C, H, W) bf16 of one
shape in ``channels_last`` memory on one device, C a multiple of 8;
``bias`` and ``identity_bias`` (C,) bf16 on that device, or None for none;
``ValueError`` otherwise. The output, in ``channels_last``, is
``relu(bf16(bf16(y + bias) + bf16(identity + identity_bias)))``, each add
done in float and rounded to bf16 as PyTorch's add does it, the ReLU as
``clamp_min`` applies it (a NaN passes, signed zeros as it leaves them).
The kernel gives the plain version's bits; a missing bias adds -0.0.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ctpn_tpu_torch.ops import _kernel
from ctpn_tpu_torch.ops._kernel import INT, PTR

VEC = 8  # bf16 channels per 16-byte vector of the kernel


def _check(y: torch.Tensor, bias: Optional[torch.Tensor], identity: torch.Tensor,
           identity_bias: Optional[torch.Tensor]) -> None:
    for name, t in (("y", y), ("identity", identity)):
        if t.ndim != 4:
            raise ValueError(f"{name} must be (N, C, H, W), got {tuple(t.shape)}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"residual_epilogue: unsupported device {t.device}")
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{name} must be channels_last")
    if identity.shape != y.shape:
        raise ValueError(f"identity must be {tuple(y.shape)}, got {tuple(identity.shape)}")
    if identity.device != y.device:
        raise ValueError(f"identity must be on {y.device}, got {identity.device}")
    c = y.shape[1]
    if c % VEC or c == 0:
        raise ValueError(f"C must be a positive multiple of {VEC}, got {c}")
    for name, b in (("bias", bias), ("identity_bias", identity_bias)):
        if b is None:
            continue
        if tuple(b.shape) != (c,) or b.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be ({c},) bfloat16, got {tuple(b.shape)} {b.dtype}")
        if b.device != y.device:
            raise ValueError(f"{name} must be on {y.device}, got {b.device}")


def _out_like(y: torch.Tensor) -> torch.Tensor:
    return torch.empty(y.shape, dtype=torch.bfloat16, device=y.device,
                       memory_format=torch.channels_last)


def residual_epilogue_ref(y: torch.Tensor, bias: Optional[torch.Tensor], identity: torch.Tensor,
                          identity_bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version, on any device: each bias add, the sum and
    ``F.relu`` as separate passes."""
    _check(y, bias, identity, identity_bias)
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    if identity_bias is not None:
        identity = identity + identity_bias.view(1, -1, 1, 1)
    return F.relu(y + identity).contiguous(memory_format=torch.channels_last)


_KERNEL = _kernel.Entry("residual_epilogue", [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT],
                        source="conv_epilogue")


def _launch(y: torch.Tensor, bias: Optional[torch.Tensor], identity: torch.Tensor,
            identity_bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The op's CUDA implementation: launch the kernel or raise."""
    _check(y, bias, identity, identity_bias)
    for b in (bias, identity_bias):
        if b is not None and not b.is_contiguous():
            raise ValueError("residual_epilogue: biases must be contiguous on CUDA")
    if y.data_ptr() % 16 or identity.data_ptr() % 16:
        raise ValueError("residual_epilogue: y and identity must be 16-byte aligned on CUDA")
    out = _out_like(y)
    n, c, h, w = out.shape
    if n * h * w >= 2 ** 31:
        raise ValueError(f"residual_epilogue: {n * h * w} pixels, at most 2**31 - 1")
    if out.numel() == 0:
        return out
    _KERNEL(y.device, y, bias, identity, identity_bias, out, n, c, h, w)
    return out


def _fake(y, bias, identity, identity_bias):
    _check(y, bias, identity, identity_bias)
    return _out_like(y)


_kernel.op("residual_epilogue(Tensor y, Tensor? bias, Tensor identity, Tensor? identity_bias) "
           "-> Tensor", cpu=residual_epilogue_ref, cuda=_launch, fake=_fake)


@_KERNEL.counts
def residual_epilogue(y: torch.Tensor, bias: Optional[torch.Tensor], identity: torch.Tensor,
                      identity_bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``relu((y + bias) + (identity + identity_bias))``: (N, C, H, W) bf16
    channels_last maps of one shape -> the same.

    Calls the op ``torch.ops.ctpn_torch.residual_epilogue``: CPU tensors
    run :func:`residual_epilogue_ref`; CUDA tensors launch the kernel
    (adding one to ``residual_epilogue.LAUNCHES`` and
    ``LAUNCHES_BY_DEVICE``, see ``ops/_launches.py``) or raise.
    """
    _check(y, bias, identity, identity_bias)
    return torch.ops.ctpn_torch.residual_epilogue(y, bias, identity, identity_bias)
