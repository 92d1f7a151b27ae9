"""A U-shaped decoder's skip input in one pass: the running map resized
bilinearly to the skip's size and concatenated with the skip.

Replaces no Pallas kernel: on the TPU, XLA fuses the resize into the
concatenation. On the card PyTorch resizes (``F.interpolate``, bilinear,
``align_corners=False``) into a new tensor and then concatenates
(``torch.cat``), which reads that tensor and the skip back and writes both
again; this op writes the resized map straight into its channel slice of
the concatenated buffer and copies the skip into the other, in one pass.
CRAFT's decoder (``models/craft.py``, four blocks) and EAST's merge branch
(``models/east.py``, three stages) call it.

* :func:`resize_concat` is the wrapper around the op
  ``torch.ops.ctpn_torch.resize_concat``. A CUDA tensor launches the
  hand-written kernel ``ops/csrc/resize_concat.cu`` (a block per output
  row at a time, a thread per 16-byte vector of 8 channels of a pixel,
  the row's resized vectors before its skip vectors); a CPU tensor runs
  :func:`resize_concat_ref`, the plain version. There is no fallback from
  one to the other.
* :func:`resize_concat_ref` is the plain version: the two PyTorch calls.

Contract (both versions): ``h`` (N, C1, h, w) and ``skip`` (N, C2, H, W),
both bf16 in ``channels_last`` memory on one device, C1 and C2 positive
multiples of 8; ``ValueError`` otherwise. The output, in
``channels_last``, is (N, C1 + C2, H, W): ``torch.cat([F.interpolate(h,
size=(H, W), mode="bilinear", align_corners=False), skip], 1)``, or
``torch.cat([h, skip], 1)`` when (h, w) == (H, W) (no resize: a copy, as
CRAFT's first block has always run). The path is chosen by the shapes
alone. The kernel gives the plain version's bits: each resized element is
ATen's blend in float, in ATen's order of fused multiply-adds, rounded to
bf16 once; a NaN or inf in ``h`` spreads as it does there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ctpn_tpu_torch.ops import _kernel
from ctpn_tpu_torch.ops._kernel import INT, PTR

VEC = 8  # bf16 channels per 16-byte vector of the kernel


def _check(h: torch.Tensor, skip: torch.Tensor) -> None:
    for name, t in (("h", h), ("skip", skip)):
        if t.ndim != 4:
            raise ValueError(f"{name} must be (N, C, H, W), got {tuple(t.shape)}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"resize_concat: unsupported device {t.device}")
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{name} must be channels_last")
        c = t.shape[1]
        if c % VEC or c == 0:
            raise ValueError(f"{name}'s C must be a positive multiple of {VEC}, got {c}")
    if skip.device != h.device:
        raise ValueError(f"skip must be on {h.device}, got {skip.device}")
    if skip.shape[0] != h.shape[0]:
        raise ValueError(f"batch mismatch: h {h.shape[0]}, skip {skip.shape[0]}")
    if min(h.shape[2:]) == 0 and min(skip.shape[2:]) > 0:
        raise ValueError(f"cannot resize an empty {tuple(h.shape[2:])} map")


def _out_like(h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    n, c2, hh, ww = skip.shape
    return torch.empty((n, h.shape[1] + c2, hh, ww), dtype=torch.bfloat16, device=h.device,
                       memory_format=torch.channels_last)


def resize_concat_ref(h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, on any device: ``F.interpolate`` (unless the
    sizes already agree) and ``torch.cat``."""
    _check(h, skip)
    if h.shape[2:] != skip.shape[2:]:
        h = F.interpolate(h, size=skip.shape[2:], mode="bilinear", align_corners=False)
    return torch.cat([h, skip], 1).contiguous(memory_format=torch.channels_last)


_KERNEL = _kernel.Entry("resize_concat", [PTR, PTR, PTR] + [INT] * 7)


def _launch(h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """The op's CUDA implementation: launch the kernel or raise."""
    _check(h, skip)
    if h.data_ptr() % 16 or skip.data_ptr() % 16:
        raise ValueError("resize_concat: h and skip must be 16-byte aligned on CUDA")
    out = _out_like(h, skip)
    n, c1, hi, wi = h.shape
    c2, ho, wo = skip.shape[1:]
    if max(n * ho, n * hi, wo * (c1 + c2) // VEC) >= 2 ** 31:
        raise ValueError(f"resize_concat: {n * ho} rows of {wo * (c1 + c2) // VEC} vectors "
                         f"from {n * hi} rows, each at most 2**31 - 1")
    if out.numel() == 0:
        return out
    _KERNEL(h.device, h, skip, out, n, c1, c2, hi, wi, ho, wo)
    return out


def _fake(h, skip):
    _check(h, skip)
    return _out_like(h, skip)


_kernel.op("resize_concat(Tensor h, Tensor skip) -> Tensor",
           cpu=resize_concat_ref, cuda=_launch, fake=_fake)


@_KERNEL.counts
def resize_concat(h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """``cat([resize(h, skip's H, W), skip], 1)``: (N, C1, h, w) and (N, C2,
    H, W) bf16 channels_last -> (N, C1 + C2, H, W) channels_last.

    Calls the op ``torch.ops.ctpn_torch.resize_concat``: CPU tensors run
    :func:`resize_concat_ref`; CUDA tensors launch the kernel (adding one
    to ``resize_concat.LAUNCHES`` and ``LAUNCHES_BY_DEVICE``, see
    ``ops/_launches.py``) or raise.
    """
    _check(h, skip)
    return torch.ops.ctpn_torch.resize_concat(h, skip)
