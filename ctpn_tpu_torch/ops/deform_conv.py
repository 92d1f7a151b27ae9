"""DCNv2's modulated deformable 3x3 conv (Dai et al., ICCV 2017; Zhu et
al., CVPR 2019): DBNet's ResNet-50 runs it as the 3x3 conv of every
bottleneck of stages 2-4, ``layer2``-``layer4`` (MhLiao/DB
``backbones/resnet.py``, 13 sites).

No TPU counterpart: the JAX package runs CTPN only. The conv samples its
input at points that the data moves (offsets a small conv predicts for
every output pixel), so no conv library computes it.

* :func:`deform_conv` is the wrapper around the op
  ``torch.ops.ctpn_torch.deform_conv``. A CUDA tensor launches the
  hand-written sampling kernel ``ops/csrc/deform_conv.cu`` into a column
  buffer, then multiplies it by the weights, a bf16 GEMM per image
  (cuBLAS: an image's output is the same in any slot of any batch); a CPU
  tensor runs :func:`deform_conv_ref`. There is no fallback from one to the
  other.
* :func:`deform_conv_ref` is the plain PyTorch version, on any device and
  in any float dtype: the corners gathered with ``index_select``, the blend
  in float32, the product with ``torch.mm`` per image. With gradients on it
  is differentiable in the input, the offsets, the masks and the weights
  (the training script's deformable conv, in float32).

Contract: ``x`` (N, C, H, W), ``om`` (N, 27, Ho, Wo) float32 with ``Ho =
(H - 1) // stride + 1`` (likewise Wo; a 3x3 window, padding 1), ``weight``
(O, C, 3, 3), ``stride`` 1 or 2; ``ValueError`` otherwise. For tap ``k =
3 i + j`` of output pixel (yo, xo): ``dy = om[2k]``, ``dx = om[2k + 1]``,
``m = sigmoid(om[18 + k])``; the sample is at ``py = (yo * stride - 1 + i)
+ dy``, ``px = (xo * stride - 1 + j) + dx`` (float32); outside (``py <=
-1``, ``px <= -1``, ``py >= H`` or ``px >= W``) it reads 0, else the
bilinear blend ``((w1 v1 + w2 v2) + w3 v3) + w4 v4`` of the four corners
around it, a corner outside the map reading 0 (DCNv2's
``dmcn_im2col_bilinear``), times ``m``, each operation in float32, the
column rounded to ``x``'s dtype. ``out[o, p] = sum_{k, c} W[o, c, k] *
col[c, k, p]``, no bias: (N, O, Ho, Wo) in ``x``'s dtype. The kernel takes
``x`` bf16 in ``channels_last`` memory with C a multiple of 8 and
``weight`` bf16, and answers in ``channels_last``; its columns are the
plain version's but where the sigmoid's ``exp`` differs by an ulp.
"""

from __future__ import annotations

import torch

from ctpn_tpu_torch.ops import _kernel
from ctpn_tpu_torch.ops._kernel import INT, PTR

TAPS = 9
OFFSETS = 27  # 9 (dy, dx) pairs, then 9 mask logits
VEC = 8  # bf16 channels per 16-byte vector of the kernel


def out_size(h: int, w: int, stride: int):
    """The output's (Ho, Wo) of a 3x3 window, padding 1."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def _check(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor, stride: int) -> None:
    if x.ndim != 4 or not x.is_floating_point():
        raise ValueError(f"x must be a float (N, C, H, W), got {x.dtype} {tuple(x.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    n, c, h, w = x.shape
    want = (n, OFFSETS, *out_size(h, w, stride))
    if tuple(om.shape) != want or om.dtype != torch.float32:
        raise ValueError(f"om must be float32 {want}, got {om.dtype} {tuple(om.shape)}")
    if weight.ndim != 4 or tuple(weight.shape[1:]) != (c, 3, 3):
        raise ValueError(f"weight must be (O, {c}, 3, 3), got {tuple(weight.shape)}")
    if weight.dtype != x.dtype:
        raise ValueError(f"weight must be {x.dtype}, got {weight.dtype}")
    if not (x.device == om.device == weight.device):
        raise ValueError("x, om and weight must be on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"deform_conv: unsupported device {x.device}")


def packed_weight(weight: torch.Tensor) -> torch.Tensor:
    """(O, C, 3, 3) -> (O, 9 C), tap-major as the columns are."""
    return weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1).contiguous()


def _product(col: torch.Tensor, weight: torch.Tensor, ho: int, wo: int) -> torch.Tensor:
    """col (N, Ho * Wo, 9 C) times the packed weights, per image: (N, O,
    Ho, Wo) in ``channels_last`` memory."""
    wk = packed_weight(weight).t()
    n = col.shape[0]
    if torch.is_grad_enabled() and (col.requires_grad or weight.requires_grad):
        out = torch.stack([torch.mm(col[i], wk) for i in range(n)])
    else:
        out = col.new_empty((n, ho * wo, weight.shape[0]))
        for i in range(n):
            torch.mm(col[i], wk, out=out[i])
    return out.view(n, ho, wo, -1).permute(0, 3, 1, 2)


def sample_columns(x: torch.Tensor, om: torch.Tensor, stride: int) -> torch.Tensor:
    """The plain column buffer: (N, Ho * Wo, 9 C) in ``x``'s dtype, tap-major
    within a row, as the contract computes it."""
    n, c, h, w = x.shape
    ho, wo = om.shape[2:]
    dev = x.device
    dy, dx, mask = om[:, 0:18:2], om[:, 1:18:2], torch.sigmoid(om[:, 18:27])  # (N, 9, Ho, Wo)
    k = torch.arange(TAPS, device=dev)
    base_y = (torch.arange(ho, device=dev) * stride - 1)[None, :, None] + (k // 3)[:, None, None]
    base_x = (torch.arange(wo, device=dev) * stride - 1)[None, None, :] + (k % 3)[:, None, None]
    py = base_y.to(torch.float32)[None] + dy
    px = base_x.to(torch.float32)[None] + dx
    inside = (py > -1) & (px > -1) & (py < h) & (px < w)
    fy, fx = torch.floor(py), torch.floor(px)
    ly, lx = py - fy, px - fx
    hy, hx = 1 - ly, 1 - lx
    y0, x0 = fy.to(torch.int64), fx.to(torch.int64)
    flat = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
    img = (torch.arange(n, device=dev) * (h * w))[:, None, None, None]

    def corner(yy, xx):
        ok = inside & (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = img + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        got = flat.index_select(0, idx.reshape(-1)).view(*idx.shape, c).float()
        return torch.where(ok[..., None], got, 0.0)

    v1, v2 = corner(y0, x0), corner(y0, x0 + 1)
    v3, v4 = corner(y0 + 1, x0), corner(y0 + 1, x0 + 1)
    w1, w2 = (hy * hx)[..., None], (hy * lx)[..., None]
    w3, w4 = (ly * hx)[..., None], (ly * lx)[..., None]
    val = ((w1 * v1 + w2 * v2) + w3 * v3) + w4 * v4
    val = torch.where(inside[..., None], val * mask[..., None], 0.0)
    # (N, 9, Ho, Wo, C) -> (N, Ho * Wo, 9 C)
    return val.permute(0, 2, 3, 1, 4).reshape(n, ho * wo, TAPS * c).to(x.dtype)


def deform_conv_ref(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """Plain PyTorch version, on any device and float dtype (see the
    module's contract); answers in ``channels_last`` memory, as the kernel
    does."""
    _check(x, om, weight, stride)
    ho, wo = om.shape[2:]
    return _product(sample_columns(x, om, stride), weight, ho, wo)


_KERNEL = _kernel.Entry("deform_conv", [PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT])


def _launch(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor, stride: int) -> torch.Tensor:
    """The op's CUDA implementation: launch the sampling kernel, then the
    per-image GEMMs, or raise."""
    _check(x, om, weight, stride)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"deform_conv: x must be bfloat16 on CUDA, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("deform_conv: x must be channels_last on CUDA")
    n, c, h, w = x.shape
    if c % VEC or c == 0:
        raise ValueError(f"deform_conv: C must be a positive multiple of {VEC}, got {c}")
    if x.data_ptr() % 16:
        raise ValueError("deform_conv: x must be 16-byte aligned on CUDA")
    ho, wo = om.shape[2:]
    if n * ho * wo * TAPS * c >= 2 ** 62:
        raise ValueError("deform_conv: the column buffer is too large")
    col = torch.empty((n, ho * wo, TAPS * c), dtype=torch.bfloat16, device=x.device)
    if col.numel():
        offsets = om.permute(0, 2, 3, 1).contiguous()
        _KERNEL(x.device, x, offsets, col, n, c, h, w, ho, wo, int(stride))
    return _product(col, weight, ho, wo)


def _fake(x, om, weight, stride):
    _check(x, om, weight, stride)
    n, _, h, w = x.shape
    ho, wo = out_size(h, w, stride)
    return x.new_empty((n, weight.shape[0], ho, wo), memory_format=torch.channels_last)


_kernel.op("deform_conv(Tensor x, Tensor om, Tensor weight, int stride) -> Tensor",
           cpu=deform_conv_ref, cuda=_launch, fake=_fake)


@_KERNEL.counts
def deform_conv(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor,
                stride: int) -> torch.Tensor:
    """The modulated deformable 3x3 conv, no bias: (N, C, H, W) ->
    (N, O, Ho, Wo).

    Calls the op ``torch.ops.ctpn_torch.deform_conv``: CPU tensors run
    :func:`deform_conv_ref`; CUDA tensors launch the kernel (adding one to
    ``deform_conv.LAUNCHES`` and ``LAUNCHES_BY_DEVICE``) or raise.
    """
    _check(x, om, weight, stride)
    return torch.ops.ctpn_torch.deform_conv(x, om, weight, int(stride))
