"""VGG block 1 fused: conv1_1 + ReLU + conv1_2 + ReLU + 2x2/2 max-pool.

Port of ``ctpn_tpu/ops/stem_pallas.py::_stem_kernel`` (the Pallas TPU
kernel behind ``fused_stem_block``, ``pl.pallas_call`` at
``stem_pallas.py:140``).

* :func:`fused_stem_block` is the wrapper around the op
  ``torch.ops.ctpn_torch.fused_stem_block``. A CUDA tensor launches the
  hand-written kernel ``ops/csrc/stem_fused.cu`` (a persistent CTA per SM
  that holds w2 in shared memory; producer warps run conv1_1 on the SIMT
  cores into one of two swizzled conv1 tiles while two consumer warpgroups
  run conv1_2 from the other as an implicit GEMM on ``wgmma``, with the
  pool in their register epilogue); a CPU tensor runs the plain version.
  There is no fallback from one to the other.
* :func:`pack_stem_weights` turns the four parameters into the kernel's
  layouts; :func:`packed_stem_weights` caches that per set of parameter
  tensors, so a forward pass packs nothing. The packing runs inside the
  op's CUDA implementation, so an exported program carries the raw
  parameters and packs them (once) where it runs.
* :func:`fused_stem_block_ref` is the plain PyTorch version: f32 on
  bf16-rounded inputs and weights, rounding to bf16 where the kernel does
  (``tests/test_stem.py::_stock`` computes the same). conv1_2 is
  ``F.conv2d``; conv1_1 sums its 27 products in a fixed order (below).

Contract (both versions): x (N, 3, H, W) bf16 with H % 8 == 0 and
W % 8 == 0 (``ValueError`` otherwise), weights in the port's ``Conv2d``
layout (w1 (64, 3, 3, 3), w2 (64, 64, 3, 3), OIHW, any float dtype; biases
(64,)). The output is (N, 64, H/2, W/2) bf16 in ``channels_last``:

1. conv1_1 with bf16 operands, f32 accumulation and the f32 bias, ReLU;
2. conv1 values centred outside the image are zero (SAME padding);
3. round to bf16;
4. conv1_2 with the same numerics, ReLU, round to bf16;
5. 2x2/2 max-pool.

conv1_1 adds its 27 products (exact in f32: bf16 x bf16) to zero in
(ky, kx, ci) order, then the bias; the kernel and the plain version do the
same, so their conv1 values agree bit for bit. This matters: with real
pixels a conv1 value of a few hundred has a bf16 ulp of 1-2, and a conv1
value that another order of summation rounds to the other bf16 neighbour
moves conv1_2 outputs near zero by w2 times that ulp, past the 1e-2
tolerance below. What remains between the two is conv1_2's order of
summation: at most one bf16 ulp of each output, a relative error
``|a-b|/(|b|+1)`` below 2**-7.

The bf16 roundings apply whatever the trunk's compute dtype: with
``COMPUTE_DTYPE = float32`` the block's output is bf16 values cast back,
as in the JAX package (``ctpn_tpu/models/vgg.py:166``). The kernel needs
x in ``channels_last`` (NHWC in memory); the plain version takes any
layout.
"""

from __future__ import annotations

import threading
import weakref
from typing import Tuple

import torch
import torch.nn.functional as F

from ctpn_tpu_torch.ops import _kernel, _launches
from ctpn_tpu_torch.ops._kernel import INT, PTR

CH = 64  # output channels of both convs (VGG16's block 1)
CIN = 3


def _check(x, w1, b1, w2, b2) -> None:
    if x.ndim != 4 or x.shape[1] != CIN:
        raise ValueError(f"x must be (N, 3, H, W), got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    h, w = x.shape[2:]
    if h % 8 or w % 8:
        raise ValueError(f"stem geometry must have H%8==0, W%8==0; got {h}x{w}")
    shapes = {"w1": (w1, (CH, CIN, 3, 3)), "b1": (b1, (CH,)),
              "w2": (w2, (CH, CH, 3, 3)), "b2": (b2, (CH,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and widen back to f32 (exact)."""
    return t.to(torch.bfloat16).float()


def fused_stem_block_ref(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of the stem kernel, on any device.

    Both convs run in f32 on bf16 values. On the card cuDNN may run the f32
    conv1_2 in TF32, whose operands keep 10 mantissa bits: bf16 values (8
    bits) pass through exactly, so the products stay exact either way.
    """
    _check(x, w1, b1, w2, b2)
    n, _, h, w = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1))
    w1r = _bf16(w1)
    acc = xp.new_zeros((n, CH, h, w))
    for ky in range(3):  # conv1_1 in the kernel's order of summation
        for kx in range(3):
            for ci in range(CIN):
                acc += xp[:, ci:ci + 1, ky:ky + h, kx:kx + w] * w1r[:, ci, ky, kx].view(1, CH, 1, 1)
    y = F.relu(acc + b1.float().view(1, CH, 1, 1))
    y = F.relu(F.conv2d(_bf16(y), _bf16(w2), b2.float(), padding=1))
    y = F.max_pool2d(_bf16(y), 2, 2).to(torch.bfloat16)
    return y.contiguous(memory_format=torch.channels_last)


def pack_stem_weights(
    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's layouts of the block's parameters, on their device.

    * ``w1k`` (27, 64) f32 holding bf16 values: row (ky * 3 + kx) * 3 + ci,
      column co.
    * ``w2k`` (9, 64, 8, 8) bf16: ``w2k[tap, co, q, e]`` is
      ``w2[co, 8 * (q ^ (co & 7)) + e, ky, kx]`` with tap = ky * 3 + kx. A
      (tap, co) row is the 128 bytes of one output channel's 64 inputs, and
      its 16-byte chunks are XOR-swizzled by ``co & 7``: the bytes land in
      shared memory as they are, in the 128-byte-swizzled K-major layout
      that ``wgmma`` reads as B.
    * ``b1k``, ``b2k`` (64,) f32.
    """
    w1k = _bf16(w1).permute(2, 3, 1, 0).reshape(9 * CIN, CH).contiguous()
    rows = w2.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, CH, CH // 8, 8)
    co = torch.arange(CH, device=w2.device)
    chunk = torch.arange(CH // 8, device=w2.device)
    src = chunk[None, :] ^ (co[:, None] & 7)  # logical chunk at each position
    w2k = rows[:, co[:, None], src].contiguous()
    return w1k, b1.float().contiguous(), w2k, b2.float().contiguous()


_PACKED_MAX = 8  # sets of parameters kept packed (a process serves few models)
_packed: dict = {}
_packed_lock = threading.Lock()


def _stamp(t: torch.Tensor) -> tuple:
    return (t._version, t.data_ptr(), t.device, t.dtype)


def packed_stem_weights(w1, b1, w2, b2) -> tuple:
    """:func:`pack_stem_weights`, cached on the four tensors' identity.

    An entry is reused while the same tensor objects are alive and hold the
    same version, storage, device and dtype: an in-place update (an
    optimizer step, ``load_state_dict``) bumps the version, and ``.to()``
    moves the storage, so either packs anew. Inference tensors track no
    version and are packed on every call.
    """
    params = (w1, b1, w2, b2)
    if any(t.is_inference() for t in params):
        return pack_stem_weights(*params)
    key = tuple(id(t) for t in params)
    stamps = tuple(_stamp(t) for t in params)
    with _packed_lock:
        hit = _packed.get(key)
        if hit is not None:
            refs, old_stamps, packed = hit
            if old_stamps == stamps and all(r() is t for r, t in zip(refs, params)):
                return packed
            del _packed[key]
        packed = pack_stem_weights(*params)
        while len(_packed) >= _PACKED_MAX:
            _packed.pop(next(iter(_packed)))
        _packed[key] = (tuple(weakref.ref(t) for t in params), stamps, packed)
        return packed


_KERNEL = _kernel.Entry("stem_fused", [PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT])


def _out_like(x: torch.Tensor) -> torch.Tensor:
    n, _, h, w = x.shape
    return torch.empty(
        (n, CH, h // 2, w // 2), dtype=torch.bfloat16, device=x.device,
        memory_format=torch.channels_last,
    )


def _launch(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
) -> torch.Tensor:
    """The op's CUDA implementation: pack the weights (cached), launch the
    kernel or raise."""
    _check(x, w1, b1, w2, b2)
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_stem_block: x must be channels_last on CUDA")
    n, _, h, w = x.shape
    out = _out_like(x)
    if n == 0:
        return out
    packed = packed_stem_weights(w1, b1, w2, b2)
    # a captured launch reads them on every replay: the capture keeps them
    # (the cache may drop them)
    _launches.hold(*packed)
    _KERNEL(x.device, x, *packed, out, n, h, w)
    return out


def _fake(x, w1, b1, w2, b2):
    _check(x, w1, b1, w2, b2)
    return _out_like(x)


_kernel.op("fused_stem_block(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) -> Tensor",
           cpu=fused_stem_block_ref, cuda=_launch, fake=_fake)


@_KERNEL.counts
def fused_stem_block(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
) -> torch.Tensor:
    """VGG block 1, (N, 3, H, W) bf16 -> (N, 64, H/2, W/2) bf16 channels_last.

    Calls the op ``torch.ops.ctpn_torch.fused_stem_block``: CPU tensors run
    :func:`fused_stem_block_ref`; CUDA tensors launch the kernel (adding one
    to ``fused_stem_block.LAUNCHES`` and
    ``LAUNCHES_BY_DEVICE``, see ``ops/_launches.py``) or raise.
    """
    _check(x, w1, b1, w2, b2)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_stem_block: unsupported device {x.device}")
    return torch.ops.ctpn_torch.fused_stem_block(x, w1, b1, w2, b2)
