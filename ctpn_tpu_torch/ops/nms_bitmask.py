"""NMS suppression bitmask: bit j of row i says "box i suppresses box j".

Port of ``ctpn_tpu/ops/nms_pallas.py::_bitmask_kernel`` (the Pallas TPU
kernel behind ``suppression_bitmask_pallas``, ``pl.pallas_call`` at
``nms_pallas.py:129``), whose contract is ``ctpn_tpu/ops/nms.py::
suppression_bitmask_jnp``.

* :func:`suppression_bitmask` is the wrapper around the op
  ``torch.ops.ctpn_torch.suppression_bitmask``. A CUDA tensor launches the
  hand-written kernel ``ops/csrc/nms_bitmask.cu`` (a CTA per 64 rows walks
  tiles of 1024 columns, lanes over columns: four compares per pair drop
  the pairs whose extents do not overlap, each lane runs the exact test on
  the pairs it has left, ballots transpose the bits into words; tiles
  below the diagonal are only zero-filled); a CPU tensor runs the plain
  version. There is no fallback from one to the other.
* :func:`suppression_bitmask_ref` is the plain PyTorch version: the pair
  test of ``suppression_bitmask_jnp``, blocked over rows and batched over
  images, packed into words.

Contract (both versions): boxes (B, N, 4) f32 and valid (B, N) bool, sorted
by score descending, give mask (B, N, ceil(N/32)) int32. Bit ``j % 32`` of
word ``j // 32`` in row ``i`` is set exactly when ``j > i``, both boxes are
valid and ``inter >= t * max(area_i + area_j - inter, 1e-10)`` with +1-pixel
areas. The words are the JAX package's uint32 words reinterpreted as int32:
PyTorch's uint32 lacks shifts and most other operations on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ctpn_tpu_torch.ops import _kernel
from ctpn_tpu_torch.ops._kernel import FLOAT, INT, PTR
from ctpn_tpu_torch.ops.nms_fused import _check, _suppress

BITS = 32
ROW_BLOCK = 512  # rows per step of the plain version (bounds its memory)

# bit k of a word as an int32 (bit 31 is the sign bit)
_BIT_WEIGHTS = torch.from_numpy(
    (np.uint32(1) << np.arange(BITS, dtype=np.uint32)).view(np.int32)
)


def num_words(n: int) -> int:
    return (n + BITS - 1) // BITS


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32 * W) bool -> (..., W) int32, bit k of word w = column
    32 * w + k."""
    shape = bits.shape[:-1] + (bits.shape[-1] // BITS, BITS)
    weights = _BIT_WEIGHTS.to(bits.device)
    # distinct bits: every partial sum stays in int32 range (bit 31 is the
    # only negative term), so the sum is the packed word
    return torch.where(bits.reshape(shape), weights, 0).sum(-1, dtype=torch.int32)


def suppression_bitmask_ref(
    boxes: torch.Tensor, valid: torch.Tensor, thresh: float
) -> torch.Tensor:
    """Plain PyTorch version of the bitmask kernel, on any device."""
    _check(boxes, valid)
    batch, n = valid.shape
    words = num_words(n)
    n_pad = words * BITS
    cols = torch.cat([boxes, boxes.new_zeros((batch, n_pad - n, 4))], dim=1)
    col_valid = torch.cat([valid, valid.new_zeros((batch, n_pad - n))], dim=1)
    col_idx = torch.arange(n_pad, device=boxes.device)
    out = torch.empty((batch, n, words), dtype=torch.int32, device=boxes.device)
    for r0 in range(0, n, ROW_BLOCK):
        rows = boxes[:, r0:r0 + ROW_BLOCK]
        r = rows.shape[1]
        row_idx = torch.arange(r0, r0 + r, device=boxes.device)
        supp = (
            _suppress(rows, cols, thresh)
            & (col_idx[None, :] > row_idx[:, None])[None]
            & valid[:, r0:r0 + r, None]
            & col_valid[:, None, :]
        )
        out[:, r0:r0 + r] = pack_bits(supp)
    return out


_KERNEL = _kernel.Entry("nms_bitmask", [PTR, PTR, PTR, INT, INT, FLOAT])


def _launch(boxes: torch.Tensor, valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """The op's CUDA implementation: launch the kernel or raise."""
    _check(boxes, valid)
    dev = boxes.device
    batch, n = valid.shape
    mask = torch.empty((batch, n, num_words(n)), dtype=torch.int32, device=dev)
    if batch == 0 or n == 0:
        return mask
    _KERNEL(dev, boxes.contiguous(), valid.contiguous(), mask, batch, n, float(thresh))
    return mask


def _fake(boxes, valid, thresh):
    _check(boxes, valid)
    batch, n = valid.shape
    return boxes.new_empty((batch, n, num_words(n)), dtype=torch.int32)


_kernel.op("suppression_bitmask(Tensor boxes, Tensor valid, float thresh) -> Tensor",
           cpu=suppression_bitmask_ref, cuda=_launch, fake=_fake)


@_KERNEL.counts
def suppression_bitmask(
    boxes: torch.Tensor, valid: torch.Tensor, thresh: float
) -> torch.Tensor:
    """(B, N, ceil(N/32)) int32 suppression bitmask of score-sorted boxes.

    boxes: (B, N, 4) f32; valid: (B, N) bool. Calls the op
    ``torch.ops.ctpn_torch.suppression_bitmask``: CPU tensors run
    :func:`suppression_bitmask_ref`; CUDA tensors launch the kernel (adding
    one to ``suppression_bitmask.LAUNCHES`` and
    ``LAUNCHES_BY_DEVICE``, see ``ops/_launches.py``) or raise.
    """
    _check(boxes, valid)
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"suppression_bitmask: unsupported device {boxes.device}")
    return torch.ops.ctpn_torch.suppression_bitmask(boxes, valid, float(thresh))
