"""Fused greedy NMS: the keep mask over score-sorted boxes, with early exit.

Port of ``ctpn_tpu/ops/nms_fused.py::_fused_kernel`` (the Pallas TPU kernel
behind ``nms_keep_sorted_fused``, ``pl.pallas_call`` at ``nms_fused.py:212``).

* :func:`nms_keep_sorted_fused` is the wrapper around the op
  ``torch.ops.ctpn_torch.nms_keep_sorted_fused`` (registered here, so that
  ``torch.export`` keeps it as one node). A CUDA tensor launches the
  hand-written kernel ``ops/csrc/nms_fused.cu`` (a cluster of eight CTAs
  per image walks the 512-box blocks: the pair tests of a block are dealt
  over the cluster, one warp of the leader CTA resolves it exactly 32 boxes
  at a time in registers, early exit at ``max_keep``); a CPU tensor runs
  the plain version. There is no fallback from one to the other.
* :func:`nms_keep_sorted_fused_ref` is the plain PyTorch version: the same
  512-box block walk, vectorised over each block, with the in-block greedy
  solved as the unique fixed point of ``keep = base & ~any(S & keep)``.

What bounds the kernel on the H100 is the greedy recurrence's serial
dependence, not bytes (12000 boxes are 192 KB) or FLOPs (the pair tests
are about a microsecond of the card's f32 rate): see the source's header.

Contract (both versions): boxes (B, K, 4) f32 and valid (B, K) bool,
sorted by score descending, give keep (B, K) bool; the IoU test is
``inter >= t * union`` with +1-pixel areas and union clamped at 1e-10; the
first ``max_keep`` survivors of each image are exactly the greedy ones
(``max_keep`` None or <= 0: all survivors). The kernel stops at exactly
``max_keep`` kept boxes; the plain version, like the TPU kernel, may keep
the rest of the block in which the cap is reached. Flags after the
``max_keep``-th kept box are not part of the contract.
"""

from __future__ import annotations

from typing import Optional

import torch

from ctpn_tpu_torch.ops import _kernel
from ctpn_tpu_torch.ops._kernel import FLOAT, INT, PTR

BLOCK = 512  # boxes per block of the kernel's walk
CLUSTER = 8  # CTAs per image; each keeps its own copy of the kept-box list
# caps above this keep the kernel's kept-box lists in global scratch
# instead of shared memory (16 B per box; 227 KB per CTA)
SMEM_KEPT_MAX = 8192


def _suppress(rows: torch.Tensor, cols: torch.Tensor, thresh: float) -> torch.Tensor:
    """(..., R, C) bool: IoU(rows[i], cols[j]) >= thresh, divide-free, +1
    areas, for rows (..., R, 4) and cols (..., C, 4).

    Each step is one rounded f32 operation, in the order of the TPU kernels
    and of ``nms_fused.cu`` / ``nms_bitmask.cu``, so all agree bit for bit.
    """
    iw = (
        torch.minimum(rows[..., :, None, 2], cols[..., None, :, 2])
        - torch.maximum(rows[..., :, None, 0], cols[..., None, :, 0])
        + 1.0
    )
    ih = (
        torch.minimum(rows[..., :, None, 3], cols[..., None, :, 3])
        - torch.maximum(rows[..., :, None, 1], cols[..., None, :, 1])
        + 1.0
    )
    inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
    area_r = (rows[..., 2] - rows[..., 0] + 1.0) * (rows[..., 3] - rows[..., 1] + 1.0)
    area_c = (cols[..., 2] - cols[..., 0] + 1.0) * (cols[..., 3] - cols[..., 1] + 1.0)
    union = torch.clamp(
        area_r[..., :, None] + area_c[..., None, :] - inter, min=1e-10
    )
    return inter >= thresh * union


def _cap(k: int, max_keep: Optional[int]) -> int:
    return k if max_keep is None or max_keep <= 0 else min(int(max_keep), k)


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    if valid.shape != boxes.shape[:2] or valid.dtype != torch.bool:
        raise ValueError(
            f"valid must be bool {tuple(boxes.shape[:2])}, got "
            f"{valid.dtype} {tuple(valid.shape)}"
        )
    if boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be float32, got {boxes.dtype}")
    if valid.device != boxes.device:
        raise ValueError("boxes and valid must be on the same device")


def nms_keep_sorted_fused_ref(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    thresh: float,
    max_keep: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel, on any device."""
    _check(boxes, valid)
    batch, k = valid.shape
    cap = _cap(k, max_keep)
    keep = torch.zeros_like(valid)
    idx = torch.arange(BLOCK, device=boxes.device)
    earlier = idx[None, :] < idx[:, None]  # [i, j]: j precedes i
    for n in range(batch):
        kept = boxes.new_zeros((0, 4))
        count = 0
        for lo in range(0, k, BLOCK):
            if count >= cap:
                break
            rows = boxes[n, lo:lo + BLOCK]
            r = rows.shape[0]
            base = valid[n, lo:lo + BLOCK]
            if count:
                base = base & ~_suppress(rows, kept, thresh).any(dim=1)
            # s[i, j]: candidate j (earlier in the block) suppresses row i
            s = _suppress(rows, rows, thresh) & earlier[:r, :r] & base[None, :]
            act = base
            while True:  # converges in <= r steps; the fixed point is greedy
                nxt = base & ~(s & act[None, :]).any(dim=1)
                if torch.equal(nxt, act):
                    break
                act = nxt
            kept_b = act & (torch.cumsum(act, dim=0) <= cap - count)
            keep[n, lo:lo + r] = kept_b
            kept = torch.cat([kept, rows[kept_b]])
            count += int(kept_b.sum())
    return keep


_KERNEL = _kernel.Entry("nms_fused", [PTR, PTR, PTR, PTR, INT, INT, INT, FLOAT])


def _launch(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    thresh: float,
    max_keep: Optional[int],
) -> torch.Tensor:
    """The op's CUDA implementation: launch the kernel or raise."""
    _check(boxes, valid)
    dev = boxes.device
    batch, k = valid.shape
    keep = torch.zeros((batch, k), dtype=torch.bool, device=dev)
    if batch == 0 or k == 0:
        return keep
    cap = _cap(k, max_keep)
    scratch = (
        torch.empty((batch, CLUSTER, cap, 4), dtype=torch.float32, device=dev)
        if cap > SMEM_KEPT_MAX
        else None
    )
    _KERNEL(dev, boxes.contiguous(), valid.contiguous(), keep, scratch, batch, k, cap,
            float(thresh))
    return keep


def _fake(boxes, valid, thresh, max_keep):
    _check(boxes, valid)
    return torch.empty_like(valid)


_kernel.op(
    "nms_keep_sorted_fused(Tensor boxes, Tensor valid, float thresh, int? max_keep)"
    " -> Tensor",
    cpu=nms_keep_sorted_fused_ref, cuda=_launch, fake=_fake,
)


@_KERNEL.counts
def nms_keep_sorted_fused(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    thresh: float,
    max_keep: Optional[int] = None,
) -> torch.Tensor:
    """Batched greedy-NMS keep mask, boxes pre-sorted by score descending.

    boxes: (B, K, 4) f32; valid: (B, K) bool -> keep (B, K) bool. Calls the
    op ``torch.ops.ctpn_torch.nms_keep_sorted_fused``: CPU tensors run
    :func:`nms_keep_sorted_fused_ref`; CUDA tensors launch the kernel
    (adding one to ``nms_keep_sorted_fused.LAUNCHES`` and
    ``LAUNCHES_BY_DEVICE``, see ``ops/_launches.py``) or raise.
    """
    _check(boxes, valid)
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nms_keep_sorted_fused: unsupported device {boxes.device}")
    return torch.ops.ctpn_torch.nms_keep_sorted_fused(
        boxes, valid, float(thresh), None if max_keep is None else int(max_keep)
    )
