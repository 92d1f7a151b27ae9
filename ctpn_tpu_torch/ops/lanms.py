"""Locality-aware NMS's walk (EAST, Zhou et al. 2017, Algorithm 1): the
cells' quads, in raster order, folded into the quad merged before them.

No TPU counterpart: the JAX package runs CTPN only. The walk is sequential
by definition (each cell is tested against the quad the cells before it
merged), so a captured program cannot run it as plain PyTorch ops without a
host sync per step; the card runs it as one kernel.

* :func:`lanms_walk` is the wrapper around the op
  ``torch.ops.ctpn_torch.lanms_walk``. A CUDA tensor launches the
  hand-written kernel in ``ops/csrc/quad_nms.cu`` (a CTA of four warps per
  image, 128 cells a step); a CPU tensor runs :func:`lanms_walk_ref`, the plain
  version, which takes the same steps for every image of the batch at
  once. There is no fallback from one to the other.

Contract (both versions): cells (B, M, 9) float32 ``[score, x1, y1, ...,
x4, y4]`` in raster order, the first ``count[b]`` (B,) int32 of each image
live. The walk keeps one open quad, held as the sums of the cells it folds:
``W = sum(s * q)`` over their vertices and ``S = sum(s)`` over their
scores, the quad being ``W / S``, their score-weighted mean. Cell 0 opens
it; a later cell whose ``quad_iou(cell, open quad) > t``
(``ops/quad_nms.py``, the cell clipped by the open quad) is folded in; any
other cell closes the open quad, which takes the next slot as ``[S, W /
S]``, and opens its own; the last open quad closes at the end. The sums
are taken as the kernel takes them, 128 cells a step: each cell of a step
is tested against ``(W + P) / (S + P_s)``, ``P`` the sums of the cells
before it in the step (:func:`_scan`'s order); the cells before the first
that does not fold are folded, and the next step starts after that cell
(or 128 on, if all fold).
Returns ``merged`` (B, K, 9) ``[score sum, quad]`` of the closed quads in
order, ``cells`` (B, K) int32 the number of cells each folds, ``count``
(B,) int32 the quads kept (at most ``cap`` = K) and ``overflow`` (B,)
int32 the quads closed past the cap, which are dropped. Slots past
``count`` are zero.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ctpn_tpu_torch.ops import _kernel
from ctpn_tpu_torch.ops._kernel import FLOAT, INT, PTR
from ctpn_tpu_torch.ops.quad_nms import quad_iou

Walk = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
WARPS = 4  # warps of the kernel's CTA that walk one image
LANES = 32 * WARPS  # cells a step of the walk tests


def _check(cells: torch.Tensor, count: torch.Tensor, cap: int) -> None:
    if cells.ndim != 3 or cells.shape[-1] != 9 or cells.dtype != torch.float32:
        raise ValueError(f"cells must be float32 (B, M, 9), got {cells.dtype} "
                         f"{tuple(cells.shape)}")
    if count.dtype != torch.int32 or tuple(count.shape) != (cells.shape[0],):
        raise ValueError(f"count must be int32 ({cells.shape[0]},), got {count.dtype} "
                         f"{tuple(count.shape)}")
    if count.device != cells.device:
        raise ValueError("cells and count must be on the same device")
    if cells.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lanms_walk: unsupported device {cells.device}")
    if cap < 1:
        raise ValueError(f"cap must be positive, got {cap}")


def _scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums over dim 1 (``LANES`` cells) in the kernel's
    order: in each warp of 32 a Hillis-Steele scan, ``x[k] += x[k - off]``
    for off = 1, 2, 4, 8, 16; then each warp's values plus the totals of the
    warps before it, summed in warp order."""
    g = x.reshape(x.shape[0], WARPS, 32, *x.shape[2:])
    for off in (1, 2, 4, 8, 16):
        g = torch.cat([g[:, :, :off], g[:, :, off:] + g[:, :, :-off]], 2)
    parts, before = [g[:, 0]], None
    for w in range(1, WARPS):
        last = g[:, w - 1, 31]
        before = last if before is None else before + last
        parts.append(g[:, w] + before[:, None])
    return torch.stack(parts, 1).reshape(x.shape)


def lanms_walk_ref(cells: torch.Tensor, count: torch.Tensor, thresh: float, cap: int) -> Walk:
    """Plain PyTorch version: the kernel's steps of 128 cells, every image
    at once."""
    _check(cells, count, cap)
    batch, m, dev = cells.shape[0], cells.shape[1], cells.device
    merged = torch.zeros((batch, cap + 1, 9), dtype=torch.float32, device=dev)
    ncells = torch.zeros((batch, cap + 1), dtype=torch.int32, device=dev)
    n = count.long()
    rows = torch.arange(batch, device=dev)
    lanes = torch.arange(LANES, device=dev)
    closed = torch.zeros(batch, dtype=torch.int64, device=dev)
    t32 = torch.tensor(thresh, dtype=torch.float32)
    padded = torch.cat([cells, cells.new_zeros((batch, LANES, 9))], 1)
    some = n > 0

    def close(which: torch.Tensor) -> None:
        nonlocal closed
        slot = torch.where(which, closed.clamp(max=cap), cap)  # slot cap: dropped
        merged[rows, slot] = torch.cat([S[:, None], W / S[:, None]], 1)
        ncells[rows, slot] = cnt
        closed = closed + which.long()

    S = padded[:, 0, 0].clone()
    W = S[:, None] * padded[:, 0, 1:]
    cnt = torch.ones(batch, dtype=torch.int32, device=dev)
    i = torch.ones(batch, dtype=torch.int64, device=dev)
    active = some & (i < n)
    while bool(active.any()):
        j = i[:, None] + lanes
        live = active[:, None] & (j < n[:, None])
        got = padded.gather(1, j.clamp(max=m + LANES - 1)[..., None].expand(-1, -1, 9))
        s = torch.where(live, got[..., 0], 0.0)
        q = torch.where(live[..., None], got[..., 1:], 0.0)
        v, vs = _scan(s[..., None] * q), _scan(s)
        e = torch.cat([v.new_zeros((batch, 1, 8)), v[:, :-1]], 1)
        es = torch.cat([vs.new_zeros((batch, 1)), vs[:, :-1]], 1)
        os_ = S[:, None] + es
        fold = live & (quad_iou(q, (W[:, None] + e) / os_[..., None]) > t32)
        stop = ~fold
        f = torch.where(stop.any(1), stop.int().argmax(1), LANES)
        last = (f - 1).clamp(min=0)
        grow = active & (f > 0)
        S = torch.where(grow, S + vs.gather(1, last[:, None])[:, 0], S)
        W = torch.where(grow[:, None], W + v.gather(1, last[:, None, None].expand(-1, 1, 8))[:, 0], W)
        cnt = torch.where(grow, cnt + f.int(), cnt)
        shut = active & (f < LANES) & (i + f < n)
        ends = active & (f < LANES) & (i + f >= n)  # every live cell folded
        close(shut)
        first = f.clamp(max=LANES - 1)
        s0 = s.gather(1, first[:, None])[:, 0]
        q0 = q.gather(1, first[:, None, None].expand(-1, 1, 8))[:, 0]
        S = torch.where(shut, s0, S)
        W = torch.where(shut[:, None], s0[:, None] * q0, W)
        cnt = torch.where(shut, 1, cnt)
        i = torch.where(active & (f == LANES), i + LANES, i)
        i = torch.where(shut, i + f + 1, i)
        i = torch.where(ends, n, i)
        active = some & (i < n)
    close(some)
    kept = closed.clamp(max=cap)
    return (merged[:, :cap].contiguous(), ncells[:, :cap].contiguous(),
            kept.to(torch.int32), (closed - kept).to(torch.int32))


_KERNEL = _kernel.Entry("lanms_walk", [PTR] * 6 + [INT, INT, INT, FLOAT], source="quad_nms")


def _launch(cells: torch.Tensor, count: torch.Tensor, thresh: float, cap: int) -> Walk:
    """The op's CUDA implementation: launch the kernel or raise."""
    _check(cells, count, cap)
    dev = cells.device
    batch, m = cells.shape[:2]
    merged = torch.zeros((batch, cap, 9), dtype=torch.float32, device=dev)
    ncells = torch.zeros((batch, cap), dtype=torch.int32, device=dev)
    kept = torch.zeros((batch,), dtype=torch.int32, device=dev)
    over = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if batch == 0:
        return merged, ncells, kept, over
    _KERNEL(dev, cells.contiguous(), count.contiguous(), merged, ncells, kept, over,
            batch, m, cap, float(thresh))
    return merged, ncells, kept, over


def _fake(cells, count, thresh, cap):
    _check(cells, count, cap)
    b = cells.shape[0]
    return (cells.new_empty((b, cap, 9)), cells.new_empty((b, cap), dtype=torch.int32),
            cells.new_empty((b,), dtype=torch.int32), cells.new_empty((b,), dtype=torch.int32))


_kernel.op("lanms_walk(Tensor cells, Tensor count, float thresh, int cap) "
           "-> (Tensor, Tensor, Tensor, Tensor)",
           cpu=lanms_walk_ref, cuda=_launch, fake=_fake)


@_KERNEL.counts
def lanms_walk(cells: torch.Tensor, count: torch.Tensor, thresh: float, cap: int) -> Walk:
    """(merged, cells, count, overflow) of the locality-aware walk.

    Calls the op ``torch.ops.ctpn_torch.lanms_walk``: CPU tensors run
    :func:`lanms_walk_ref`; CUDA tensors launch the kernel (adding one to
    ``lanms_walk.LAUNCHES`` and ``LAUNCHES_BY_DEVICE``) or raise.
    """
    _check(cells, count, cap)
    return torch.ops.ctpn_torch.lanms_walk(cells, count, float(thresh), int(cap))
