"""The text-line connector's successor graph: each proposal's kept
successor, without a (P, P) tensor.

The JAX connector (``ctpn_tpu/postprocess/connector.py``,
``build_successors``) tests every pair of an image's proposals at once:
(P, P) matrices of overlaps, similarities, column gaps and candidates,
then the nearest candidate column and best score of every row and column,
on the TPU's vector unit. Written so in PyTorch that is about thirty
passes over (N, P, P) tensors, 48 M elements each at the program's
(48, 1000), for a graph whose candidates lie within ``max_gap`` columns of
each node: on the card a node's candidates are found among its neighbours
in column order instead.

* :func:`successors` is the wrapper around the op
  ``torch.ops.ctpn_torch.successors``. A CUDA tensor launches the
  hand-written kernel ``successors_kernel`` of ``ops/csrc/chain_walk.cu``
  (a CTA per image sorts its valid proposals by column in shared memory; a
  thread per node scans its neighbours to the nearest candidate column on
  each side); a CPU tensor runs :func:`successors_ref`, the plain version.
  There is no fallback from one to the other.
* :func:`successors_ref` is the plain version: the dense form, every pair
  at once.

Contract (both versions): ``boxes`` (N, P, 4) float32 ``[x1, y1, x2,
y2]``, ``scores`` (N, P) float32, ``valid`` (N, P) bool, all on one
device; ``max_gap`` an int32; ``ValueError`` otherwise. A node's column is
``floor(x1)`` as int32 (``|x1| < 2 ** 30``, as any image coordinate is).
Returns (N, P) int32: the successor of every node, or -1:

* j is a candidate successor of i if both are valid, ``0 < col_j - col_i
  <= max_gap``, the vertical overlap ``max(min(y2) - max(y1) + 1, 0) /
  min(h)`` is at least ``min_v_overlaps`` and the size similarity
  ``min(h) / max(h)`` at least ``min_size_sim``, with ``h = y2 - y1 + 1``,
  all in float32 and the thresholds rounded to float32, as PyTorch
  compares them;
* i's best successor j: among its candidates in the nearest candidate
  column, the best score, ties to the lowest index (``torch.argmax``);
* j's best precursor score: the largest score among its candidate
  precursors in the nearest candidate column to its left;
* the edge stands if ``score_i >= `` the best precursor score of j.

The kernel computes each float as PyTorch does (``__fdiv_rn``, no
contraction), so its successors equal the plain version's bit for bit.
"""

from __future__ import annotations

import torch

from ctpn_tpu_torch.ops import _kernel
from ctpn_tpu_torch.ops._kernel import FLOAT, INT, PTR

# nodes per image whose sort keys the kernel keeps in shared memory; a
# larger image gets global scratch for them
SHARED_NODES = 16384


def _check(boxes, scores, valid, max_gap) -> None:
    if scores.ndim != 2 or scores.dtype != torch.float32:
        raise ValueError(f"scores must be float32 (N, P), got {scores.dtype} "
                         f"{tuple(scores.shape)}")
    n, p = scores.shape
    if boxes.dtype != torch.float32 or tuple(boxes.shape) != (n, p, 4):
        raise ValueError(f"boxes must be float32 ({n}, {p}, 4), got {boxes.dtype} "
                         f"{tuple(boxes.shape)}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (n, p):
        raise ValueError(f"valid must be bool ({n}, {p}), got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if boxes.device != scores.device or valid.device != scores.device:
        raise ValueError("boxes, scores and valid must be on the same device")
    if scores.device.type not in ("cpu", "cuda"):
        raise ValueError(f"successors: unsupported device {scores.device}")
    if not isinstance(max_gap, int) or not -2 ** 31 <= max_gap < 2 ** 31:
        raise ValueError(f"max_gap must be an int32, got {max_gap!r}")


def successors_ref(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                   max_gap: int = 50, min_v_overlaps: float = 0.7,
                   min_size_sim: float = 0.7) -> torch.Tensor:
    """Plain PyTorch version, on any device: every pair of an image at
    once, as (N, P, P) tensors."""
    _check(boxes, scores, valid, max_gap)
    y1, y2 = boxes[..., 1], boxes[..., 3]
    h = y2 - y1 + 1.0
    col = torch.floor(boxes[..., 0]).to(torch.int32)

    inter = (
        torch.minimum(y2[:, :, None], y2[:, None, :])
        - torch.maximum(y1[:, :, None], y1[:, None, :])
        + 1.0
    )
    min_h = torch.minimum(h[:, :, None], h[:, None, :])
    max_h = torch.maximum(h[:, :, None], h[:, None, :])
    v_ov = torch.clamp(inter, min=0.0) / min_h
    sim = min_h / max_h
    meet = (v_ov >= min_v_overlaps) & (sim >= min_size_sim)

    dcol = col[:, None, :] - col[:, :, None]  # col_j - col_i
    pairv = valid[:, :, None] & valid[:, None, :]
    cand = meet & pairv & (dcol > 0) & (dcol <= max_gap)  # j is a candidate of i
    big = 1 << 30
    neg_inf = -float("inf")

    # successor side: restrict to nearest candidate column of i
    cand_col = torch.where(cand, col[:, None, :], big)
    min_col = cand_col.min(dim=2).values
    succ_sel = cand & (col[:, None, :] == min_col[:, :, None])
    has_succ = succ_sel.any(dim=2)
    succ_scores = torch.where(succ_sel, scores[:, None, :], neg_inf)
    best_j = torch.argmax(succ_scores, dim=2)  # ties -> lowest index

    # precursor side: restrict to nearest candidate column of j (from below)
    prec_col = torch.where(cand, col[:, :, None], -big)
    max_col = prec_col.max(dim=1).values
    prec_sel = cand & (col[:, :, None] == max_col[:, None, :])
    prec_scores = torch.where(prec_sel, scores[:, :, None], neg_inf)
    prec_best = prec_scores.max(dim=1).values

    edge = has_succ & (scores >= torch.gather(prec_best, 1, best_j))
    return torch.where(edge, best_j, -1).to(torch.int32)


_KERNEL = _kernel.Entry("successors", [PTR] * 6 + [INT] * 3 + [FLOAT] * 2,
                        source="chain_walk")


def _launch(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, max_gap: int,
            min_v_overlaps: float, min_size_sim: float) -> torch.Tensor:
    """The op's CUDA implementation: launch the kernel or raise."""
    _check(boxes, scores, valid, max_gap)
    n, p = scores.shape
    out = torch.empty((n, p), dtype=torch.int32, device=scores.device)
    if n == 0 or p == 0:
        return out
    keys = prec = None
    if p > SHARED_NODES:
        keys = torch.empty((n, 1 << (p - 1).bit_length()), dtype=torch.int64,
                           device=scores.device)
        prec = torch.empty((n, p), dtype=torch.float32, device=scores.device)
    _KERNEL(scores.device, boxes.contiguous(), scores.contiguous(), valid.contiguous(), out,
            keys, prec, n, p, max_gap, min_v_overlaps, min_size_sim)
    return out


def _fake(boxes, scores, valid, max_gap, min_v_overlaps, min_size_sim):
    _check(boxes, scores, valid, max_gap)
    return scores.new_empty(scores.shape, dtype=torch.int32)


_kernel.op("successors(Tensor boxes, Tensor scores, Tensor valid, int max_gap, "
           "float min_v_overlaps, float min_size_sim) -> Tensor",
           cpu=successors_ref, cuda=_launch, fake=_fake)


@_KERNEL.counts
def successors(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               max_gap: int = 50, min_v_overlaps: float = 0.7,
               min_size_sim: float = 0.7) -> torch.Tensor:
    """(N, P) int32 successor of every node, or -1: the kept graph edges.

    Calls the op ``torch.ops.ctpn_torch.successors``: CPU tensors run
    :func:`successors_ref`; CUDA tensors launch the kernel (adding one to
    ``successors.LAUNCHES`` and ``LAUNCHES_BY_DEVICE``) or raise.
    """
    _check(boxes, scores, valid, max_gap)
    return torch.ops.ctpn_torch.successors(boxes, scores, valid, max_gap,
                                           float(min_v_overlaps), float(min_size_sim))
