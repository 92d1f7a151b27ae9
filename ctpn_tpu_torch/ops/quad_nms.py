"""Quad NMS for EAST: the IoU of two convex quads and the suppression
bitmask over score-sorted quads, in ``nms_resolve``'s contract.

No TPU counterpart: the JAX package detects axis-aligned CTPN boxes only.
EAST's greedy NMS (Zhou et al. 2017, standard NMS after locality-aware
NMS) tests polygon IoU; here it runs as the port's other NMS routes do, a
bitmask of who suppresses whom followed by ``ctpn_torch::nms_resolve``.

* :func:`quad_iou` is the plain PyTorch IoU of quads, vectorised over any
  leading dims, and the arithmetic that every version follows to the bit:
  float32, Sutherland-Hodgman clipping of the first quad by the second
  (which must be convex; its orientation is read from its signed area),
  the shoelace sum over the clipped polygon's vertices in order, then
  ``inter / (area_a + area_b - inter)``, 0 where the union is not positive.
  Each product and sum is rounded on its own (no multiply-add), so the
  card's kernel, built from the same sequence, gives the same bits.
* :func:`quad_bitmask` is the wrapper around the op
  ``torch.ops.ctpn_torch.quad_bitmask``. A CUDA tensor launches the
  hand-written kernel in ``ops/csrc/quad_nms.cu`` (a thread per (row,
  word) of the mask: the 32 column quads of its word are tested against
  its row quad, words left of the diagonal or past the valid quads only
  written as zero); a CPU tensor runs :func:`quad_bitmask_ref`, the plain
  version. There is no fallback from one to the other.

Contract (both versions): quads (B, K, 8) float32 ``[x1, y1, ..., x4,
y4]`` sorted by score descending and valid (B, K) bool give mask (B, K,
ceil(K / 32)) int32: bit ``j % 32`` of word ``j // 32`` in row ``i`` is set
exactly when ``j > i``, both quads are valid, their axis-aligned extents
meet (``min <= max`` on both axes) and ``quad_iou(quad_i, quad_j) > t``.
Two quads whose extents do not meet do not intersect, so the extent test
drops pairs whose IoU would read at most rounding. Valid quads come
first: the row loops stop at the count of valid quads.
"""

from __future__ import annotations

import torch

from ctpn_tpu_torch.ops import _kernel
from ctpn_tpu_torch.ops._kernel import FLOAT, INT, PTR
from ctpn_tpu_torch.ops.nms_bitmask import BITS, num_words, pack_bits

MAXV = 16  # vertices a clipped polygon may hold (a convex quad needs 8)


def _signed2(xs: torch.Tensor, ys: torch.Tensor, n) -> torch.Tensor:
    """Twice the signed area of the polygons ``(xs, ys)`` (..., V) with
    ``n`` vertices: the shoelace terms summed from vertex 0 up, in order."""
    v = xs.shape[-1]
    acc = torch.zeros(xs.shape[:-1], dtype=torch.float32, device=xs.device)
    n = torch.as_tensor(n, device=xs.device)
    for i in range(v):
        j = torch.where(n > i + 1, i + 1, 0).expand(xs.shape[:-1])
        xj = xs.gather(-1, j[..., None]).squeeze(-1)
        yj = ys.gather(-1, j[..., None]).squeeze(-1)
        term = xs[..., i] * yj - xj * ys[..., i]
        acc = torch.where(n > i, acc + term, acc)
    return acc


def _area(xs: torch.Tensor, ys: torch.Tensor, n) -> torch.Tensor:
    return torch.abs(_signed2(xs, ys, n)) * 0.5


def _clip(sx, sy, n, cx, cy):
    """Sutherland-Hodgman: the polygons ``(sx, sy)`` (..., MAXV) with ``n``
    vertices clipped by the convex quads ``(cx, cy)`` (..., 4), edge by
    edge; each edge emits, for vertex i and its predecessor, the crossing
    (if they lie on opposite sides) and then vertex i (if inside)."""
    flip = _signed2(cx, cy, 4) < 0
    idx = torch.arange(MAXV, device=sx.device)
    for e in range(4):
        ax, ay = cx[..., e, None], cy[..., e, None]
        ex = cx[..., (e + 1) % 4, None] - ax
        ey = cy[..., (e + 1) % 4, None] - ay
        c = ex * (sy - ay) - ey * (sx - ax)
        c = torch.where(flip[..., None], -c, c)
        prev = torch.where(idx == 0, n[..., None] - 1, idx - 1).clamp(min=0)
        cp, px, py = c.gather(-1, prev), sx.gather(-1, prev), sy.gather(-1, prev)
        cin, pin, live = c >= 0, cp >= 0, idx < n[..., None]
        t = cp / (cp - c)
        ix = px + t * (sx - px)
        iy = py + t * (sy - py)
        flags = torch.stack([live & (cin != pin), live & cin], -1).flatten(-2)
        pos = torch.cumsum(flags, -1) - 1
        dest = torch.where(flags & (pos < MAXV), pos, MAXV)
        shape = (*sx.shape[:-1], MAXV + 1)
        sx = torch.zeros(shape, dtype=torch.float32, device=sx.device).scatter_(
            -1, dest, torch.stack([ix, sx], -1).flatten(-2))[..., :MAXV]
        sy = torch.zeros(shape, dtype=torch.float32, device=sy.device).scatter_(
            -1, dest, torch.stack([iy, sy], -1).flatten(-2))[..., :MAXV]
        n = flags.sum(-1).clamp(max=MAXV)
    return sx, sy, n


def quad_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of quads ``a`` and ``b`` (..., 8) float32 (broadcast), ``a``
    clipped by ``b``; see the module's docstring for the arithmetic."""
    a, b = torch.broadcast_tensors(a.float(), b.float())
    ax, ay = a[..., 0::2], a[..., 1::2]
    bx, by = b[..., 0::2], b[..., 1::2]
    pad = torch.zeros((*a.shape[:-1], MAXV - 4), dtype=torch.float32, device=a.device)
    n0 = torch.full(a.shape[:-1], 4, dtype=torch.int64, device=a.device)
    sx, sy, n = _clip(torch.cat([ax, pad], -1), torch.cat([ay, pad], -1), n0, bx, by)
    inter = _area(sx, sy, n)
    union = _area(ax, ay, 4) + _area(bx, by, 4) - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                       torch.zeros_like(inter))


def extents_meet(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Whether the axis-aligned extents of quads ``a`` and ``b`` meet."""
    ax, ay, bx, by = a[..., 0::2], a[..., 1::2], b[..., 0::2], b[..., 1::2]
    return ((ax.amin(-1) <= bx.amax(-1)) & (bx.amin(-1) <= ax.amax(-1))
            & (ay.amin(-1) <= by.amax(-1)) & (by.amin(-1) <= ay.amax(-1)))


def _check(quads: torch.Tensor, valid: torch.Tensor) -> None:
    if quads.ndim != 3 or quads.shape[-1] != 8 or quads.dtype != torch.float32:
        raise ValueError(f"quads must be float32 (B, K, 8), got {quads.dtype} "
                         f"{tuple(quads.shape)}")
    if valid.dtype != torch.bool or tuple(valid.shape) != tuple(quads.shape[:2]):
        raise ValueError(f"valid must be bool {tuple(quads.shape[:2])}, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if quads.device != valid.device:
        raise ValueError("quads and valid must be on the same device")
    if quads.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quad_bitmask: unsupported device {quads.device}")


def quad_bitmask_ref(quads: torch.Tensor, valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """Plain PyTorch version: every pair among the first ``max(count)``
    quads tested at once, packed into words."""
    _check(quads, valid)
    batch, k = valid.shape
    words = num_words(k)
    mask = torch.zeros((batch, k, words), dtype=torch.int32, device=quads.device)
    c = int(valid.sum(1).max()) if batch and k else 0
    if c == 0:
        return mask
    q = quads[:, :c]
    t = torch.tensor(thresh, dtype=torch.float32)
    hit = quad_iou(q[:, :, None], q[:, None, :]) > t
    hit &= extents_meet(q[:, :, None], q[:, None, :])
    v = valid[:, :c]
    hit &= v[:, :, None] & v[:, None, :]
    hit &= torch.ones(c, c, dtype=torch.bool, device=q.device).triu(1)
    bits = torch.zeros((batch, c, words * BITS), dtype=torch.bool, device=q.device)
    bits[:, :, :c] = hit
    mask[:, :c] = pack_bits(bits)
    return mask


_KERNEL = _kernel.Entry("quad_bitmask", [PTR, PTR, PTR, INT, INT, FLOAT], source="quad_nms")


def _launch(quads: torch.Tensor, valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """The op's CUDA implementation: launch the kernel or raise."""
    _check(quads, valid)
    dev = quads.device
    batch, k = valid.shape
    mask = torch.empty((batch, k, num_words(k)), dtype=torch.int32, device=dev)
    if mask.numel() == 0:
        return mask
    _KERNEL(dev, quads.contiguous(), valid.contiguous(), mask, batch, k, float(thresh))
    return mask


def _fake(quads, valid, thresh):
    _check(quads, valid)
    b, k = valid.shape
    return quads.new_empty((b, k, num_words(k)), dtype=torch.int32)


_kernel.op("quad_bitmask(Tensor quads, Tensor valid, float thresh) -> Tensor",
           cpu=quad_bitmask_ref, cuda=_launch, fake=_fake)


@_KERNEL.counts
def quad_bitmask(quads: torch.Tensor, valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """(B, K, ceil(K/32)) int32 suppression bitmask of score-sorted quads.

    Calls the op ``torch.ops.ctpn_torch.quad_bitmask``: CPU tensors run
    :func:`quad_bitmask_ref`; CUDA tensors launch the kernel (adding one to
    ``quad_bitmask.LAUNCHES`` and ``LAUNCHES_BY_DEVICE``) or raise.
    """
    _check(quads, valid)
    return torch.ops.ctpn_torch.quad_bitmask(quads, valid, float(thresh))
