"""The text-line connector's chain walk: every node's successor path,
summed, counted and bounded in one pass.

The JAX connector (``ctpn_tpu/postprocess/connector.py``,
``chain_reachability``) finds each chain's members as rows of a dense
(P, P) reachability matrix R, by boolean squarings of (I + S) on the
TPU's matrix unit, and takes every per-chain sum as a row of ``R @ F``.
The successor graph is a forest of paths: a node has at most one
successor, and every edge advances at least one proposal column. So each
row of R is one path, and on the card it is walked: a few dozen dependent
loads per node in place of ``log2(P)`` dense float32 products of
(P, P) matrices and the passes over R around them.

* :func:`chain_walk` is the wrapper around the op
  ``torch.ops.ctpn_torch.chain_walk``. A CUDA tensor launches the
  hand-written kernel ``ops/csrc/chain_walk.cu`` (a CTA per image, the
  image's graph and features staged in shared memory, a thread per start
  node); a CPU tensor runs :func:`chain_walk_ref`, the plain version.
  There is no fallback from one to the other.
* :func:`chain_walk_ref` is the plain version: the walk of every node at
  once, one gather per step.

Contract (both versions): ``succ`` (N, P) int32, each node's successor or
-1 (an index outside [0, P) is no successor); ``feats`` (N, P, K)
float32, 1 <= K <= ``MAX_K``; ``x1``, ``x2`` (N, P) float32; all on one
device; ``steps`` >= 0; ``ValueError`` otherwise. From every node s the
walk visits s, ``succ[s]``, ``succ[succ[s]]``, ... and stops at a node
with no successor or after ``steps`` successors. Returns, per node:

* ``sums`` (N, P, K): the visited nodes' features summed in path order,
  starting from ``feats[s]``, in float64 and rounded to float32 once (no
  0.0 is ever added, so signed zeros pass);
* ``cnt`` (N, P) float32: the nodes visited;
* ``min_x1``, ``max_x2`` (N, P): the least ``x1`` and the largest ``x2``
  over them, a value replacing the running one when it is smaller
  (larger);
* ``is_start`` (N, P) bool: the node has a successor and no node has it
  as successor.

Every row is walked, padding included: a node without a successor holds
only itself. With ``steps`` = 2 ** r the walk reaches exactly what r
squarings of (I + S) reach. Both versions add in the same order with
plain float64 adds and round alike, so the kernel gives the plain
version's bits. Float64 keeps the digits that the connector's covariance
form (a sum of squares less n times the squared mean) cancels: float32
running sums move line records by up to 4e-3 px against the JAX
connector's matrix products.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ctpn_tpu_torch.ops import _kernel
from ctpn_tpu_torch.ops._kernel import INT, PTR

MAX_K = 8  # features per node the kernel keeps in registers

Walk = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check(succ, feats, x1, x2, steps) -> None:
    if succ.ndim != 2 or succ.dtype != torch.int32:
        raise ValueError(f"succ must be int32 (N, P), got {succ.dtype} {tuple(succ.shape)}")
    n, p = succ.shape
    if feats.ndim != 3 or feats.dtype != torch.float32 or tuple(feats.shape[:2]) != (n, p):
        raise ValueError(f"feats must be float32 ({n}, {p}, K), got {feats.dtype} "
                         f"{tuple(feats.shape)}")
    if not 1 <= feats.shape[2] <= MAX_K:
        raise ValueError(f"feats must have 1 to {MAX_K} features, got {feats.shape[2]}")
    for name, t in (("x1", x1), ("x2", x2)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n, p):
            raise ValueError(f"{name} must be float32 ({n}, {p}), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if any(t.device != succ.device for t in (feats, x1, x2)):
        raise ValueError("succ, feats, x1 and x2 must be on the same device")
    if succ.device.type not in ("cpu", "cuda"):
        raise ValueError(f"chain_walk: unsupported device {succ.device}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")


def _outputs(succ: torch.Tensor, k: int) -> Walk:
    n, p = succ.shape
    f32 = dict(dtype=torch.float32, device=succ.device)
    return (torch.empty((n, p, k), **f32), torch.empty((n, p), **f32),
            torch.empty((n, p), **f32), torch.empty((n, p), **f32),
            torch.empty((n, p), dtype=torch.bool, device=succ.device))


def chain_walk_ref(succ: torch.Tensor, feats: torch.Tensor, x1: torch.Tensor,
                   x2: torch.Tensor, steps: int) -> Walk:
    """Plain PyTorch version, on any device: every node's walk at once,
    one gather of the successors per step, until no walk goes on."""
    _check(succ, feats, x1, x2, steps)
    n, p = succ.shape
    has_out = (succ >= 0) & (succ < p)
    nxt_of = torch.where(has_out, succ.long(), -1)
    has_in = torch.zeros((n, p), dtype=torch.int32, device=succ.device).scatter_add_(
        1, nxt_of.clamp(min=0), has_out.int()) > 0
    cur = torch.arange(p, device=succ.device).expand(n, p)
    alive = torch.ones((n, p), dtype=torch.bool, device=succ.device)
    wide = feats.double()
    sums, cnt, lo, hi = wide.clone(), torch.ones_like(x1), x1.clone(), x2.clone()
    for _ in range(steps):
        nxt = nxt_of.gather(1, cur)
        alive = alive & (nxt >= 0)
        if not bool(alive.any()):
            break
        cur = torch.where(alive, nxt, cur)
        f = wide.gather(1, cur[..., None].expand(-1, -1, feats.shape[2]))
        sums = torch.where(alive[..., None], sums + f, sums)
        cnt = torch.where(alive, cnt + 1.0, cnt)
        v, w = x1.gather(1, cur), x2.gather(1, cur)
        lo = torch.where(alive & (v < lo), v, lo)
        hi = torch.where(alive & (w > hi), w, hi)
    return sums.float(), cnt, lo, hi, has_out & ~has_in


_KERNEL = _kernel.Entry("chain_walk", [PTR] * 9 + [INT] * 4)


def _launch(succ: torch.Tensor, feats: torch.Tensor, x1: torch.Tensor,
            x2: torch.Tensor, steps: int) -> Walk:
    """The op's CUDA implementation: launch the kernel or raise."""
    _check(succ, feats, x1, x2, steps)
    out = _outputs(succ, feats.shape[2])
    n, p = succ.shape
    if n == 0 or p == 0:
        return out
    _KERNEL(succ.device, *(t.contiguous() for t in (succ, feats, x1, x2)), *out,
            n, p, feats.shape[2], int(steps))
    return out


def _fake(succ, feats, x1, x2, steps):
    _check(succ, feats, x1, x2, steps)
    return _outputs(succ, feats.shape[2])


_kernel.op("chain_walk(Tensor succ, Tensor feats, Tensor x1, Tensor x2, int steps) "
           "-> (Tensor, Tensor, Tensor, Tensor, Tensor)",
           cpu=chain_walk_ref, cuda=_launch, fake=_fake)


@_KERNEL.counts
def chain_walk(succ: torch.Tensor, feats: torch.Tensor, x1: torch.Tensor,
               x2: torch.Tensor, steps: int) -> Walk:
    """(sums, cnt, min_x1, max_x2, is_start) of every node's successor path.

    Calls the op ``torch.ops.ctpn_torch.chain_walk``: CPU tensors run
    :func:`chain_walk_ref`; CUDA tensors launch the kernel (adding one to
    ``chain_walk.LAUNCHES`` and ``LAUNCHES_BY_DEVICE``) or raise.
    """
    _check(succ, feats, x1, x2, steps)
    return torch.ops.ctpn_torch.chain_walk(succ, feats, x1, x2, int(steps))
