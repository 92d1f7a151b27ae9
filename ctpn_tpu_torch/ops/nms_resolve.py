"""Greedy NMS keep flags from a suppression bitmask: the second phase of the
``TPU.NMS_FUSED False`` route.

Counterpart of ``ctpn_tpu/ops/nms.py::nms_fixed_point_blocked`` (lines
136-196), which is a jnp program (a ``lax.scan`` with a ``lax.while_loop``
inside), not a Pallas kernel: the JAX package resolves on the device in one
program, and so does the port.

* :func:`nms_resolve` is the wrapper around the op
  ``torch.ops.ctpn_torch.nms_resolve``. A CUDA tensor launches the
  hand-written kernel ``ops/csrc/nms_resolve.cu`` (a thread-block cluster of
  up to eight CTAs per image walks the rows 32 at a time: each CTA owns a
  slice of the word columns, one warp of the slice's owner resolves a group
  exactly on registers and sends the keep word through distributed shared
  memory, and every CTA folds the kept rows' words of its columns,
  prefetched into registers, into its suppressed-box vector); a CPU tensor
  runs the plain version. There is no fallback from one to the other, and
  no device-to-host sync.
* :func:`nms_fixed_point_blocked` is the plain PyTorch version, and
  :func:`nms_fixed_point` its unblocked form: they iterate ``keep = valid &
  ~any(bit & keep)`` from "all valid" until nothing changes, asking the host
  once per sweep, for the whole batch, whether anything changed. That is one
  device-to-host sync per sweep, counted in ``nms_fixed_point.SWEEPS`` and
  ``nms_fixed_point_blocked.SWEEPS``.

Contract (all versions): mask (B, N, W) int32 with W = ceil(N / 32), as
:func:`ctpn_tpu_torch.ops.nms_bitmask.suppression_bitmask` writes it (row
i's bits = the later boxes that box i suppresses, every word left of the
diagonal word ``i // 32`` zero), and valid (B, N) bool give keep (B, N)
bool, the unique solution of ``keep[i] = valid[i] and not any(keep[j] and
bit(j, i) for j < i)``. Every box is resolved: there is no ``max_keep``.
"""

from __future__ import annotations

import torch

from ctpn_tpu_torch.ops import _kernel
from ctpn_tpu_torch.ops._kernel import INT, PTR
from ctpn_tpu_torch.ops.nms_bitmask import BITS, num_words


def or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR of ``x`` over ``dim`` (PyTorch has no OR reduction): a
    halving tree of ``bitwise_or``. ``x.shape[dim]`` must be positive."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        half = n // 2
        y = x.narrow(dim, 0, half) | x.narrow(dim, half, half)
        if n % 2:
            y = torch.cat([y, x.narrow(dim, n - 1, 1)], dim)
        x = y
    return x.squeeze(dim)


def _bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """(B, W) int32 words -> (B, n) bool, bit k of word w = column 32w+k."""
    idx = torch.arange(n, device=words.device)
    shift = (idx % BITS).to(torch.int32)
    return ((words[:, idx // BITS] >> shift) & 1) != 0


def nms_fixed_point(mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Resolve the greedy keep set from a suppression bitmask.

    mask: (B, N, W) int32, row i's bits = boxes i suppresses (all j > i);
    valid: (B, N) bool. Returns keep (B, N) bool in the same (sorted)
    order. Every sweep ORs the whole mask under the active rows.
    """
    n = mask.shape[1]
    active = valid
    for _ in range(n):
        supp = or_reduce(torch.where(active[..., None], mask, 0), 1)
        new = valid & ~_bits(supp, n)
        nms_fixed_point.SWEEPS += 1
        changed = bool((new != active).any())  # one host sync per sweep
        active = new
        if not changed:
            break
    return active


nms_fixed_point.SWEEPS = 0


def nms_fixed_point_blocked(
    mask: torch.Tensor, valid: torch.Tensor, block: int = 1024
) -> torch.Tensor:
    """Block-sequential greedy resolve: each mask row is read once.

    Boxes are taken in score-ordered blocks. A small fixed point over the
    block's own columns resolves it exactly (suppression from earlier blocks
    arrives through the accumulated word vector); then the kept rows' masks
    fold into that vector. Same output as :func:`nms_fixed_point`.
    """
    if block % BITS or block < BITS:
        raise ValueError(f"block must be a positive multiple of {BITS}, got {block}")
    batch, n, words = mask.shape
    supp = mask.new_zeros((batch, words))
    keep = torch.zeros_like(valid)
    bw = block // BITS
    for r0 in range(0, n, block):
        rows = mask[:, r0:r0 + block]  # (B, r, W)
        r = rows.shape[1]
        w0, lw = r0 // BITS, num_words(r)
        base = valid[:, r0:r0 + r] & ~_bits(supp[:, w0:w0 + lw], r)
        local = rows[:, :, w0:w0 + lw]
        active = base
        for _ in range(r):
            sw = or_reduce(torch.where(active[..., None], local, 0), 1)
            new = base & ~_bits(sw, r)
            nms_fixed_point_blocked.SWEEPS += 1
            changed = bool((new != active).any())  # one host sync per sweep
            active = new
            if not changed:
                break
        keep[:, r0:r0 + r] = active
        if r0 + block < n:  # later blocks read columns from w0 + bw on
            fold = or_reduce(torch.where(active[..., None], rows[:, :, w0 + bw:], 0), 1)
            supp[:, w0 + bw:] |= fold
    return keep


nms_fixed_point_blocked.SWEEPS = 0


def _check(mask: torch.Tensor, valid: torch.Tensor) -> None:
    if valid.ndim != 2 or valid.dtype != torch.bool:
        raise ValueError(
            f"valid must be bool (B, N), got {valid.dtype} {tuple(valid.shape)}")
    want = (*valid.shape, num_words(valid.shape[1]))
    if mask.dtype != torch.int32 or tuple(mask.shape) != want:
        raise ValueError(
            f"mask must be int32 {want}, got {mask.dtype} {tuple(mask.shape)}")
    if mask.device != valid.device:
        raise ValueError("mask and valid must be on the same device")


_KERNEL = _kernel.Entry("nms_resolve", [PTR, PTR, PTR, INT, INT])


def _launch(mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The op's CUDA implementation: launch the kernel or raise."""
    _check(mask, valid)
    dev = mask.device
    batch, n = valid.shape
    keep = torch.empty((batch, n), dtype=torch.bool, device=dev)
    if batch == 0 or n == 0:
        return keep
    _KERNEL(dev, mask.contiguous(), valid.contiguous(), keep, batch, n)
    return keep


def _fake(mask, valid):
    _check(mask, valid)
    return torch.empty_like(valid)


_kernel.op("nms_resolve(Tensor mask, Tensor valid) -> Tensor",
           cpu=nms_fixed_point_blocked, cuda=_launch, fake=_fake)


@_KERNEL.counts
def nms_resolve(mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, N) bool greedy keep flags of a (B, N, ceil(N/32)) int32 bitmask.

    Calls the op ``torch.ops.ctpn_torch.nms_resolve``: CPU tensors run
    :func:`nms_fixed_point_blocked`; CUDA tensors launch the kernel (adding
    one to ``nms_resolve.LAUNCHES`` and
    ``LAUNCHES_BY_DEVICE``, see ``ops/_launches.py``) or raise.
    """
    _check(mask, valid)
    if mask.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nms_resolve: unsupported device {mask.device}")
    return torch.ops.ctpn_torch.nms_resolve(mask, valid)
