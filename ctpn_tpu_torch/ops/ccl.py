"""Connected components of CRAFT's thresholded maps (Baek et al., CVPR
2019; clovaai/CRAFT-pytorch ``craft_utils.py::getDetBoxes_core``, which
calls ``cv2.connectedComponentsWithStats``) and of DBNet's binarized
probability map (MhLiao/DB ``boxes_from_bitmap``, whose
``cv2.findContours`` traces each 8-connected component's outer border).

No TPU counterpart: the JAX package runs CTPN only. Labelling is global
(a component may span the map), so a captured program cannot run it as a
fixed number of plain PyTorch steps without a host sync to test for the
end; the card runs it as one op.

* :func:`ccl_label` is the wrapper around the op
  ``torch.ops.ctpn_torch.ccl_label``. A CUDA tensor launches the
  hand-written kernels in ``ops/csrc/craft_ccl.cu`` (runs per row,
  union-find by ``atomicMin`` on the runs, per-run statistics, a block per
  image that compacts the kept components in raster order); a CPU tensor
  runs :func:`ccl_label_ref`, the plain version. There is no fallback from
  one to the other.

Contract (both versions): maps (B, H, W, 2) float32 ``[region, affinity]``
(CRAFT) or (B, H, W, 1) ``[probability]`` (DB), and extent (B, 2) int32,
the rows and columns of each image's map that are read. A pixel inside
the extent is on when ``region > low_text`` or ``affinity >
link_threshold`` (float32 compares; a map of one channel has no
affinity). Components are those of ``connectivity`` 4 (CRAFT's) or 8
(DB's: a diagonal neighbour joins too). Returns

* ``labels`` (B, H, W) int32: each on pixel's component, the least raster
  index ``y * W + x`` of its pixels; -1 off;
* ``stats`` (B, K, 6) int32 ``[label, area, x, y, w, h]`` and ``score``
  (B, K) float32, the largest region score, of the components with
  ``area >= min_area`` and ``score >= text_threshold``, in raster order of
  their labels (OpenCV's label order), K = ``cap``; slots past the count
  are zero;
* ``count`` (B,) int32 the components kept (at most ``cap``), ``overflow``
  (B,) those past the cap, ``on`` (B,) the pixels on and ``labelled``
  (B,) the components.

The kernels are instantiated per channel count and connectivity (template
parameters), so CRAFT's two-channel, 4-connected labelling is its own code.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ctpn_tpu_torch.ops import _kernel
from ctpn_tpu_torch.ops._kernel import FLOAT, INT, PTR

Labels = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
               torch.Tensor, torch.Tensor]
STATS = 6  # label, area, x, y, w, h


def _check(maps: torch.Tensor, extent: torch.Tensor, cap: int, connectivity: int = 4) -> None:
    if maps.ndim != 4 or maps.shape[-1] not in (1, 2) or maps.dtype != torch.float32:
        raise ValueError(f"maps must be float32 (B, H, W, 2) or (B, H, W, 1), got {maps.dtype} "
                         f"{tuple(maps.shape)}")
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if extent.dtype != torch.int32 or tuple(extent.shape) != (maps.shape[0], 2):
        raise ValueError(f"extent must be int32 ({maps.shape[0]}, 2), got {extent.dtype} "
                         f"{tuple(extent.shape)}")
    if extent.device != maps.device:
        raise ValueError("maps and extent must be on the same device")
    if maps.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ccl_label: unsupported device {maps.device}")
    if cap < 1:
        raise ValueError(f"cap must be positive, got {cap}")
    if maps.shape[1] * maps.shape[2] >= 2 ** 24:
        raise ValueError(f"ccl_label: {maps.shape[1]}x{maps.shape[2]} map, at most 2**24 pixels")


def _on(maps: torch.Tensor, extent: torch.Tensor, low: float, link: float) -> torch.Tensor:
    h, w = maps.shape[1:3]
    dev = maps.device
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    inside = (rows < extent[:, 0, None, None]) & (cols < extent[:, 1, None, None])
    lo = torch.tensor(low, dtype=torch.float32, device=dev)
    if maps.shape[-1] == 1:
        return inside & (maps[..., 0] > lo)
    li = torch.tensor(link, dtype=torch.float32, device=dev)
    return inside & ((maps[..., 0] > lo) | (maps[..., 1] > li))


def component_labels(on: torch.Tensor, connectivity: int = 4) -> torch.Tensor:
    """(B, H, W) bool -> (B, H, W) int64 least raster index of each on
    pixel's 4- or 8-connected component, -1 off: the least label of the
    neighbours taken until nothing changes, each step followed by a jump to
    the label's own label."""
    batch, h, w = on.shape
    big = h * w
    idx = torch.arange(big, device=on.device).view(1, h, w).expand(batch, h, w)
    lab = torch.where(on, idx, big)
    while True:
        new = lab.clone()
        new[:, :, 1:] = torch.minimum(new[:, :, 1:], lab[:, :, :-1])
        new[:, :, :-1] = torch.minimum(new[:, :, :-1], lab[:, :, 1:])
        new[:, 1:] = torch.minimum(new[:, 1:], lab[:, :-1])
        new[:, :-1] = torch.minimum(new[:, :-1], lab[:, 1:])
        if connectivity == 8:
            new[:, 1:, 1:] = torch.minimum(new[:, 1:, 1:], lab[:, :-1, :-1])
            new[:, :-1, :-1] = torch.minimum(new[:, :-1, :-1], lab[:, 1:, 1:])
            new[:, 1:, :-1] = torch.minimum(new[:, 1:, :-1], lab[:, :-1, 1:])
            new[:, :-1, 1:] = torch.minimum(new[:, :-1, 1:], lab[:, 1:, :-1])
        new = torch.where(on, new, big)
        flat = new.reshape(batch, big)
        jumped = flat.gather(1, flat.clamp(max=big - 1)).view(batch, h, w)
        new = torch.where(on, torch.minimum(new, jumped), big)
        if torch.equal(new, lab):
            break
        lab = new
    return torch.where(on, lab, -1)


def ccl_label_ref(maps: torch.Tensor, extent: torch.Tensor, low_text: float,
                  link_threshold: float, text_threshold: float, min_area: int,
                  cap: int, connectivity: int = 4) -> Labels:
    """Plain PyTorch version: labels by :func:`component_labels`, the
    statistics by ``scatter_reduce`` over the labels, every image at once."""
    _check(maps, extent, cap, connectivity)
    batch, h, w = maps.shape[:3]
    dev, hw = maps.device, h * w
    on = _on(maps, extent, low_text, link_threshold)
    lab = component_labels(on, connectivity)
    flat_on = on.reshape(batch, hw)
    # each pixel's slot: its root's, in the flat (B * H * W) space, or a
    # last slot for the pixels off
    base = (torch.arange(batch, device=dev) * hw)[:, None]
    dest = torch.where(flat_on, lab.reshape(batch, hw) + base, batch * hw).reshape(-1)
    ys = torch.arange(h, device=dev).repeat_interleave(w).expand(batch, hw).reshape(-1)
    xs = torch.arange(w, device=dev).repeat(h).expand(batch, hw).reshape(-1)
    n = batch * hw + 1

    def reduce(values: torch.Tensor, how: str, init) -> torch.Tensor:
        out = torch.full((n,), init, dtype=values.dtype, device=dev)
        return out.scatter_reduce(0, dest, values, how, include_self=False)[:-1].view(batch, hw)

    area = reduce(torch.ones_like(xs), "sum", 0)
    x0, y0 = reduce(xs, "amin", 0), reduce(ys, "amin", 0)
    x1, y1 = reduce(xs, "amax", 0), reduce(ys, "amax", 0)
    best = reduce(maps[..., 0].reshape(-1), "amax", 0.0)
    idx = torch.arange(hw, device=dev)[None]
    roots = flat_on & (lab.reshape(batch, hw) == idx)
    text = torch.tensor(text_threshold, dtype=torch.float32, device=dev)
    kept = roots & (area >= min_area) & (best >= text)
    pos = torch.cumsum(kept, 1) - 1
    slot = torch.where(kept & (pos < cap), pos, cap)
    rows = torch.stack([idx.expand(batch, hw), area, x0, y0, x1 - x0 + 1, y1 - y0 + 1], -1)
    stats = torch.zeros((batch, cap + 1, STATS), dtype=torch.int64, device=dev)
    stats.scatter_(1, slot[..., None].expand(-1, -1, STATS), rows)
    score = torch.zeros((batch, cap + 1), dtype=torch.float32, device=dev)
    score.scatter_(1, slot, best)
    total = kept.sum(1, dtype=torch.int32)
    count = total.clamp(max=cap)
    stats[:, cap:] = 0
    score[:, cap:] = 0
    return (lab.to(torch.int32), stats[:, :cap].to(torch.int32).contiguous(),
            score[:, :cap].contiguous(), count, total - count,
            flat_on.sum(1, dtype=torch.int32), roots.sum(1, dtype=torch.int32))


_KERNEL = _kernel.Entry("ccl_label", [PTR] * 10 + [INT, INT, INT, FLOAT, FLOAT, FLOAT, INT, INT,
                                                   INT, INT], source="craft_ccl")


def _launch(maps: torch.Tensor, extent: torch.Tensor, low_text: float, link_threshold: float,
            text_threshold: float, min_area: int, cap: int, connectivity: int = 4) -> Labels:
    """The op's CUDA implementation: launch the kernels or raise."""
    _check(maps, extent, cap, connectivity)
    dev = maps.device
    batch, h, w = maps.shape[:3]
    labels = torch.empty((batch, h, w), dtype=torch.int32, device=dev)
    work = torch.empty((batch, h, w, STATS), dtype=torch.int32, device=dev)
    stats = torch.zeros((batch, cap, STATS), dtype=torch.int32, device=dev)
    score = torch.zeros((batch, cap), dtype=torch.float32, device=dev)
    counts = torch.zeros((4, batch), dtype=torch.int32, device=dev)
    if batch == 0 or h * w == 0:
        labels.fill_(-1)
        return (labels, stats, score, *counts.unbind(0))
    _KERNEL(dev, maps.contiguous(), extent.contiguous(), labels, work, stats, score,
            counts[0], counts[1], counts[2], counts[3], batch, h, w, float(low_text),
            float(link_threshold), float(text_threshold), int(min_area), int(cap),
            maps.shape[-1], int(connectivity))
    return (labels, stats, score, *counts.unbind(0))


def _fake(maps, extent, low_text, link_threshold, text_threshold, min_area, cap,
          connectivity=4):
    _check(maps, extent, cap, connectivity)
    b, h, w = maps.shape[:3]
    i32 = torch.int32
    return (maps.new_empty((b, h, w), dtype=i32), maps.new_empty((b, cap, STATS), dtype=i32),
            maps.new_empty((b, cap)), *(maps.new_empty((b,), dtype=i32) for _ in range(4)))


_kernel.op("ccl_label(Tensor maps, Tensor extent, float low_text, float link_threshold, "
           "float text_threshold, int min_area, int cap, int connectivity=4) "
           "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
           cpu=ccl_label_ref, cuda=_launch, fake=_fake)


@_KERNEL.counts
def ccl_label(maps: torch.Tensor, extent: torch.Tensor, low_text: float, link_threshold: float,
              text_threshold: float, min_area: int, cap: int, connectivity: int = 4) -> Labels:
    """(labels, stats, score, count, overflow, on, labelled) of CRAFT's or
    DB's maps.

    Calls the op ``torch.ops.ctpn_torch.ccl_label``: CPU tensors run
    :func:`ccl_label_ref`; CUDA tensors launch the kernels (adding one to
    ``ccl_label.LAUNCHES`` and ``LAUNCHES_BY_DEVICE``) or raise.
    """
    _check(maps, extent, cap, connectivity)
    return torch.ops.ctpn_torch.ccl_label(maps, extent, float(low_text), float(link_threshold),
                                          float(text_threshold), int(min_area), int(cap),
                                          int(connectivity))
