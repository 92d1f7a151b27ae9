"""Operations and bytes of EAST (``configs/east_vgg16_rbox.json``) that
its metrics divide by; the peaks are ``flops.py``'s.

The network's count follows from the widths and the image's resized size
(its true extent, not the padded bucket): a k x k conv of an H x W map from
C_in to C_out channels is 2 * H * W * C_in * C_out * k * k operations,
each pool halves H and W with a floor, each unpool goes to its skip's
size. The unpools, ReLUs and sigmoids are not counted.

The two post-process kernels are held to the least work the reference's
own walk and NMS make (``reference/east.py``): each IoU test of two quads
at ``QUAD_IOU_OPS`` float32 operations, against the bytes the work needs
moved (the live cells and quads, not the caps' slots), at the HBM rate.
"""

from __future__ import annotations

from typing import Dict

from flops import F32_OPS_PER_S, HBM_BYTES_PER_S

# one IoU test of two quads at its least: Sutherland-Hodgman clipping of a
# quad by the four edges of the other that adds no vertex (per edge and
# vertex a side test, 2 subtractions, 2 products, a difference and a
# compare: 6 x 4 x 4 = 96), the shoelace sum of the four-vertex result (2
# products, a difference, a sum: 4 x 4 = 16); the two quads' own areas,
# the union and the compare (at least 10 more) are left out: 112
QUAD_IOU_OPS = 112
CELL_BYTES = 9 * 4  # a cell or a merged quad: score and eight float32
MERGED_BYTES = CELL_BYTES + 4  # and the count of cells it folds


def conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h * w * cin * cout * k * k


def model_flops(h: int, w: int, model: Dict) -> float:
    """Operations of EAST-VGG16 on one h x w image."""
    total, cin, taps = 0.0, 3, []
    for block, reps, ch in model["vgg_stages"]:
        for _ in range(reps):
            total += conv(h, w, cin, ch, 3)
            cin = ch
        h, w = h // 2, w // 2
        if block >= 2:
            taps.append((h, w, ch))
    prev = taps[-1][2]
    for (sh, sw, sc), width in zip(taps[-2::-1], model["merge_widths"]):
        total += conv(sh, sw, prev + sc, width, 1) + conv(sh, sw, width, width, 3)
        prev = width
    sh, sw, _ = taps[0]
    total += conv(sh, sw, prev, model["out_width"], 3)
    total += conv(sh, sw, model["out_width"], 6, 1)
    return total


def lanms_bound_s(cells: int, merged: int, tests: int) -> float:
    """Least time of one walk over ``cells`` live cells that keeps
    ``merged`` quads after ``tests`` IoU tests."""
    nbytes = cells * CELL_BYTES + merged * MERGED_BYTES
    return max(nbytes / HBM_BYTES_PER_S, tests * QUAD_IOU_OPS / F32_OPS_PER_S)


def mask_words(count: int) -> int:
    """Words of the suppression mask that can hold a bit for an image with
    ``count`` valid quads: ``count`` rows of ``ceil(count / 32)``. The rest
    of the cap-sized mask is zeros that no reader needs."""
    return count * ((count + 31) // 32)


def quad_bitmask_bound_s(words: float, quads: float, tests: float) -> float:
    """Least time of one quad bitmask: the ``words`` of ``mask_words``
    written and the ``quads`` valid quads read, against the ``tests`` IoU
    tests of greedy NMS."""
    nbytes = words * 4 + quads * (32 + 1)
    return max(nbytes / HBM_BYTES_PER_S, tests * QUAD_IOU_OPS / F32_OPS_PER_S)
