"""Operations and bytes of DBNet (``configs/dbnet_r50_dcn.json``) that its
metrics divide by; the peaks are ``flops.py``'s.

The network's count follows from the widths and the image's resized size:
a k x k conv of an H x W output map from C_in to C_out channels is 2 * H
* W * C_in * C_out * k * k operations, at the conv's output size; a
modulated deformable conv's product counts as the 3x3 conv it replaces
(its bilinear samples are not counted), its offset conv as a 3x3 conv to
27 channels; a 2x2/2 transposed conv is 2 * H * W * C_in * C_out * 4 at
its input size. Pools, upsamples, sums, concats, ReLUs and the sigmoid are
not counted.

A deformable site (the offset conv, the sampling and the product, which
the stage clock's ``dcnNN_in`` and ``dcnNN_out`` stamps bound) is held to
the larger of its operations at the bfloat16 peak and its bytes at the HBM
rate: the input (bfloat16), the offsets and masks (27 float32 per output
pixel), the offset conv's and the product's weights (bfloat16) read once,
and the output (bfloat16) written once. No column buffer is counted, so
the bound is the same whatever implements the op.

The box kernel is held to the bytes its work needs, counted on the
reference's own components (``reference/db.py``): over each component's
bounding box its labels and probabilities read (8 bytes a pixel), and its
statistics (6 ints) read and its record (9 floats) and keep flag written.
The labelling (``ccl_label`` at 8-connectivity on one channel) is held to
the map read and the labels written over the extents (8 bytes a pixel),
and each taken component's statistics (6 ints) and score written.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from flops import BF16_TENSOR_OPS_PER_S, HBM_BYTES_PER_S

OFFSETS = 27
BOX_PIXEL_BYTES = 4 + 4  # a label and a probability read
COMPONENT_BYTES = 6 * 4 + 9 * 4 + 4  # statistics read, record and flag written
LABEL_PIXEL_BYTES = 4 + 4  # the map read, a label written
LABEL_COMPONENT_BYTES = 6 * 4 + 4  # statistics and score written


def conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h * w * cin * cout * k * k


def down(n: int, s: int) -> int:
    """A 3x3 (or 1x1) conv's output size at stride ``s``, padding k // 2."""
    return (n - 1) // s + 1


def sites(h: int, w: int, model: Dict) -> List[Tuple[int, int, int, int, int, int]]:
    """Each deformable site of one h x w image: (C, H, W, stride, Ho, Wo)."""
    out = []
    hh, ww = down(down(h, 2), 2), down(down(w, 2), 2)  # the stem and its pool
    cin = model["stem_width"]
    for idx, ((blocks, planes), dcn) in enumerate(zip(model["stages"], model["stage_with_dcn"])):
        for b in range(blocks):
            s = (1 if idx == 0 else 2) if b == 0 else 1
            ho, wo = down(hh, s), down(ww, s)
            if dcn:
                out.append((planes, hh, ww, s, ho, wo))
            hh, ww, cin = ho, wo, planes * 4
    return out


def parts(h: int, w: int, model: Dict) -> Dict[str, float]:
    """Operations of DBNet on one h x w image: ``trunk`` (of which
    ``dcn_product`` and ``dcn_offsets``), ``neck`` and ``head``."""
    sw = model["stem_width"]
    hh, ww = down(h, 2), down(w, 2)
    trunk = conv(hh, ww, 3, sw, 7)
    hh, ww = down(hh, 2), down(ww, 2)
    cin, product, offsets, taps = sw, 0.0, 0.0, []
    for idx, ((blocks, planes), dcn) in enumerate(zip(model["stages"], model["stage_with_dcn"])):
        for b in range(blocks):
            s = (1 if idx == 0 else 2) if b == 0 else 1
            ho, wo = down(hh, s), down(ww, s)
            trunk += conv(hh, ww, cin, planes, 1) + conv(ho, wo, planes, planes * 4, 1)
            if dcn:
                product += conv(ho, wo, planes, planes, 3)
                offsets += conv(ho, wo, planes, OFFSETS, 3)
            else:
                trunk += conv(ho, wo, planes, planes, 3)
            if b == 0:
                trunk += conv(ho, wo, cin, planes * 4, 1)
            hh, ww, cin = ho, wo, planes * 4
        taps.append((hh, ww, cin))
    inner = model["inner_channels"]
    q = inner // 4
    neck = sum(conv(th, tw, tc, inner, 1) + conv(th, tw, inner, q, 3) for th, tw, tc in taps)
    h4, w4, _ = taps[0]
    head = (conv(h4, w4, inner, q, 3) + 2.0 * h4 * w4 * q * q * 4
            + 2.0 * (2 * h4) * (2 * w4) * q * 1 * 4)
    return {"trunk": trunk + product + offsets, "dcn_product": product, "dcn_offsets": offsets,
            "neck": neck, "head": head}


def model_flops(h: int, w: int, model: Dict) -> float:
    """Operations of DBNet on one h x w image."""
    p = parts(h, w, model)
    return p["trunk"] + p["neck"] + p["head"]


def site_bound_s(c: int, h: int, w: int, ho: int, wo: int) -> float:
    """Least time of one deformable site of one image (C in, C out)."""
    ops = conv(ho, wo, c, c, 3) + conv(ho, wo, c, OFFSETS, 3)
    nbytes = (c * h * w * 2 + OFFSETS * ho * wo * 4 + (c + OFFSETS) * c * 9 * 2
              + c * ho * wo * 2)
    return max(ops / BF16_TENSOR_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def dcn_bound_s(h: int, w: int, model: Dict) -> float:
    """Least time of the deformable sites of one h x w image."""
    return sum(site_bound_s(c, hh, ww, ho, wo) for c, hh, ww, _, ho, wo in sites(h, w, model))


def boxes_bound_s(box_pixels: float, taken: float) -> float:
    """Least time of the boxes of ``taken`` components whose bounding boxes
    hold ``box_pixels`` pixels in all."""
    return (box_pixels * BOX_PIXEL_BYTES + taken * COMPONENT_BYTES) / HBM_BYTES_PER_S


def ccl_bound_s(pixels: float, taken: float) -> float:
    """Least time of one labelling over ``pixels`` map pixels inside the
    extents that takes ``taken`` components."""
    return (pixels * LABEL_PIXEL_BYTES + taken * LABEL_COMPONENT_BYTES) / HBM_BYTES_PER_S
