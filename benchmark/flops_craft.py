"""Operations and bytes of CRAFT (``configs/craft_vgg16bn.json``) that its
metrics divide by; the peaks are ``flops.py``'s.

The network's count follows from the widths and the image's resized size
(its true extent, not the padded bucket): a k x k conv of an H x W map
from C_in to C_out channels is 2 * H * W * C_in * C_out * k * k
operations (fc6's dilation changes nothing), each 2x2 pool halves H and W
with a floor, each resize goes to its tap's size; the pools, resizes,
ReLUs and concats are not counted.

The two post-process kernels are held to the bytes their work needs,
counted on the reference's own components (``reference/craft.py``): the
labelling reads the two maps (8 bytes a pixel) and writes a label (4
bytes) over each image's extent, and writes each kept component's record
(6 ints and a score); the boxes read, over each kept component's box, its
labels and maps (12 bytes a pixel) and write its record (9 floats). Their
arithmetic (a union per touching run, a hull and calipers per component)
is far below the float peak, so bytes bound them.
"""

from __future__ import annotations

from typing import Dict

from flops import HBM_BYTES_PER_S

LABEL_PIXEL_BYTES = 8 + 4  # the two maps read, a label written
COMPONENT_BYTES = 7 * 4  # [label, area, x, y, w, h] and the score
BOX_PIXEL_BYTES = 4 + 8  # a label and the two maps read
RECORD_BYTES = 9 * 4


def conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h * w * cin * cout * k * k


def parts(h: int, w: int, model: Dict) -> Dict[str, float]:
    """Operations of CRAFT on one h x w image: ``trunk`` (conv1_1 to
    conv5_2), ``fc`` (fc6, fc7) and ``decoder`` (the four blocks and
    conv_cls)."""
    trunk, cin, taps = 0.0, 3, []
    for block, reps, ch in model["vgg_stages"]:
        for _ in range(reps):
            trunk += conv(h, w, cin, ch, 3)
            cin = ch
        if block >= 2:
            taps.append((h, w, ch))
        if block < 5:
            h, w = h // 2, w // 2
    h5, w5, c5 = taps[-1]
    fcw = model["fc_width"]
    fc = conv(h5, w5, c5, fcw, 3) + conv(h5, w5, fcw, fcw, 1)
    dec, prev = 0.0, fcw
    for (th, tw, tc), (mid, out) in zip(taps[::-1], model["up_widths"]):
        dec += conv(th, tw, prev + tc, mid, 1) + conv(th, tw, mid, out, 3)
        prev = out
    th, tw, _ = taps[0]
    c1, c2, c3, c4 = model["cls_widths"]
    dec += (conv(th, tw, prev, c1, 3) + conv(th, tw, c1, c2, 3) + conv(th, tw, c2, c3, 3)
            + conv(th, tw, c3, c4, 1) + conv(th, tw, c4, model["out_channels"], 1))
    return {"trunk": trunk, "fc": fc, "decoder": dec}


def model_flops(h: int, w: int, model: Dict) -> float:
    """Operations of CRAFT on one h x w image."""
    return sum(parts(h, w, model).values())


def ccl_bound_s(pixels: float, kept: float) -> float:
    """Least time of one labelling over ``pixels`` map pixels inside the
    extents that keeps ``kept`` components."""
    return (pixels * LABEL_PIXEL_BYTES + kept * COMPONENT_BYTES) / HBM_BYTES_PER_S


def boxes_bound_s(box_pixels: float, kept: float) -> float:
    """Least time of the boxes of ``kept`` components whose boxes hold
    ``box_pixels`` pixels in all."""
    return (box_pixels * BOX_PIXEL_BYTES + kept * (COMPONENT_BYTES + RECORD_BYTES)
            ) / HBM_BYTES_PER_S
