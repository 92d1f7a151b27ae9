"""Operations and bytes the benchmark's rooflines divide by, and the peaks.

The counts follow from the configuration's widths and the input's size,
whatever implements the model: a 3x3 conv of an H x W map from C_in to
C_out channels is 2 * H * W * C_in * C_out * 9 operations; pools halve H
and W with a floor. The model's count is taken at each image's resized
size (its true extent), not at the padded bucket it runs in.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
BF16_TENSOR_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# one IoU test of a box pair: 4 min/max, 2 widths, 2 clamps, a product,
# the union's sum and difference, and the compare against the threshold
# (the count the port's kernel table uses)
IOU_PAIR_OPS = 16


def conv3x3(h: int, w: int, cin: int, cout: int) -> float:
    return 2.0 * h * w * cin * cout * 9


def block1(h: int, w: int, model: Dict) -> float:
    """VGG block 1 (``conv1_1``, ``conv1_2``) of one image."""
    (_, reps, ch), = [s for s in model["vgg_stages"] if s[0] == 1]
    total, cin = 0.0, 3
    for _ in range(reps):
        total += conv3x3(h, w, cin, ch)
        cin = ch
    return total


def model_flops(h: int, w: int, model: Dict) -> float:
    """Operations of the CTPN network on one h x w image."""
    total, cin = 0.0, 3
    stages = model["vgg_stages"]
    for block, reps, ch in stages:
        for _ in range(reps):
            total += conv3x3(h, w, cin, ch)
            cin = ch
        if block < len(stages):
            h, w = h // 2, w // 2
    rpn = model["rpn_channels"]
    total += conv3x3(h, w, cin, rpn)
    hid, out, a = model["lstm_hidden"], model["lstm_out"], model["num_anchors"]
    cells = h * w
    total += 2.0 * cells * rpn * 8 * hid  # both directions' input projections
    total += 2 * 2.0 * cells * hid * 4 * hid  # the recurrences
    total += 2.0 * cells * 2 * hid * out  # the output projection
    total += 2.0 * cells * out * a * 6  # 4 deltas and 2 scores per anchor
    return total


def nms_bound_s(candidates: int, pair_tests: int) -> float:
    """Least time of one greedy NMS over ``candidates`` boxes: its boxes
    (4 float32) and flags read once, its keep flags written once, against
    ``pair_tests`` IoU tests at the float32 peak."""
    nbytes = candidates * (16 + 1 + 1)
    return max(nbytes / HBM_BYTES_PER_S, pair_tests * IOU_PAIR_OPS / F32_OPS_PER_S)
