"""Operation counts of ``flops.py`` against hand-worked figures."""

import pytest

import flops
from conftest import BENCH
from harness.core import load_json

MODEL = load_json(BENCH / "configs" / "ctpn_vgg16_h.json")["model"]


def test_block1_at_the_stem_kernels_shape():
    # 2 * 608 * 912 * (3 * 64 + 64 * 64) * 9 per image, 8 images: the
    # 3.42e11 bf16 FLOP of the fused stem's roofline
    assert 8 * flops.block1(608, 912, MODEL) == pytest.approx(3.42386e11, rel=1e-5)


def test_model_counts_the_true_extent_not_the_bucket():
    at_600x900 = flops.model_flops(600, 900, MODEL)
    assert at_600x900 == pytest.approx(3.4252e11, rel=1e-4)
    assert flops.model_flops(608, 912, MODEL) > at_600x900


def test_lstm_and_heads_are_counted():
    # 37 x 56 cells after four floor-halvings of 600 x 900
    cells = 37 * 56
    convs = flops.model_flops(600, 900, MODEL) - cells * (
        2 * 512 * 1024 + 2 * 2 * 128 * 512 + 2 * 256 * 512 + 2 * 512 * 60)
    h, w, cin, total = 600, 900, 3, 0.0
    for block, reps, ch in MODEL["vgg_stages"]:
        for _ in range(reps):
            total += 2 * h * w * cin * ch * 9
            cin = ch
        if block < 5:
            h, w = h // 2, w // 2
    total += 2 * h * w * 512 * 512 * 9
    assert convs == pytest.approx(total)


def test_nms_bound_takes_the_larger_of_bytes_and_operations():
    assert flops.nms_bound_s(12000, 0) == pytest.approx(12000 * 18 / 3.35e12)
    assert flops.nms_bound_s(100, 10**9) == pytest.approx(16e9 / 67e12)
