"""CRAFT's operation counts and bounds (``flops_craft.py``) against
hand-worked figures, and the reference's input rule at the cell's size."""

import numpy as np
import pytest

import flops_craft
from conftest import BENCH
from harness.core import load_json

CONFIG = load_json(BENCH / "configs" / "craft_vgg16bn.json")
MODEL = CONFIG["model"]


def test_parts_at_720p():
    # VGG16 to conv5_2 at 720x1280, fc6 and fc7 at 45x80, the decoder at
    # strides 16, 8, 4 and 2: 547, 42 and 67 GFLOP
    p = flops_craft.parts(720, 1280, MODEL)
    assert p["trunk"] == pytest.approx(546.766848e9)
    assert p["fc"] == pytest.approx(2 * 45 * 80 * (512 * 1024 * 9 + 1024 * 1024))
    assert p["decoder"] == pytest.approx(67.3726464e9)
    assert flops_craft.model_flops(720, 1280, MODEL) == pytest.approx(655.663104e9)


def test_bounds_count_bytes_at_the_hbm_rate():
    assert flops_craft.ccl_bound_s(1000, 0) == pytest.approx(12000 / 3.35e12)
    assert flops_craft.boxes_bound_s(100, 2) == pytest.approx((1200 + 2 * 64) / 3.35e12)


def test_the_cells_images_take_factor_one():
    from reference.craft import extent, prep

    config = dict(CONFIG, buckets=[[736, 1280]])
    im = np.full((720, 1280, 3), 7, np.uint8)
    x, info, f = prep(im, config)
    assert f == 1.0 and x.shape == (736, 1280, 3) and info.tolist() == [720, 1280, 1.0]
    assert (x[:720] == 7).all() and (x[720:] == 0).all()
    assert extent(info) == (360, 640)


def test_stage_times_come_from_the_captured_programs_stage_clock():
    """``stage_ms`` builds a traced predictor and reads its stage clock's
    rows (on the CPU the clock is the host's, the program eager): every
    stage after ``start``, each a time, and tracing left as it was."""
    import torch

    from conftest import ROOT
    from drivers import common, craft_replay
    from harness.core import Run
    from tiny import overrides

    from ctpn_tpu_torch.utils import timer

    r = Run("craft_device_b32", 3000000019, 1.0, True, ROOT, device="cpu",
            overrides=overrides("craft_device_b32"))
    common.predictor(r)  # applies the configuration
    t = r.traffic
    x = torch.zeros((2, *t["bucket"], 3), dtype=torch.uint8)
    info = torch.tensor([[t["bucket"][0], t["bucket"][1], 1.0]] * 2)
    was = timer.enabled()
    stages = craft_replay.stage_ms(r, x, info, replays=2)
    assert timer.enabled() == was
    assert set(stages) == {"trunk", "decoder", "label", "boxes"}
    assert all(v >= 0 for v in stages.values()) and stages["trunk"] > 0
