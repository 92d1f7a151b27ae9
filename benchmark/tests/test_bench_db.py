"""DB's operation counts and bounds (``flops_db.py``) against hand-worked
figures, the reference's input rule at the cell's size, the readers of the
cell's per-layer metrics, and the cell end to end on the CPU at a tiny
size (``db_replay``)."""

import json

import numpy as np
import pytest

import flops_db
from conftest import BENCH, ROOT
from harness.core import load_json, load_module

CONFIG = load_json(BENCH / "configs" / "dbnet_r50_dcn.json")
MODEL = CONFIG["model"]


def test_parts_at_the_cells_size():
    # ResNet-50 with 13 deformable 3x3 convs at 736x1312: 165 GFLOP in the
    # trunk (58 of them the deformable products, 7 their offset convs), 38
    # in the neck, 20 in the head
    p = flops_db.parts(736, 1312, MODEL)
    assert p["trunk"] == pytest.approx(164.58714624e9)
    assert p["dcn_product"] == pytest.approx(57.845219328e9)
    assert p["dcn_offsets"] == pytest.approx(7.274105856e9)
    assert p["neck"] == pytest.approx(38.47077888e9)
    assert p["head"] == pytest.approx(19.899744256e9)
    assert flops_db.model_flops(736, 1312, MODEL) == pytest.approx(222.957669376e9)
    # the first site: 128 channels at 184x328, stride 2, out at 92x164
    assert flops_db.conv(92, 164, 128, 128, 3) == pytest.approx(2 * 92 * 164 * 128 * 128 * 9)


def test_kernel_work_bounds_the_labelling_and_the_boxes():
    """The labelling's least time over the reference's extents (8 bytes a
    pixel, 28 a taken component) and the boxes' (``flops_db``), per batch,
    and the generic ``ccl_roofline`` reader reads the labelling's on DB's
    trace (its four ``ccl_label_*`` kernels a run)."""
    from drivers import db_replay

    res = [{"maps": np.zeros((736, 1312)), "taken": 10, "box_pixels": 5000},
           {"maps": np.zeros((736, 1300)), "taken": 20, "box_pixels": 7000}]
    work = db_replay.kernel_work(res, 32)
    pixels, taken = (736 * 1312 + 736 * 1300) / 2 * 32, 15 * 32
    assert work["ccl_label"] == {"bound_s_per_run": pytest.approx(
        (pixels * 8 + taken * 28) / 3.35e12), "launches_per_run": 4}
    assert work["db_boxes"] == {"bound_s_per_run": pytest.approx(
        flops_db.boxes_bound_s(6000 * 32, taken)), "launches_per_run": 1}
    assert flops_db.ccl_bound_s(1000, 2) == pytest.approx((8000 + 56) / 3.35e12)
    trace = {"kernels": {"void ccl_label_runs_kernel<1>(...)": {"s": 0.004, "n": 4},
                         "void ccl_label_union_kernel<true>(...)": {"s": 0.004, "n": 4},
                         "void ccl_label_stats_kernel<1>(...)": {"s": 0.004, "n": 4},
                         "void ccl_label_compact_kernel(...)": {"s": 0.004, "n": 4}}}
    run = _Run({"trace": trace, "ccl_label": work["ccl_label"]})
    # 16 ms over 4 runs: 4 ms a run
    assert _reader("ccl_roofline").read(run) == pytest.approx(
        100 * work["ccl_label"]["bound_s_per_run"] / 0.004)


def test_the_sites_are_stages_two_to_four():
    sites = flops_db.sites(736, 1312, MODEL)
    assert len(sites) == 13
    assert sites[0] == (128, 184, 328, 2, 92, 164) and sites[1] == (128, 92, 164, 1, 92, 164)
    assert sites[4] == (256, 92, 164, 2, 46, 82) and sites[-1] == (512, 23, 41, 1, 23, 41)


def test_bounds_count_bytes_at_the_hbm_rate():
    # a stride-1 site of 512 channels at 23x41: 7.0 MB (the input and
    # output in bf16, 27 float32 offsets a pixel, two weights) take 2.1 us,
    # 4.7 GFLOP (the product and the offset conv) 4.7 us: bound by its
    # operations, as every site is at the cell's size
    c, px = 512, 23 * 41
    nbytes = c * px * 2 * 2 + 27 * px * 4 + (c + 27) * c * 9 * 2
    ops = 2.0 * px * c * (c + 27) * 9
    assert ops / 989e12 > nbytes / 3.35e12
    assert flops_db.site_bound_s(c, 23, 41, 23, 41) == pytest.approx(ops / 989e12)
    # a few channels on a wide map: bound by its bytes
    c, px = 8, 92 * 164
    nbytes = c * px * 2 * 2 + 27 * px * 4 + (c + 27) * c * 9 * 2
    assert flops_db.site_bound_s(c, 92, 164, 92, 164) == pytest.approx(nbytes / 3.35e12)
    assert flops_db.boxes_bound_s(100, 2) == pytest.approx((800 + 2 * 64) / 3.35e12)
    assert flops_db.dcn_bound_s(736, 1312, MODEL) == pytest.approx(
        sum(flops_db.site_bound_s(c, h, w, ho, wo)
            for c, h, w, _, ho, wo in flops_db.sites(736, 1312, MODEL)))


def test_the_cells_images_take_db_resize():
    from reference.db import prep

    config = dict(CONFIG, buckets=[[736, 1312]])
    im = np.full((720, 1280, 3), 7, np.uint8)
    x, info = prep(im, config)
    assert x.shape == (736, 1312, 3) and info.tolist() == [736, 1312, 720, 1280]
    assert (x == 7).all()


def _reader(name):
    import run as R

    return load_module(R.reader_path(name), "metric_" + name.replace(".", "_"))


class _Run:
    def __init__(self, readings, chips=1):
        self.readings = readings
        self.chips = chips


def test_readers_read_the_stage_clock_and_the_bounds():
    stages = {f"dcn{k:02d}_{s}": 0.1 for k in range(1, 14) for s in ("in", "out")}
    stages.update(trunk=0.3, neck=0.5, head=0.25, label=0.2, boxes=0.05)
    run = _Run({"stage_ms_per_img": stages, "dcn_bound_ms_per_img": 0.26,
                "trace": {"kernels": {"void db_boxes_kernel(...)": {"s": 0.002, "n": 4}},
                          "busy_s": 2.0, "window_s": 3.0},
                "db_boxes": {"bound_s_per_run": 1e-4, "launches_per_run": 1},
                "imgs_per_s": 100.0, "flops_per_img": 223e9})
    assert _reader("db_trunk_ms_per_img").read(run) == pytest.approx(26 * 0.1 + 0.3)
    assert _reader("db_dcn_ms_per_img").read(run) == pytest.approx(1.3)
    assert _reader("db_decoder_ms_per_img").read(run) == pytest.approx(0.75)
    assert _reader("db_post_ms_per_img").read(run) == pytest.approx(0.25)
    assert _reader("deform_conv_roofline").read(run) == pytest.approx(100 * 0.26 / 1.3)
    assert _reader("db_boxes_roofline").read(run) == pytest.approx(100 * 1e-4 / 5e-4)
    assert _reader("mfu.db").read(run) == pytest.approx(100 * 100 * 223e9 / 989e12)
    assert _reader("device_idle_pct.db").read(run) == pytest.approx(100 / 3)


@pytest.mark.parametrize("name", ["db_trunk_ms_per_img", "db_dcn_ms_per_img",
                                  "db_decoder_ms_per_img", "db_post_ms_per_img",
                                  "deform_conv_roofline", "db_boxes_roofline"])
def test_readers_find_nothing_where_the_program_stamps_nothing(name):
    """A run without DB's stamps, trace and bounds reads nothing, and no
    reader raises."""
    assert _reader(name).read(_Run({})) is None
    if name in ("db_dcn_ms_per_img", "deform_conv_roofline"):  # no site stamped
        run = _Run({"stage_ms_per_img": {"trunk": 1.0, "neck": 1.0},
                    "dcn_bound_ms_per_img": 0.2})
        assert _reader(name).read(run) is None


def tiny_overrides():
    from tiny import overrides

    o = overrides("db_device_b32")
    o["config"]["TEXT"] = dict(CONFIG["TEXT"], DB_SHORT_SIDE=96)
    o["config"]["buckets"] = [[96, 160]]
    o["traffic"].update(image=[144, 96], bucket=[96, 160])
    return o


def test_stage_times_come_from_the_captured_programs_stage_clock():
    import torch

    from drivers import common, db_replay
    from harness.core import Run

    from ctpn_tpu_torch.utils import timer

    r = Run("db_device_b32", 3000000019, 1.0, True, ROOT, device="cpu",
            overrides=tiny_overrides())
    common.predictor(r)  # applies the configuration
    x = torch.zeros((2, 96, 160, 3), dtype=torch.uint8)
    info = torch.tensor([[96, 160, 96, 144]] * 2, dtype=torch.float32)
    was = timer.enabled()
    stages = db_replay.stage_ms(r, x, info, replays=2)
    assert timer.enabled() == was
    assert set(stages) == set(timer.DB_STAGES[1:])
    assert all(v >= 0 for v in stages.values())


@pytest.mark.parametrize("trace", ["0", "1"])
def test_tiny_cell_prints_its_result_line(trace, capsys):
    import run as R

    args = R.parse(["--workload", "db_device_b32", "--seed", "3000000019", "--seconds", "2",
                    "--trace", trace])
    out = R.execute(args, ROOT, device="cpu", overrides=tiny_overrides())
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert out["attempted"] > 0 and set(out["compared"]) >= {"repeat_mismatches",
                                                              "cap_overflow", "map_gap"}
    if trace == "0":
        assert set(out["metrics"]) == {"imgs_per_s", "setup_s"}
    else:
        # on the CPU the stage clock is not read and there is no trace: the
        # host-clock share alone
        assert set(out["metrics"]) <= {"mfu.db"}


def boxes_overrides():
    """The tiny cell at a size where DB's boxes survive on both sides with
    the representer's own constants: 384x216 renders at a short side of
    224 (416 wide), where the shipped weights keep a box or two an image."""
    o = tiny_overrides()
    o["config"]["TEXT"] = dict(CONFIG["TEXT"], DB_SHORT_SIDE=224)
    o["config"]["buckets"] = [[224, 416]]
    o["traffic"].update(image=[384, 216], bucket=[224, 416])
    return o


@pytest.mark.parametrize("fault", [None, "shift", "half"])
def test_a_broken_timed_path_is_not_correct(fault, capsys):
    """Every box 24 px lower, or every other slot answered with nothing
    (``tiny.py``'s faults, applied where the program answers), makes
    ``correct`` false through ``box_gap_px``: a box with no counterpart
    counts at the 16 px cap, against a limit of 0.5; the unbroken path at
    the same size is correct, with boxes on both sides."""
    import run as R
    from tiny import FAULTS

    args = R.parse(["--workload", "db_device_b32", "--seed", "3000000019", "--seconds", "1",
                    "--trace", "0"])
    out = R.execute(args, ROOT, device="cpu", overrides=boxes_overrides(),
                    fault=FAULTS[fault] if fault else None)
    counts = [line for line in capsys.readouterr().err.splitlines() if "] counts: " in line]
    boxes = json.loads(counts[-1].split("] counts: ", 1)[1])["boxes"]
    assert boxes["reference"] > 0 and boxes["program"] > 0
    gap = out["compared"]["box_gap_px"]
    if fault is None:
        assert out["correct"] is True and boxes["paired"] == boxes["reference"]
    else:
        assert out["correct"] is False and gap["value"] > gap["limit"]
        assert boxes["paired"] < boxes["reference"]
