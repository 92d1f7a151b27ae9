"""DBNet-ResNet50-DCN in the port, held against its plain reference
``ctpn_tpu_torch/plain/db.py`` on the CPU.

The reference is DB's specification written out in plain PyTorch and
NumPy (float32 network with its batch norms unfolded, the deformable conv
as gathers and a matmul; MhLiao's ``boxes_from_bitmap`` with its own
8-connected labelling, hull, calipers, fill and closed-form unclip); the
JAX package has no DB. The kernels' plain versions (``ops/deform_conv.py``,
``ops/ccl.py`` at 8-connectivity, ``ops/db_boxes.py``) are what the card's
kernels are held to by ``chip_smoke.py --db``; here they are held to the
reference, to direct loops, and to OpenCV where ``cv2`` imports.

Tolerances are written beside each comparison, with the bfloat16 program
held to show that it misses them by far.
"""

import ast
import math
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

from ctpn_tpu_torch.cli import train_db_synth as T
from ctpn_tpu_torch.config import cfg_from_list, reset_cfg
from ctpn_tpu_torch.inference.pipeline import CTPNPredictor, DBPredictor
from ctpn_tpu_torch.models.dbnet import DBNet
from ctpn_tpu_torch.models.resnet import DeformConv3x3
from ctpn_tpu_torch.models.vgg import Conv3x3
from ctpn_tpu_torch.ops import deform_conv as D
from ctpn_tpu_torch.ops.ccl import ccl_label, ccl_label_ref, component_labels
from ctpn_tpu_torch.ops.db_boxes import db_boxes_ref, mini_order
from ctpn_tpu_torch.plain import db as plain
from ctpn_tpu_torch.postprocess.db import compacted, db_postprocess
from ctpn_tpu_torch.utils import timer
from ctpn_tpu_torch.utils.image import db_resize_size
from ctpn_tpu_torch.utils.weights import (_flatten, db_params_from_mhliao, load_params,
                                          params_from_jax, params_to_jax)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "data" / "artifacts" / "dbnet_r50_dcn_synth.npz"
TEXT = {"DB_THRESH": 0.3, "DB_BOX_THRESH": 0.7, "DB_UNCLIP_RATIO": 1.5, "DB_MIN_SIZE": 3,
        "DB_SHORT_SIDE": 96, "max_candidates": 100}
KW = dict(thresh=0.3, box_thresh=0.7, unclip_ratio=1.5, min_size=3.0, max_boxes=100)
CONFIG = {"pixel_means": list(T.PIXEL_MEANS), "pixel_stds": [T.PIXEL_STD] * 3,
          "channel_order": "BGR", "TEXT": TEXT, "program": {"TPU.DB_MAX_BOXES": 100},
          "buckets": [[96, 160]]}


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def _db_cfg(dtype="float32"):
    cfg_from_list(["NET_NAME", "DB_RESNET50_DCN", "TPU.BUCKETS", [[96, 160]],
                   "TEXT.DB_SHORT_SIDE", 96, "CHANNEL_ORDER", "BGR",
                   "PIXEL_MEANS", list(T.PIXEL_MEANS), "PIXEL_STDS", [T.PIXEL_STD] * 3,
                   "TPU.COMPUTE_DTYPE", dtype])


# ------------------------------------------------------------ deform conv
def _direct(x, om, wt, s):
    """The contract one output point, tap and channel at a time, in double."""
    n, c, h, w = x.shape
    o = wt.shape[0]
    ho, wo = om.shape[2:]
    out = np.zeros((n, o, ho, wo))
    xs, oms, ws = x.double().numpy(), om.double().numpy(), wt.double().numpy()
    for b in range(n):
        for yo in range(ho):
            for xo in range(wo):
                for k in range(9):
                    i, j = divmod(k, 3)
                    py = yo * s - 1 + i + oms[b, 2 * k, yo, xo]
                    px = xo * s - 1 + j + oms[b, 2 * k + 1, yo, xo]
                    m = 1 / (1 + math.exp(-oms[b, 18 + k, yo, xo]))
                    if not (py > -1 and px > -1 and py < h and px < w):
                        continue
                    y0, x0 = math.floor(py), math.floor(px)
                    ly, lx = py - y0, px - x0
                    v = np.zeros(c)
                    for dy, dx, wgt in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx),
                                        (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
                        if 0 <= y0 + dy < h and 0 <= x0 + dx < w:
                            v += wgt * xs[b, :, y0 + dy, x0 + dx]
                    out[b, :, yo, xo] += ws[:, :, i, j] @ (v * m)
    return out


def _deform_case(name, seed=0):
    g = torch.Generator().manual_seed(seed)
    n, c, h, w, o, s = 2, 8, 7, 9, 5, 1
    if name == "stride2":
        s = 2
    ho, wo = D.out_size(h, w, s)
    x = torch.randn(n, c, h, w, generator=g)
    om = torch.randn(n, 27, ho, wo, generator=g)
    if name == "leave_the_map":  # offsets of several pixels: many samples outside
        om[:, :18] *= 6.0
    elif name == "integers":  # whole-pixel offsets: samples on the grid
        om[:, :18] = torch.randint(-2, 3, (n, 18, ho, wo), generator=g).float()
    elif name == "zero_masks":
        om[:, 18:] = -200.0
    else:
        om[:, :18] *= 1.3  # between pixels
    return x, om, torch.randn(o, c, 3, 3, generator=g) * 0.3, s


DEFORM_CASES = ["between", "stride2", "leave_the_map", "integers", "zero_masks"]


@pytest.mark.parametrize("name", DEFORM_CASES)
def test_deform_conv_is_the_direct_loop(name):
    x, om, wt, s = _deform_case(name)
    want = _direct(x, om, wt, s)
    got = D.deform_conv(x, om, wt, s)  # the op: the plain version on the CPU
    assert got.shape == want.shape and got.dtype == torch.float32
    # float32 blends and sums against double: a few ulps of values near 1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    if name == "zero_masks":
        assert not got.abs().max()
    # bfloat16 columns and weights miss by far more than the tolerance
    low = D.deform_conv(x.to(torch.bfloat16), om, wt.to(torch.bfloat16), s)
    if name != "zero_masks":
        assert np.abs(low.float().numpy() - want).max() > 2e-4


def test_integer_offsets_shift_the_plain_conv():
    """Whole-pixel offsets and masks of 1 sample on the grid: the
    deformable conv is the plain conv of the shifted input."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 8, 10, 12, generator=g)
    wt = torch.randn(4, 8, 3, 3, generator=g)
    om = torch.zeros(1, 27, 10, 12)
    om[:, 0:18:2] = 1.0  # one row down
    om[:, 18:] = 60.0  # sigmoid 1
    got = D.deform_conv(x, om, wt, 1)
    # tap i of row yo reads row yo + i: the window one row lower
    want = torch.nn.functional.conv2d(torch.nn.functional.pad(x, (1, 1, 0, 2)), wt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_deform_conv_checks_its_contract():
    x, om, wt, s = _deform_case("between")
    with pytest.raises(ValueError, match="stride"):
        D.deform_conv(x, om, wt, 3)
    with pytest.raises(ValueError, match="om must be"):
        D.deform_conv(x, om[:, :26], wt, s)
    with pytest.raises(ValueError, match="weight must be"):
        D.deform_conv(x, om, wt[:, :4], s)
    assert D.out_size(736, 1312, 2) == (368, 656) and D.out_size(7, 9, 2) == (4, 5)


def test_deform_conv_trains_through_the_plain_version():
    x, om, wt, s = _deform_case("between")
    x, om, wt = (t.clone().requires_grad_() for t in (x, om, wt))
    D.deform_conv_ref(x, om, wt, s).square().sum().backward()
    for t in (x, om, wt):
        assert t.grad is not None and torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
    # the offsets' gradient: d out / d dy by finite differences at one point
    x2, om2, wt2, _ = _deform_case("between")
    k, eps = 4, 1e-3
    plus, minus = om2.clone(), om2.clone()
    plus[0, 2 * k, 3, 4] += eps
    minus[0, 2 * k, 3, 4] -= eps
    fd = ((D.deform_conv_ref(x2, plus, wt2, s).square().sum()
           - D.deform_conv_ref(x2, minus, wt2, s).square().sum()) / (2 * eps))
    assert float(om.grad[0, 2 * k, 3, 4]) == pytest.approx(float(fd), rel=2e-2, abs=1e-3)


# ------------------------------------------------------------- labelling
def _flood(on: np.ndarray, eight: bool) -> np.ndarray:
    """Least raster index of each on pixel's component by breadth-first
    flood fill, -1 off."""
    h, w = on.shape
    out = np.full((h, w), -1, np.int64)
    steps = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if eight:
        steps += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    for y in range(h):
        for x in range(w):
            if not on[y, x] or out[y, x] >= 0:
                continue
            out[y, x] = y * w + x
            q = deque([(y, x)])
            while q:
                cy, cx = q.popleft()
                for dy, dx in steps:
                    ny, nx = cy + dy, cx + dx
                    if 0 <= ny < h and 0 <= nx < w and on[ny, nx] and out[ny, nx] < 0:
                        out[ny, nx] = y * w + x
                        q.append((ny, nx))
    return out


@pytest.mark.parametrize("density", [0.3, 0.45, 0.6])
def test_eight_connected_labels_are_a_flood_fill(density):
    rng = np.random.RandomState(int(density * 100))
    prob = np.where(rng.rand(3, 30, 41) < density, rng.uniform(0.31, 1, (3, 30, 41)),
                    rng.uniform(0, 0.3, (3, 30, 41))).astype(np.float32)
    prob[0, 5, 5] = 0.3  # exactly the threshold: off
    ext = torch.tensor([[30, 41], [22, 35], [30, 1]], dtype=torch.int32)
    got = ccl_label(torch.from_numpy(prob[..., None]), ext, 0.3, 0.0, 0.0, 1, 500,
                    connectivity=8)
    for b in range(3):
        eh, ew = ext[b].tolist()
        on = np.zeros((30, 41), bool)
        on[:eh, :ew] = prob[b, :eh, :ew] > np.float32(0.3)
        want = _flood(on, True)
        want = np.where(want >= 0, (want // 41) * 41 + want % 41, -1)
        assert np.array_equal(got[0][b].numpy(), want)
        assert int(got[5][b]) == int(on.sum())
        assert int(got[6][b]) == len(set(want[want >= 0].tolist()))
    # the labels as the plain rule computes them, one image at a time too
    assert torch.equal(component_labels(torch.from_numpy(prob > 0.3), 8)[1],
                       torch.from_numpy(_flood(prob[1] > 0.3, True)))


def test_four_connectivity_stays_crafts():
    """A diagonal pair is one component at 8-connectivity, two at 4; the
    default is 4 (CRAFT's call), and a one-channel map reads no link."""
    m = np.full((1, 6, 6, 2), -1.0, np.float32)
    m[0, 1, 1, 0] = m[0, 2, 2, 0] = 0.9
    m[0, 4, 4, 1] = 0.9  # a link alone
    t, ext = torch.from_numpy(m), torch.tensor([[6, 6]], dtype=torch.int32)
    four = ccl_label(t, ext, 0.4, 0.4, 0.0, 1, 8)
    assert torch.equal(torch.stack(four[4:]), torch.stack(ccl_label(t, ext, 0.4, 0.4, 0.0, 1,
                                                                    8, connectivity=4)[4:]))
    assert int(four[6][0]) == 3
    assert int(ccl_label(t, ext, 0.4, 0.4, 0.0, 1, 8, connectivity=8)[6][0]) == 2
    one = ccl_label(t[..., :1].contiguous(), ext, 0.4, 0.4, 0.0, 1, 8, connectivity=8)
    assert (int(one[5][0]), int(one[6][0])) == (2, 1)
    a = ccl_label_ref(t, ext, 0.4, 0.4, 0.0, 1, 8)
    assert all(torch.equal(x, y) for x, y in zip(four, a))
    with pytest.raises(ValueError, match="connectivity"):
        ccl_label(t, ext, 0.4, 0.4, 0.0, 1, 8, connectivity=6)


# ------------------------------------------------------------------ boxes
def _rect_map(h, w, rects, value=0.9, bg=0.05, seed=0):
    """(h, w) map: ``value`` inside each rotated rectangle (cx, cy, angle,
    length, thickness), ``bg`` elsewhere with a little noise."""
    rng = np.random.RandomState(seed)
    m = (bg + rng.uniform(0, 0.05, (h, w))).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for cx, cy, a, L, t in rects:
        u = (xx - cx) * math.cos(a) + (yy - cy) * math.sin(a)
        v = -(xx - cx) * math.sin(a) + (yy - cy) * math.cos(a)
        inside = (np.abs(u) <= L / 2) & (np.abs(v) <= t / 2)
        m[inside] = value - rng.uniform(0, 0.1, inside.sum())
    return m


def _box_case(name):
    """(map (h, w), extent, original size) of a named made-up case."""
    h, w = 48, 80
    if name == "empty":
        return np.full((h, w), 0.1, np.float32), (h, w), (h, w)
    if name == "words":
        return _rect_map(h, w, [(20, 10, 0.0, 24, 6), (55, 12, 0.0, 30, 8),
                                (30, 30, 0.3, 28, 7), (62, 36, -0.5, 20, 5)]), (h, w), (96, 160)
    if name == "diagonal_touch":  # two squares meeting at a corner: one component,
        # whose box, half background, scores under the threshold
        m = np.full((h, w), 0.05, np.float32)
        m[10:20, 10:20] = 0.9
        m[20:30, 20:30] = 0.9
        return m, (h, w), (h, w)
    if name == "small_and_faint":  # under min_size, and under box_thresh
        m = _rect_map(h, w, [(20, 20, 0.0, 30, 8)], value=0.6)
        m[5:7, 40:70] = 0.95  # 2 px tall
        m[30:40, 50:51] = 0.95  # 1 px wide
        return m, (h, w), (h, w)
    if name == "edges":  # boxes at the extent's edges, the extent cut (the third
        # keeps 2 rows inside it: under min_size)
        m = _rect_map(h, w, [(8, 3, 0.0, 16, 6), (70, 40, 0.2, 20, 8), (40, 44, 0.0, 30, 5)])
        return m, (44, 76), (88, 150)
    if name == "ring":  # a component with a hole: one box around it
        m = np.full((h, w), 0.05, np.float32)
        m[8:40, 10:60] = 0.9
        m[20:28, 25:45] = 0.1
        return m, (h, w), (h, w)
    raise KeyError(name)


BOX_CASES = ["empty", "words", "diagonal_touch", "small_and_faint", "edges", "ring"]


def _port_boxes(prob, ext, dest, cap=100):
    info = torch.tensor([[ext[0], ext[1], dest[0], dest[1]]], dtype=torch.float32)
    text, recs = db_postprocess(torch.from_numpy(prob[None].copy()), info,
                                dict(KW, max_boxes=cap), lambda name: None)
    return text, recs


@pytest.mark.parametrize("name", BOX_CASES)
def test_plain_kernels_give_the_reference_boxes_on_made_up_maps(name):
    prob, ext, dest = _box_case(name)
    text, recs = _port_boxes(prob, ext, dest)
    want, counts = plain.boxes_from_bitmap(prob[:ext[0], :ext[1]], dest, TEXT)
    n = int(recs.count[0])
    assert (int(text.on[0]), int(text.labelled[0]), n) == (
        counts["on"], counts["labelled"], counts["kept"])
    got = recs.recs[0, :n].numpy()
    # the corners are the same integers; the scores, means summed in
    # another order in double, agree to float32's last bits
    assert np.array_equal(got[:, :8], want[:, :8])
    np.testing.assert_allclose(got[:, 8], want[:, 8], rtol=1e-6)
    assert not recs.recs[0, n:].any() and recs.valid[0].sum() == n
    expect = {"empty": (0, 0), "words": (4, 4), "diagonal_touch": (1, 0),
              "small_and_faint": (3, 0), "edges": (3, 2), "ring": (1, 1)}[name]
    assert (int(text.labelled[0]), n) == expect


def test_records_are_unclipped_and_mapped_to_the_original_image():
    # a 24x6 axis-aligned bar, mapped from 60x40 to 90x80
    prob = np.full((40, 60), 0.05, np.float32)
    prob[10:16, 10:34] = 0.9
    _, recs = _port_boxes(prob, (40, 60), (80, 90))
    rec = recs.recs[0, 0].numpy()
    # the hull of the pixel centres, x 10..33 and y 10..15, is 23 x 5:
    # d = 23 * 5 * 1.5 / 56 on every side
    d = 23 * 5 * 1.5 / 56
    x0, x1, y0, y1 = 10 - d, 33 + d, 10 - d, 15 + d
    want = [x0, y0, x1, y0, x1, y1, x0, y1]
    scaled = [np.rint(np.float32(v) / np.float32(60 if i % 2 == 0 else 40)
                      * np.float32(90 if i % 2 == 0 else 80)) for i, v in enumerate(want)]
    np.testing.assert_array_equal(rec[:8], np.float32(scaled))
    assert rec[8] == pytest.approx(0.9, abs=1e-6)


def test_the_cap_takes_the_first_components_and_counts_the_rest():
    prob = np.full((40, 80), 0.05, np.float32)
    for i in range(24):
        y, x = 2 + 6 * (i // 8), 2 + 10 * (i % 8)
        prob[y:y + 4, x:x + 8] = 0.9
    full = _port_boxes(prob, (40, 80), (40, 80))
    capped = _port_boxes(prob, (40, 80), (40, 80), cap=5)
    assert (int(full[0].count[0]), int(full[0].overflow[0])) == (24, 0)
    assert (int(capped[0].count[0]), int(capped[0].overflow[0])) == (5, 19)
    assert int(capped[1].count[0]) == 5
    assert torch.equal(capped[1].recs[0, :5], full[1].recs[0, :5])
    want, counts = plain.boxes_from_bitmap(prob, (40, 80), dict(TEXT, max_candidates=5))
    assert counts["overflow"] == 19 and np.array_equal(want[:, :8], capped[1].recs[0, :5, :8])


def test_compaction_moves_the_kept_rows_first():
    recs = torch.arange(2 * 4 * 9, dtype=torch.float32).view(2, 4, 9)
    keep = torch.tensor([[0, 1, 0, 1], [1, 1, 1, 0]], dtype=torch.int32)
    out, n = compacted(recs, keep)
    assert n.tolist() == [2, 3]
    assert torch.equal(out[0, :2], recs[0, [1, 3]]) and not out[0, 2:].any()
    assert torch.equal(out[1, :3], recs[1, :3]) and not out[1, 3:].any()


def test_mini_order_is_get_mini_boxes():
    pts = np.array([[5, 1], [1, 3], [7, 6], [3, 8]], np.float32)
    assert mini_order(pts).tolist() == plain.mini_boxes(pts).tolist() == [
        [1, 3], [5, 1], [7, 6], [3, 8]]
    square = np.array([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32)
    assert mini_order(square).tolist() == [[0, 0], [4, 0], [4, 4], [0, 4]]


def test_boxes_agree_with_opencv_min_area_rect_and_contours():
    cv2 = pytest.importorskip("cv2")
    prob, ext, dest = _box_case("words")
    on = (prob > 0.3).astype(np.uint8)
    contours, _ = cv2.findContours(on, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    labels = plain.label8(on.astype(bool))
    assert len(contours) == labels.max()
    for k in range(1, labels.max() + 1):
        ys, xs = np.nonzero(labels == k)
        hull = plain.convex_hull(sorted(zip(xs.tolist(), ys.tolist()),
                                        key=lambda p: (p[1], p[0])))
        _, side = plain.min_area_rect(hull)
        pts = np.stack([xs, ys], 1).astype(np.int32)
        (_, _), (rw, rh), _ = cv2.minAreaRect(pts)
        assert side == pytest.approx(min(rw, rh), abs=1e-3)


def test_db_boxes_plain_version_checks_its_inputs():
    prob = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError, match="dest"):
        db_boxes_ref(prob, torch.zeros(1, 8, 8, dtype=torch.int32),
                     torch.zeros(1, 4, 6, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
                     torch.zeros(1, 2, dtype=torch.int32), torch.zeros(1, 3), 0.7, 1.5, 3.0)


# ---------------------------------------------------------------- network
def _weights(seed=0, offsets=2.0):
    """Seeded weights of the published widths in the port's layout, the
    offset convs scaled so that samples fall between pixels and off the
    map, the head's last bias set so that about a fifth of the map is on."""
    torch.manual_seed(seed)
    m = DBNet(dtype=torch.float32).eval()
    with torch.no_grad():
        for name, mod in m.named_modules():
            if name.endswith("conv2_offset"):
                mod.weight.mul_(offsets * 10)
                mod.bias.normal_(0, offsets)
    return m


def _images(n=2, seed=7):
    from ctpn_tpu_torch.data.synth import render_image

    rng = np.random.RandomState(seed)
    return [np.ascontiguousarray(render_image(rng, width=144, height=96)[0][..., ::-1])
            for _ in range(n)]


def _set_head(m, x):
    """The head's transposed convs made even over their 2x2 taps (a map of
    4x4 blocks, not of single pixels), the last scaled and shifted so that
    the logits spread by 2 and about a fifth of the map is over 0.6."""
    with torch.no_grad():
        for up in (m.decoder.bin_up1, m.decoder.bin_up2):
            up.weight.copy_(up.weight.mean((2, 3), keepdim=True).expand_as(up.weight))
        feats = m.neck(m.trunk(x))
        logit = m.head_logits(feats) - m.decoder.bin_up2.bias
        scale = 2.0 / float(logit.std())
        m.decoder.bin_up2.weight.mul_(scale)
        m.decoder.bin_up2.bias.fill_(math.log(0.6 / 0.4) - scale * float(
            torch.quantile(logit.flatten(), 0.8)))


def test_maps_agree_with_the_reference_in_float32_and_not_in_bfloat16():
    _db_cfg()
    m = _weights()
    params = params_to_jax(m.state_dict())
    pred = CTPNPredictor(params, model=m, device="cpu")
    preps = [pred.prep(im) for im in _images()]
    x = np.stack([p[0] for p in preps])
    info = np.stack([p[1] for p in preps])
    xn = (torch.from_numpy(x).float() - torch.tensor(T.PIXEL_MEANS)) / T.PIXEL_STD
    _set_head(m, xn)
    pred = CTPNPredictor(params_to_jax(m.state_dict()), model=m, device="cpu")
    text, recs = pred.run_batch(x, info)
    ref = plain.ReferenceDB(dict(CONFIG), dict(_flatten(params_to_jax(m.state_dict()))))
    res = ref.detect(x, info)
    for i, r in enumerate(res):
        got = text.maps[i, :r["maps"].shape[0], :r["maps"].shape[1]].numpy()
        # float32 sums in another order; the head's last layer is scaled
        # some 2000 times to give random weights a map of blocks, and the
        # differences before it grow with it: 5e-5 (bfloat16: over 1e-3)
        assert np.abs(got - r["maps"]).max() < 5e-5
        assert 0.05 < (got > 0.3).mean() < 0.6
    # bfloat16 (the port's compute type) misses the float32 tolerance
    mb = DBNet(dtype=torch.bfloat16).eval()
    mb.load_state_dict(m.state_dict())
    with torch.inference_mode():
        low = mb(xn)
    assert np.abs(low[0].numpy() - res[0]["maps"]).max() > 1e-3
    # the samples do leave the pixel grid and the map
    blk = m.backbone.layer2[0]
    with torch.no_grad():
        c = m.backbone.conv1.conv_relu(xn.permute(0, 3, 1, 2).contiguous())
        c = torch.nn.functional.max_pool2d(c, 3, 2, 1)
        for b in m.backbone.layer1:
            c = b(c)
        om = blk.conv2_offset(blk.conv1.conv_relu(c))[:, :18]
    assert (om.abs() > 3).float().mean() > 0.05 and (om.frac().abs() > 0.1).float().mean() > 0.5


def test_program_records_match_the_reference_in_float32():
    # random weights give no map of words: a box threshold of 0.35 keeps
    # boxes to compare (the rule, not the threshold, is under test)
    _db_cfg()
    cfg_from_list(["TEXT.DB_BOX_THRESH", 0.35])
    m = _weights(seed=1, offsets=0.5)
    preps = [plain.prep(im, CONFIG) for im in _images(3, seed=9)]
    x, info = np.stack([p[0] for p in preps]), np.stack([p[1] for p in preps])
    _set_head(m, (torch.from_numpy(x).float() - torch.tensor(T.PIXEL_MEANS)) / T.PIXEL_STD)
    params = params_to_jax(m.state_dict())
    pred = CTPNPredictor(params, model=m, device="cpu")
    _, recs = pred.run_batch(x, info)
    config = dict(CONFIG, TEXT=dict(TEXT, DB_BOX_THRESH=0.35))
    res = plain.ReferenceDB(config, dict(_flatten(params))).detect(x, info)
    total = 0
    for i, r in enumerate(res):
        n = int(recs.count[i])
        got = recs.recs[i, :n].numpy()
        assert n == len(r["recs"])
        # corners are rounded integers: a map 1e-6 apart may move one by a
        # pixel where a boundary pixel sits at the threshold
        if n:
            assert np.abs(got[:, :8] - r["recs"][:, :8]).max() <= 1
            np.testing.assert_allclose(got[:, 8], r["recs"][:, 8], atol=1e-5)
        total += n
    assert total > 0


def test_batch_norms_fold_into_the_convs_at_load():
    """A MhLiao/DB state dict (``module.`` prefixed, random batch-norm
    statistics, offset convs with their biases) through the loader: the
    port in float32 against the training module and the reference, which
    runs the batch norms unfolded."""
    torch.manual_seed(3)
    net = T.train_model().eval()
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.2, 0.2)
                mod.running_var.uniform_(0.5, 2.0)
                mod.weight.uniform_(0.5, 1.5)
                mod.bias.uniform_(-0.2, 0.2)
            if hasattr(mod, "conv2_offset"):
                mod.conv2_offset.weight.normal_(0, 0.02)
                mod.conv2_offset.bias.normal_(0, 1.0)
    state = {"module." + k: v for k, v in net.state_dict().items()}
    state["module.decoder.thresh.0.weight"] = torch.zeros(64, 256, 3, 3)  # not read
    port = DBNet(dtype=torch.float32).eval()
    port.load_state_dict(params_from_jax(db_params_from_mhliao(state)))
    x = torch.from_numpy(plain.prep(_images(1)[0], CONFIG)[0][None]).float()
    xn = (x - torch.tensor(T.PIXEL_MEANS)) / T.PIXEL_STD
    with torch.no_grad():
        want = net(xn.permute(0, 3, 1, 2))
        got = port(xn)
    # folded in double and stored in float32, every conv of the 50 rounds
    # its weights once more: 1e-4 (bfloat16 misses by over 1e-3)
    assert (got - want).abs().max() < 1e-4
    ref = plain.ReferenceDB(dict(CONFIG), state)
    np.testing.assert_allclose(ref.maps(x.to(torch.uint8).numpy())[0], want[0].numpy(),
                               atol=1e-4)


def test_stage_two_offset_convs_run_one_image_at_a_time():
    cfg_from_list(["NET_NAME", "DB_RESNET50_DCN"])
    from ctpn_tpu_torch.models.factory import get_network

    m = get_network("DB_RESNET50_DCN", "cpu")
    alone = {n for n, c in m.named_modules() if isinstance(c, Conv3x3) and c.per_image}
    assert alone == {f"backbone.layer2.{b}.conv2_offset" for b in range(4)}
    assert sum(isinstance(c, DeformConv3x3) for c in m.modules()) == m.sites == 13
    # the network built directly runs them so too: it is not an option
    direct = DBNet(dtype=torch.float32)
    assert {n for n, c in direct.named_modules()
            if isinstance(c, Conv3x3) and c.per_image} == alone


def test_chip_smokes_offset_statistics_by_hand():
    """``chip_smoke.offset_stats``, which reads the cell's offsets at the
    13 sites on the card, on a 2x2 map at stride 1 worked by hand: a tap's
    row is ``yo - 1 + i + dy``, off the map at <= -1 or >= 2."""
    import chip_smoke

    om = torch.zeros(1, D.OFFSETS, 2, 2)
    s = chip_smoke.offset_stats(om, 2, 2, 1)
    # zero offsets: every sample on the grid; rows -1 and 2 are 2 of the
    # 6 (yo, i) pairs, so 1 - (2/3)^2 of the samples are off the map
    assert s == {"mean_abs_dy": 0.0, "mean_abs_dx": 0.0, "between_pct": 0.0,
                 "near_grid_pct": 100.0, "off_map_pct": pytest.approx(100 * 5 / 9),
                 "mean_mask": 0.5}
    om[:, 0:18:2] = 0.5  # dy half a pixel: rows -0.5 .. 2.5, only 2.5 off
    om[:, 18:] = 2.0
    s = chip_smoke.offset_stats(om, 2, 2, 1)
    assert s["mean_abs_dy"] == 0.5 and s["mean_abs_dx"] == 0.0
    assert s["between_pct"] == 100.0 and s["near_grid_pct"] == 0.0
    assert s["off_map_pct"] == pytest.approx(100 * (1 - 5 / 6 * 2 / 3))
    assert s["mean_mask"] == pytest.approx(1 / (1 + math.exp(-2.0)))


# -------------------------------------------------------------- predictor
def test_the_predictor_class_follows_the_network():
    m = DBNet(dtype=torch.float32, stages=((1, 8), (1, 16), (1, 16), (1, 16)), stem_width=8,
              inner=32).eval()
    db = CTPNPredictor(params_to_jax(m.state_dict()), model=m, device="cpu")
    assert type(db) is DBPredictor
    assert (db.stages, db.pad_span, db.span_prefix, db.graphs.variant()) == (
        timer.DB_STAGES, "db.pad", "db", ("DB",))
    assert len(timer.DB_STAGES) == 1 + 26 + 11
    assert timer.DB_STAGES[:3] == ("start", "dcn01_in", "dcn01_out")
    assert timer.DB_STAGES[-11:] == ("trunk", "neck.lateral", "neck.topdown", "neck.smooth",
                                     "neck.fuse", "neck", "head.conv", "head.map", "head",
                                     "label", "boxes")
    cfg_from_list(["NET_NAME", "DB_RESNET50_DCN"])
    assert CTPNPredictor.__new__(CTPNPredictor).__class__ is DBPredictor
    with pytest.raises(ValueError):
        db.detect_image_host(np.zeros((96, 160, 3), np.uint8))


def test_stage_clock_and_spans_cover_db_on_the_cpu():
    _db_cfg()
    m = DBNet(dtype=torch.float32).eval()
    timer.enable(True)
    try:
        pred = CTPNPredictor(params_to_jax(m.state_dict()), model=m, device="cpu")
        preps = [pred.prep(im) for im in _images()]
        ims, infos = [p[0] for p in preps], [p[1] for p in preps]
        pred.run_padded(ims, infos, 2)
        recs, n = pred.fetch(pred.run_batch(np.stack(ims), np.stack(infos))[1])
        pred.unscale(recs, n, 1.0, infos[0])
        spans = timer.totals()
        read = pred.clock.read()
    finally:
        timer.enable(False)
        timer.reset()
    assert {"db.pad", "db.run", "db.fetch", "db.unscale"} <= set(spans)
    assert set(read) >= set(timer.DB_STAGES[1:]) and read["rows"] == 2


NECK = ("neck.lateral", "neck.topdown", "neck.smooth", "neck.fuse")
HEAD = ("head.conv", "head.map")


def _narrow(dtype=torch.float32):
    """The published depth (13 deformable sites, each stamped) at narrow
    widths."""
    torch.manual_seed(0)
    return DBNet(dtype=dtype, stages=((3, 8), (4, 8), (6, 8), (3, 8)), stem_width=8,
                 inner=32).eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_traced_program_stamps_the_decoders_children_and_answers_the_same(dtype):
    """A traced predictor stamps the six children of ``neck`` and ``head``
    and every stage it stamped before, and answers bit for bit as the
    untraced one: the marks add no work to the program."""
    _db_cfg(dtype)
    m = _narrow(getattr(torch, dtype))
    params = params_to_jax(m.state_dict())
    untraced = CTPNPredictor(params, model=m, device="cpu")
    preps = [untraced.prep(im) for im in _images()]
    x, info = np.stack([p[0] for p in preps]), np.stack([p[1] for p in preps])
    want = untraced.run_batch(x, info)
    timer.enable(True)
    try:
        traced = CTPNPredictor(params, model=m, device="cpu")
        got = traced.run_batch(x, info)
        read = traced.clock.read()
        row = traced.clock.ring[:len(timer.DB_STAGES)]
    finally:
        timer.enable(False)
        timer.reset()
    assert m.sites == timer.DB_SITES
    assert untraced.clock is None and read["rows"] == 1
    # every slot of the run's row stamped, in order
    assert bool((row > 0).all()) and bool((row[1:] >= row[:-1]).all())
    assert set(read) == set(timer.DB_STAGES[1:]) | {"rows"}
    assert set(NECK + HEAD) < set(read)
    # each parent spans its children
    assert sum(read[s] for s in NECK) <= read["neck"]
    assert sum(read[s] for s in HEAD) <= read["head"]
    for a, b in zip(want, got):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and torch.equal(u, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_neck_in_its_stages_is_the_one_expression(dtype):
    """``neck`` computes the four smoothing convs before the upsamples and
    the concat: the same ops on the same inputs as the one ``cat``
    expression that interleaved them, bit for bit; ``head`` with its marks
    is ``head`` without."""
    from ctpn_tpu_torch.models.dbnet import up

    m = _narrow(getattr(torch, dtype))
    x = torch.randn(2, 96, 160, 3, generator=torch.Generator().manual_seed(3))
    marks = []
    with torch.inference_mode():
        feats = m.trunk(x)
        d = m.decoder
        in2, in3, in4, in5 = (getattr(d, f"in{k}")(f) for k, f in zip((2, 3, 4, 5), feats))
        out4 = up(in5, in4) + in4
        out3 = up(out4, in3) + in3
        out2 = up(out3, in2) + in2
        p2 = d.out2(out2)
        want = torch.cat([up(d.out5(in5), p2), up(d.out4(out4), p2), up(d.out3(out3), p2), p2],
                         1)
        fuse = m.neck(feats, marks.append)
        prob = m.head(fuse, marks.append)
        assert torch.equal(prob, m.head(want))
    assert fuse.dtype == want.dtype and torch.equal(fuse, want)
    assert tuple(marks) == NECK + HEAD


def test_east_and_craft_spans_come_from_their_prefix():
    from ctpn_tpu_torch.inference.pipeline import CRAFTPredictor, EASTPredictor

    assert (EASTPredictor.span_prefix, CRAFTPredictor.span_prefix) == ("east", "craft")
    assert CTPNPredictor.span_prefix is None
    for cls in (EASTPredictor, CRAFTPredictor, DBPredictor):
        assert "run_batch" not in vars(cls) and "fetch" not in vars(cls)
        assert "unscale" not in vars(cls)


def test_db_resize_rule():
    buckets = [[736, 1312], [1312, 736], [736, 736]]
    assert db_resize_size(720, 1280, 736, buckets) == ((736, 1312), (736, 1312))
    assert db_resize_size(1280, 720, 736, buckets) == ((1312, 736), (1312, 736))
    assert db_resize_size(500, 500, 736, buckets) == ((736, 736), (736, 736))
    # too long for any bucket: the short side shrinks by 32 until it fits
    (h, w), b = db_resize_size(400, 1600, 736, buckets)
    assert b == (736, 1312) and w <= 1312 and h % 32 == 0 and h < 736
    for hw in ((720, 1280), (1280, 720), (500, 500), (400, 1600), (96, 144)):
        assert plain.resize_size(*hw, 736, buckets) == db_resize_size(*hw, 736, buckets)


def test_prep_resizes_by_db_rule_and_records_stay_in_original_pixels():
    _db_cfg()
    m = DBNet(dtype=torch.float32).eval()
    pred = CTPNPredictor(params_to_jax(m.state_dict()), model=m, device="cpu")
    im = _images(1)[0]  # 96x144: short side 96 -> 96x160
    data, info = pred.prep(im)
    assert data.shape == (96, 160, 3) and info.tolist() == [96, 160, 96, 144]
    want, want_info = plain.prep(im, CONFIG)
    assert np.array_equal(data, want) and np.array_equal(info, want_info)
    out = pred.detect_image(im)
    _, recs = pred.run_batch(data[None], info[None])
    n = int(recs.count[0])
    assert out.shape == (n, 9) and np.array_equal(out, recs.recs[0, :n].numpy())


@pytest.mark.skipif(not ARTIFACT.exists(), reason="the trained weights are not in the tree")
def test_shipped_artifact_finds_boxes_at_the_tiny_bucket():
    cfg_from_list(["NET_NAME", "DB_RESNET50_DCN", "TPU.COMPUTE_DTYPE", "float32",
                   "TPU.BUCKETS", [[320, 480]], "TEXT.DB_SHORT_SIDE", 320,
                   "CHANNEL_ORDER", "BGR", "PIXEL_MEANS", list(T.PIXEL_MEANS),
                   "PIXEL_STDS", [T.PIXEL_STD] * 3])
    pred = CTPNPredictor(load_params(str(ARTIFACT), device="cpu"), device="cpu")
    assert isinstance(pred, DBPredictor)
    from ctpn_tpu_torch.data.synth import render_image

    rng = np.random.RandomState(11)
    found = 0
    for _ in range(2):
        img, _ = render_image(rng, width=450, height=300)
        out = pred.detect_image(np.ascontiguousarray(img[..., ::-1]))
        assert out.shape[1:] == (9,)
        assert (out[:, 0:8:2] <= 450).all() and (out[:, 1:8:2] <= 300).all()
        found += len(out)
    assert found > 0


@pytest.mark.parametrize("path", ["ctpn_tpu_torch/plain/db.py", "benchmark/reference/db.py"])
def test_plain_reference_imports_nothing_of_the_package(path):
    tree = ast.parse((REPO / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "contextlib", "math", "typing", "numpy", "torch", "PIL"}, names


def test_benchmark_reference_is_the_plain_reference():
    assert (REPO / "benchmark" / "reference" / "db.py").read_bytes() == (
        REPO / "ctpn_tpu_torch" / "plain" / "db.py").read_bytes()


# --------------------------------------------------------------- training
def test_shrink_moves_each_edge_in_by_the_papers_distance():
    q = np.array([[0, 0], [100, 0], [100, 20], [0, 20]], np.float64)
    d = 100 * 20 * (1 - 0.4 ** 2) / 240
    np.testing.assert_allclose(T.shrink(q), [[d, d], [100 - d, d], [100 - d, 20 - d],
                                             [d, 20 - d]])
    assert T.shrink(np.array([[0, 0], [4, 0], [4, 0.001], [0, 0.001]])) is not None
    assert T.shrink(np.zeros((4, 2))) is None


def test_targets_leave_small_words_out_of_the_loss():
    words = np.array([[10, 10, 60, 10, 60, 30, 10, 30], [70, 5, 90, 5, 90, 10, 70, 10]],
                     np.float64)
    gt, mask = T.db_targets(words, 40, 100)
    assert gt[20, 35] == 1 and gt[11, 11] == 0  # inside the shrunk box; its rim
    assert mask[7, 80] == 0 and mask[20, 35] == 1  # the 5 px word is don't-care
    assert gt[:, 65:].sum() == 0


def test_dice_loss_is_zero_on_the_targets_and_one_off_them():
    gt = torch.zeros(1, 8, 8)
    gt[0, 2:5, 2:6] = 1
    mask = torch.ones_like(gt)
    assert float(T.dice_loss(torch.where(gt > 0, 30.0, -30.0), gt, mask)) == pytest.approx(
        0.0, abs=1e-6)
    assert float(T.dice_loss(torch.where(gt > 0, -30.0, 30.0), gt, mask)) == pytest.approx(
        1.0, abs=1e-6)
    mask[0, 2:5, 2:6] = 0  # don't-care: no target left, nothing to match
    assert float(T.dice_loss(torch.full_like(gt, -30.0), gt, mask)) == pytest.approx(1.0)


def test_loss_is_finite_and_falls_over_a_few_cpu_steps():
    torch.manual_seed(0)
    m = T.train_model(stages=((1, 8), (1, 16), (1, 16), (1, 16)), stem=8, inner=32)
    opt = torch.optim.Adam(m.parameters(), lr=3e-3)
    words = np.array([[8, 20, 56, 20, 56, 36, 8, 36]], np.float64)
    gt, mask = T.db_targets(words, 64, 64)
    x = np.full((2, 64, 64, 3), 200, np.uint8)
    x[:, 20:36, 8:56] = 30
    xt = torch.from_numpy(x)
    gt_t = torch.from_numpy(np.stack([gt, gt]))
    mask_t = torch.from_numpy(np.stack([mask, mask]))
    losses = []
    for _ in range(8):
        loss = T.db_loss(m.logits(T.normalised(xt)), gt_t, mask_t)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]


def test_the_zero_offset_form_is_the_deformable_conv_at_its_init():
    """Training starts the deformable convs as a plain conv at half gain:
    at MhLiao's init (offset convs zero: no offset, every mask 0.5) that is
    the deformable conv itself, so the switch changes nothing."""
    torch.manual_seed(5)
    m = T.train_model(stages=((1, 8), (1, 16), (1, 16), (1, 16)), stem=8, inner=32).eval()
    x = T.normalised(torch.randint(0, 255, (1, 64, 96, 3), dtype=torch.uint8))
    with torch.no_grad():
        sampled = m(x)
        T.set_sampling(m, False)
        plain_form = m(x)
    assert not T.sampling_on(m)
    assert (sampled - plain_form).abs().max() < 1e-5


def test_shipped_weights_agree_with_the_reference_and_not_in_bfloat16():
    """The trained weights on two renders at a 320 short side: the float32
    program's maps within 1e-5 of the reference's (float32 sums in another
    order: 2.4e-6 measured) and its boxes the same; the bfloat16 program's
    maps miss by far more."""
    _db_cfg()
    cfg_from_list(["TPU.BUCKETS", [[320, 480]], "TEXT.DB_SHORT_SIDE", 320])
    from ctpn_tpu_torch.data.synth import render_image

    rng = np.random.RandomState(11)
    ims = [np.ascontiguousarray(render_image(rng, width=450, height=300)[0][..., ::-1])
           for _ in range(2)]
    config = dict(CONFIG, TEXT=dict(TEXT, DB_SHORT_SIDE=320), buckets=[[320, 480]])
    preps = [plain.prep(im, config) for im in ims]
    x, info = np.stack([p[0] for p in preps]), np.stack([p[1] for p in preps])
    params = load_params(str(ARTIFACT), device="cpu")
    text, recs = CTPNPredictor(params, device="cpu").run_batch(x, info)
    res = plain.ReferenceDB(config, str(ARTIFACT)).detect(x, info)
    total = 0
    for i, r in enumerate(res):
        got = text.maps[i, :r["maps"].shape[0], :r["maps"].shape[1]].numpy()
        assert np.abs(got - r["maps"]).max() < 1e-5
        n = int(recs.count[i])
        assert np.array_equal(recs.recs[i, :n, :8].numpy(), r["recs"][:, :8])
        np.testing.assert_allclose(recs.recs[i, :n, 8].numpy(), r["recs"][:, 8], atol=1e-6)
        total += n
    assert total > 0
    cfg_from_list(["TPU.COMPUTE_DTYPE", "bfloat16"])
    low, _ = CTPNPredictor(params, device="cpu").run_batch(x, info)
    assert np.abs(low.maps[0, :320].numpy() - res[0]["maps"][:320]).max() > 1e-3
