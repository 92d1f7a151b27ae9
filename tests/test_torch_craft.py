"""CRAFT (VGG16-BN, region and affinity maps) in the port, held against
its plain reference ``ctpn_tpu_torch/plain/craft.py`` on the CPU.

The reference is CRAFT's specification written out in plain PyTorch and
NumPy (float32 network with its batch norms unfolded; clovaai's
``getDetBoxes_core`` with its own labelling, dilation, hull and
calipers); the JAX package has no CRAFT. The kernels' plain versions
(``ops/ccl.py``, ``ops/craft_boxes.py``) are what the card's kernels are
held to bit for bit by ``chip_smoke.py --craft``; here they are held to
the reference, and to OpenCV where ``cv2`` imports.
"""

import ast
import hashlib
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ctpn_tpu_torch.config import cfg, cfg_from_list, reset_cfg
from ctpn_tpu_torch.inference.pipeline import CRAFTPredictor, CTPNPredictor, craft_normalised
from ctpn_tpu_torch.models.craft import CRAFT, TAPS
from ctpn_tpu_torch.models.east import EAST
from ctpn_tpu_torch.models.vgg import Conv1x1, Conv3x3, VGG16Trunk
from ctpn_tpu_torch.ops.ccl import ccl_label, ccl_label_ref
from ctpn_tpu_torch.ops.craft_boxes import craft_boxes, craft_boxes_ref
from ctpn_tpu_torch.plain import craft as plain
from ctpn_tpu_torch.utils.image import craft_resize_factor
from ctpn_tpu_torch.utils.weights import (_flatten, craft_params_from_clovaai, load_params,
                                          params_to_jax)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "data" / "artifacts" / "craft_vgg16bn_synth_f16.npz"
LADDER = ((1, 2, 8), (2, 2, 8), (3, 3, 16), (4, 3, 16), (5, 2, 16))
NARROW = dict(trunk_stages=LADDER, fc_width=16, up_widths=((16, 16), (16, 8), (8, 8), (8, 8)),
              cls_widths=(8, 8, 8, 8))
BUCKET = (96, 160)
THRESH = dict(TEXT_THRESHOLD=0.7, LOW_TEXT=0.4, LINK_THRESHOLD=0.4)


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def _images(n=2, seed=7) -> np.ndarray:
    from ctpn_tpu_torch.data.synth import render_image

    rng = np.random.RandomState(seed)
    return np.stack([render_image(rng, width=BUCKET[1], height=BUCKET[0])[0][..., ::-1]
                     for _ in range(n)]).astype(np.uint8)


def _infos(n=2):
    return np.array([[BUCKET[0], BUCKET[1], 1.0], [90, 150, 1.0]][:n], np.float32)


def _narrow(dtype=torch.float32, seed=0) -> CRAFT:
    """A narrow CRAFT on seeded random weights whose last conv is set so
    that about 20 % of the region map and 10 % of the affinity map is over
    0.4 on the test renders: components of a few to a few hundred pixels."""
    torch.manual_seed(seed)
    m = CRAFT(dtype=dtype, **NARROW).eval()
    x = torch.from_numpy(_images()).float() - torch.tensor(cfg.PIXEL_MEANS)
    with torch.no_grad():
        out = m(x)
        m.cls_out.weight[0] /= out[..., 0].std()
        m.cls_out.weight[1] /= out[..., 1].std()
        out = m(x)
        m.cls_out.bias[0] += 0.4 - float(torch.quantile(out[..., 0].flatten(), 0.8))
        m.cls_out.bias[1] += 0.4 - float(torch.quantile(out[..., 1].flatten(), 0.9))
    return m


def _config() -> dict:
    return {"pixel_means": list(cfg.PIXEL_MEANS), "TEXT": dict(THRESH)}


def _reference(model) -> plain.ReferenceCRAFT:
    flat = {k: v for k, v in _flatten(params_to_jax(model.state_dict()))}
    return plain.ReferenceCRAFT(_config(), flat, device="cpu")


# ---------------------------------------------------------------- trunk
def _old_trunk(trunk: VGG16Trunk, x: torch.Tensor, pool_last: bool) -> list:
    """The trunk as CTPN and EAST ran it: F.conv2d with no dilation given,
    the ReLU and the pools, taps after pools 2 onward."""
    taps = []
    for block, reps, _ in trunk.stages:
        for rep in range(1, reps + 1):
            conv = getattr(trunk, f"conv{block}_{rep}")
            x = F.relu(F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), padding=1))
        if block < 5 or pool_last:
            x = F.max_pool2d(x, 2, 2)
        if block >= 2:
            taps.append(x)
    return taps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool_last", [False, True])
def test_ctpn_and_east_trunks_are_unchanged_with_and_without_taps(dtype, pool_last):
    torch.manual_seed(1)
    stages = ((1, 1, 8), (2, 1, 16), (3, 1, 16), (4, 1, 32), (5, 1, 32))
    trunk = VGG16Trunk(stages, pool_last=pool_last).eval()
    x = torch.randn(2, 3, 64, 96).to(dtype)
    with torch.no_grad():
        want = _old_trunk(trunk, x, pool_last)
        got, taps = trunk(x), trunk(x, taps=True)
    assert torch.equal(got, want[-1])
    assert all(torch.equal(a, b) for a, b in zip(taps, want))


def test_dilated_and_plain_convs_pass_their_dilation():
    torch.manual_seed(2)
    x = torch.randn(2, 8, 20, 24)
    c = Conv3x3(8, 16, dilation=6).eval()
    with torch.no_grad():
        want = F.conv2d(x, c.weight, c.bias, padding=6, dilation=6)
        assert torch.equal(c(x), want)
        assert c(x).shape == x.shape[:1] + (16,) + x.shape[2:]
        c1 = Conv1x1(8, 16, per_image=True)
        assert torch.equal(c1(x), torch.cat([F.conv2d(x[i:i + 1], c1.weight, c1.bias)
                                             for i in range(2)]))


def test_taps_are_where_clovaai_takes_them():
    m = _narrow()
    x = torch.zeros(1, 96, 160, 3)
    taps = m.trunk_taps(x)
    assert [tuple(t.shape[1:]) for t in taps] == [(8, 48, 80), (16, 24, 40), (16, 12, 20),
                                                 (16, 6, 10)]
    assert not hasattr(m.trunk, "conv5_3")
    # conv5_2 is read before its ReLU: negative values stay
    torch.manual_seed(3)
    x = torch.randn(1, 96, 160, 3) * 50
    with torch.no_grad():
        taps = m.trunk_taps(x)
    assert taps[3].min() < 0 and taps[0].min() >= 0 and taps[2].min() >= 0
    assert m(x).shape == (1, 48, 80, 2)


def _walked_taps(trunk: VGG16Trunk, x: torch.Tensor) -> list:
    """CRAFT's taps walked conv by conv: conv2_2 read after its ReLU and
    then pooled, conv3_2 and conv4_2 after their ReLU, conv5_2 with its
    bias alone."""
    taps = []
    for block, reps, _ in trunk.stages:
        for rep in range(1, reps + 1):
            name = f"conv{block}_{rep}"
            conv = getattr(trunk, name)
            if block == 5 and rep == reps:
                taps.append(conv(x))
                continue
            pool = rep == reps and block < 5
            x = conv.conv_relu(x, pool=pool and name != "conv2_2")
            if name in ("conv2_2", "conv3_2", "conv4_2"):
                taps.append(x)
            if pool and name == "conv2_2":
                x = F.max_pool2d(x, 2, 2)
    return taps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("remat", [False, True])
def test_craft_taps_are_the_trunks_one_walk(dtype, remat):
    m = _narrow(dtype=dtype)
    torch.manual_seed(4)
    x = torch.randn(2, 96, 160, 3) * 40
    with torch.no_grad():
        want = _walked_taps(m.trunk, x.to(dtype).permute(0, 3, 1, 2).contiguous())
        got = m.trunk_taps(x)
    with torch.enable_grad():
        xt = x.to(dtype).permute(0, 3, 1, 2).contiguous()
        walked = m.trunk(xt, remat=remat, taps=TAPS, last_relu=False)
    assert len(got) == len(want) == len(walked) == 4
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # with gradients on, the separate passes: the same values
    assert all(torch.allclose(a.detach().float(), b.float(), atol=1e-2)
               for a, b in zip(walked, want))
    walked[3].float().sum().backward()
    assert m.trunk.conv5_2.weight.grad is not None


def test_per_image_tail_runs_block_5_alone_per_image():
    torch.manual_seed(5)
    m = CRAFT(dtype=torch.float32, per_image_tail=True, **NARROW).eval()
    flags = {n for n, mod in m.named_modules() if getattr(mod, "per_image", False)}
    assert flags == {"trunk.conv5_1", "trunk.conv5_2"}
    batched = CRAFT(dtype=torch.float32, **NARROW).eval()
    batched.load_state_dict(m.state_dict())
    x = torch.randn(3, 96, 160, 3) * 40
    with torch.no_grad():
        torch.testing.assert_close(m(x), batched(x), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- against plain
def test_maps_agree_with_the_reference_in_float32_and_not_in_bfloat16():
    m = _narrow()
    ref = _reference(m)
    x = _images()
    want = ref.maps(x)
    xs = torch.from_numpy(x).float() - torch.tensor(cfg.PIXEL_MEANS)
    with torch.no_grad():
        f32 = m(xs)
        m16 = _narrow(torch.bfloat16)
        b16 = m16(xs)
    share = np.mean([(w[..., 0] > 0.4).mean() for w in want])
    assert 0.1 <= share <= 0.3
    # float32 on both sides: only the summation order of the convs differs
    # (about 1e-5 on maps of unit spread); bf16 rounds every conv's inputs
    # (2**-8 relative) and moves the maps by about 1e-2
    tol = 1e-4
    for i, w in enumerate(want):
        np.testing.assert_allclose(f32[i].numpy(), w, atol=tol, rtol=0)
    worst = max(float(np.abs(b16[i].float().numpy() - w).max()) for i, w in enumerate(want))
    assert worst > 10 * tol


def _pair_within(a: np.ndarray, b: np.ndarray, px: float) -> None:
    assert a.shape == b.shape, (a.shape, b.shape)
    used = set()
    for row in a:
        d = np.abs(b[:, :8] - row[:8]).max(1)
        j = int(np.argmin(np.where(np.isin(np.arange(len(b)), list(used)), np.inf, d)))
        assert d[j] <= px, d[j]
        used.add(j)


def test_program_boxes_pair_with_the_reference_within_half_a_pixel():
    m = _narrow()
    ref = _reference(m)
    x, info = _images(), _infos()
    pred = CTPNPredictor(params_to_jax(m.state_dict()), model=m, device="cpu")
    assert isinstance(pred, CRAFTPredictor)
    text, recs = pred.run_batch(x, info)
    for i, want in enumerate(ref.detect(x, info)):
        assert (int(text.on[i]), int(text.labelled[i]), int(text.count[i])) == (
            want["on"], want["labelled"], want["kept"])
        got = recs.recs[i, :int(recs.count[i])].numpy()
        assert len(got) >= 3
        _pair_within(got, want["recs"], 0.5)
        np.testing.assert_allclose(np.sort(got[:, 8]), np.sort(want["recs"][:, 8]), atol=1e-4)
    assert int(text.overflow.sum()) == 0 and int(recs.overflow.sum()) == 0
    # the bucket's padding is not read: the second image's boxes stay
    # inside its extent
    assert recs.recs[1, :int(recs.count[1]), 0:8:2].max() <= 150
    assert recs.recs[1, :int(recs.count[1]), 1:8:2].max() <= 90


def _clovaai_state(m: CRAFT, seed: int) -> dict:
    """``m``'s convs in clovaai's layout with seeded batch norms (random
    weight, bias, running mean and variance)."""
    gen = torch.Generator().manual_seed(seed)
    sd = m.state_dict()
    out = {}
    from ctpn_tpu_torch.utils.weights import CRAFT_CLOVAAI

    for name, conv, bn in CRAFT_CLOVAAI:
        key = f"trunk.{name}" if name.startswith("conv") else name
        w, b = sd[f"{key}.weight"], sd[f"{key}.bias"]
        if name == "cls_out":
            w = w[:, :, None, None]
        out[f"module.{conv}.weight"], out[f"module.{conv}.bias"] = w.clone(), b.clone()
        if bn is not None:
            c = w.shape[0]
            out[f"module.{bn}.weight"] = 0.5 + torch.rand(c, generator=gen)
            out[f"module.{bn}.bias"] = 0.2 * torch.randn(c, generator=gen)
            out[f"module.{bn}.running_mean"] = 0.3 * torch.randn(c, generator=gen)
            out[f"module.{bn}.running_var"] = 0.5 + torch.rand(c, generator=gen)
            out[f"module.{bn}.num_batches_tracked"] = torch.tensor(7)
    return out


def test_batch_norms_fold_into_the_convs_at_load():
    m = _narrow()
    state = _clovaai_state(m, seed=5)
    params = craft_params_from_clovaai(state)
    folded = CRAFT(dtype=torch.float32, **NARROW).eval()
    pred = CTPNPredictor(params, model=folded, device="cpu")
    assert isinstance(pred, CRAFTPredictor)
    ref = plain.ReferenceCRAFT(_config(), state, device="cpu")  # batch norms as they are
    assert ref.w["conv2_2"]["bn"] is not None and ref.w["fc6"]["bn"] is None
    x = _images()
    want = ref.maps(x)
    with torch.no_grad():
        got = folded(torch.from_numpy(x).float() - torch.tensor(cfg.PIXEL_MEANS))
    for i, w in enumerate(want):
        np.testing.assert_allclose(got[i].numpy(), w, atol=2e-4 * max(1.0, np.abs(w).max()))
    # a batch norm that is not the identity moved the maps
    plain_maps = _reference(m).maps(x)
    assert max(np.abs(p - w).max() for p, w in zip(plain_maps, want)) > 1e-2


def test_clovaai_normalisation_is_configuration():
    cfg_from_list(["CHANNEL_ORDER", "RGB", "PIXEL_MEANS", [123.675, 116.28, 103.53],
                   "PIXEL_STDS", [58.395, 57.12, 57.375]])
    bgr = torch.tensor([[[[10.0, 20.0, 30.0]]]])
    got = craft_normalised(bgr)[0, 0, 0].tolist()
    want = [(30 - 123.675) / 58.395, (20 - 116.28) / 57.12, (10 - 103.53) / 57.375]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    conf = dict(_config(), channel_order="RGB", pixel_means=[123.675, 116.28, 103.53],
                pixel_stds=[58.395, 57.12, 57.375])
    m = _narrow()
    flat = {k: v for k, v in _flatten(params_to_jax(m.state_dict()))}
    ref = plain.ReferenceCRAFT(conf, flat, device="cpu")
    x = _images(1)
    with torch.no_grad():
        mine = m(craft_normalised(torch.from_numpy(x)))
    np.testing.assert_allclose(mine[0].numpy(), ref.maps(x)[0], atol=1e-4)


# ------------------------------------------------------- made-up maps
def _maps(h, w, text=(), link=(), value=0.9, link_value=0.6) -> np.ndarray:
    """(h, w, 2) maps: region ``value`` on the ``text`` pixels (lists of
    (y, x) or slices), affinity ``link_value`` on the ``link`` pixels."""
    m = np.zeros((h, w, 2), np.float32)
    m[..., 0] = -0.1
    for t in text:
        m[t + (0,)] = value
    for t in link:
        m[t + (1,)] = link_value
    return m


def _spiral(n: int) -> np.ndarray:
    m = np.zeros((n, n), bool)
    y0, x0, y1, x1 = 0, 0, n - 1, n - 1
    while y0 <= y1 and x0 <= x1:
        m[y0, x0:x1 + 1] = True
        m[y0:y1 + 1, x1] = True
        m[y1, x0:x1 + 1] = True
        if y0 + 2 <= y1:
            m[y0 + 2:y1 + 1, x0] = True
        y0, x0, y1, x1 = y0 + 2, x0 + 2, y1 - 2, x1 - 2
        if x0 - 2 < x1:
            m[y0, x0 - 2:x0 + 1] = m[y0, x0 - 2:x0 + 1] | (y0 <= y1)
    return m


def _case(name: str):
    """(maps (h, w, 2), extent (eh, ew)) of a named made-up case."""
    h, w = 40, 64
    if name == "empty":
        return _maps(h, w), (h, w)
    if name == "one_pixel":
        return _maps(h, w, text=[(5, 7)]), (h, w)
    if name == "nine_and_ten":
        return _maps(h, w, text=[(slice(2, 5), slice(2, 5)),  # 9 pixels
                                 (slice(10, 12), slice(10, 15))]), (h, w)  # 10
    if name == "thresholds_exact":
        m = _maps(h, w, text=[(slice(2, 6), slice(2, 8)), (slice(20, 24), slice(30, 40))])
        m[2:6, 2:8, 0] = 0.7  # kept: the largest score reaches 0.7
        m[20:24, 30:40, 0] = 0.69999  # dropped
        m[20:24, 30, 0] = 0.4  # not on: 0.4 is not over 0.4
        m[2, 2, 0] = np.float32(0.4)
        return m, (h, w)
    if name == "u_shapes":
        m = _maps(h, w)
        for x0 in (2, 20, 40):
            m[5:30, x0:x0 + 3, 0] = 0.9
            m[5:30, x0 + 12:x0 + 15, 0] = 0.9
            m[27:30, x0:x0 + 15, 0] = 0.9
        m[2:4, :, 0] = 0.8  # a long bar above them, touching none
        return m, (h, w)
    if name == "spiral":
        s = _spiral(36)
        m = _maps(h, w)
        m[2:38, 10:46, 0] = np.where(s, 0.9, -0.1)
        return m, (h, w)
    if name == "links_split_and_shrink":  # one component: two words joined by a
        # link, and a link tail that the box leaves out
        m = _maps(h, w, text=[(slice(5, 12), slice(3, 20)), (slice(5, 12), slice(30, 50))],
                  link=[(slice(7, 10), slice(20, 30)), (slice(12, 20), slice(40, 45))])
        return m, (h, w)
    if name == "edges":  # windows clipped at every edge of the extent
        m = _maps(h, w, text=[(slice(0, 4), slice(0, 12)), (slice(32, 36), slice(40, 52)),
                              (slice(15, 25), slice(0, 3)), (slice(5, 9), slice(45, 52))])
        return m, (36, 52)
    if name == "diamond":  # square-ish blobs: the axis-aligned box
        m = _maps(h, w, text=[(slice(5, 17), slice(5, 17)), (slice(20, 32), slice(30, 43))])
        return m, (h, w)
    if name == "rotated":
        m = _maps(h, w)
        yy, xx = np.mgrid[0:h, 0:w]
        for cx, cy, a, L, T in ((20, 12, 0.4, 30, 5), (45, 28, -0.7, 26, 6), (15, 32, 1.2, 12, 3)):
            u = (xx - cx) * math.cos(a) + (yy - cy) * math.sin(a)
            v = -(xx - cx) * math.sin(a) + (yy - cy) * math.cos(a)
            m[..., 0] = np.where((np.abs(u) <= L / 2) & (np.abs(v) <= T / 2), 0.85, m[..., 0])
        return m, (h, w)
    raise KeyError(name)


CASES = ["empty", "one_pixel", "nine_and_ten", "thresholds_exact", "u_shapes", "spiral",
         "links_split_and_shrink", "edges", "diamond", "rotated"]


def _run(maps: np.ndarray, ext, cap=64):
    t = torch.from_numpy(maps[None].copy())
    e = torch.tensor([ext], dtype=torch.int32)
    lab, st, sc, cnt, over, on, nl = ccl_label(t, e, 0.4, 0.4, 0.7, 10, cap)
    recs = craft_boxes(t, lab, st, sc, cnt, e, 0.4, 2.0)
    return lab[0].numpy(), st[0], sc[0], int(cnt[0]), int(over[0]), int(on[0]), int(nl[0]), recs[0]


@pytest.mark.parametrize("name", CASES)
def test_plain_kernels_give_the_reference_boxes_on_made_up_maps(name):
    maps, (eh, ew) = _case(name)
    lab, st, sc, cnt, over, on, nl, recs = _run(maps, (eh, ew))
    m = maps[:eh, :ew]
    boxes, counts = plain.det_boxes(m[..., 0], m[..., 1], 0.7, 0.4, 0.4)
    assert (on, nl, cnt, over) == (counts["on"], counts["labelled"], counts["kept"], 0)
    want = np.array([np.concatenate([b.reshape(8) * np.float32(2), [s]]) for b, s in boxes],
                    np.float32).reshape(-1, 9)
    assert np.array_equal(recs[:cnt].numpy(), want)
    assert not recs[cnt:].any() and not st[cnt:].any()
    # labels: the least raster index of each component, -1 off
    ref_lab = plain.label_components(
        (m[..., 0] > np.float32(0.4)) | (m[..., 1] > np.float32(0.4)))
    for k in range(1, ref_lab.max() + 1):
        ys, xs = np.nonzero(ref_lab == k)
        assert set(lab[:eh, :ew][ref_lab == k].tolist()) == {int(ys[0] * maps.shape[1] + xs[0])}
    assert (lab[:eh, :ew][ref_lab == 0] == -1).all() and (lab[eh:] == -1).all()
    assert (lab[:, ew:] == -1).all()
    expect = {"empty": 0, "one_pixel": 0, "nine_and_ten": 1, "thresholds_exact": 1,
              "u_shapes": 4, "spiral": 1, "links_split_and_shrink": 1, "edges": 4,
              "diamond": 2, "rotated": 3}[name]
    assert cnt == expect


def test_the_least_niter_is_two_and_even_squares_shift_right():
    # area >= max(w, h) for a connected component, so niter =
    # int(sqrt(area * min / (w * h)) * 2) >= 2: a 10x1 bar dilates by 3
    maps, ext = _maps(20, 30, text=[(slice(5, 6), slice(5, 15))]), (20, 30)
    *_, cnt, _, _, _, recs = _run(maps, ext)
    assert cnt == 1
    np.testing.assert_array_equal(recs[0, :8].numpy() / 2, [4, 4, 15, 4, 15, 6, 4, 6])
    # niter 3 (k 4, anchor 2): one pixel more to the right and below
    maps = _maps(30, 40, text=[(slice(5, 8), slice(5, 17)), (slice(8, 9), slice(5, 6))])
    st = _run(maps, (30, 40))[1]
    area, w, h = (int(v) for v in st[0, [1, 4, 5]])
    assert int(math.sqrt(area * min(w, h) / (w * h)) * 2) == 3


def test_the_cap_keeps_the_first_components_and_counts_the_rest():
    text = [(slice(2 + 4 * (i // 8), 4 + 4 * (i // 8)), slice(2 + 7 * (i % 8), 7 + 7 * (i % 8)))
            for i in range(30)]
    maps = _maps(40, 64, text=text)
    full = _run(maps, (40, 64))
    capped = _run(maps, (40, 64), cap=7)
    assert (full[3], full[4]) == (30, 0) and (capped[3], capped[4]) == (7, 23)
    assert torch.equal(capped[1], full[1][:7]) and torch.equal(capped[7], full[7][:7])


def test_the_plain_labelling_is_the_kernels_on_random_maps(rng):
    maps = rng.uniform(-0.2, 1.0, (3, 40, 60, 2)).astype(np.float32)
    maps[..., 0] = np.where(rng.rand(3, 40, 60) < 0.35, maps[..., 0] + 0.5, -0.1)
    t = torch.from_numpy(maps)
    e = torch.tensor([[40, 60], [31, 47], [40, 1]], dtype=torch.int32)
    a = ccl_label(t, e, 0.4, 0.4, 0.7, 3, 64)
    b = ccl_label_ref(t, e, 0.4, 0.4, 0.7, 3, 64)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    r1 = craft_boxes(t, a[0], a[1], a[2], a[3], e, 0.4, 2.0)
    r2 = craft_boxes_ref(t, a[0], a[1], a[2], a[3], e, 0.4, 2.0)
    assert torch.equal(r1, r2) and int(a[3].sum()) > 10


# --------------------------------------------------------- against cv2
def _clovaai_boxes(textmap, linkmap, text_threshold=0.7, link_threshold=0.4, low_text=0.4):
    """clovaai's ``getDetBoxes_core``, its code with OpenCV."""
    cv2 = pytest.importorskip("cv2")
    img_h, img_w = textmap.shape
    _, text_score = cv2.threshold(textmap, low_text, 1, 0)
    _, link_score = cv2.threshold(linkmap, link_threshold, 1, 0)
    comb = np.clip(text_score + link_score, 0, 1)
    n, labels, stats, _ = cv2.connectedComponentsWithStats(comb.astype(np.uint8), connectivity=4)
    det, kept_stats = [], []
    for k in range(1, n):
        size = stats[k, cv2.CC_STAT_AREA]
        if size < 10 or np.max(textmap[labels == k]) < text_threshold:
            continue
        segmap = np.zeros(textmap.shape, dtype=np.uint8)
        segmap[labels == k] = 255
        segmap[np.logical_and(link_score == 1, text_score == 0)] = 0
        x, y = stats[k, cv2.CC_STAT_LEFT], stats[k, cv2.CC_STAT_TOP]
        w, h = stats[k, cv2.CC_STAT_WIDTH], stats[k, cv2.CC_STAT_HEIGHT]
        niter = int(math.sqrt(size * min(w, h) / (w * h)) * 2)
        sx, ex, sy, ey = x - niter, x + w + niter + 1, y - niter, y + h + niter + 1
        sx, sy, ex, ey = max(sx, 0), max(sy, 0), min(ex, img_w), min(ey, img_h)
        kernel = cv2.getStructuringElement(cv2.MORPH_RECT, (1 + niter, 1 + niter))
        segmap[sy:ey, sx:ex] = cv2.dilate(segmap[sy:ey, sx:ex], kernel)
        pts = np.roll(np.array(np.where(segmap != 0)), 1, axis=0).transpose().reshape(-1, 2)
        box = cv2.boxPoints(cv2.minAreaRect(pts))
        bw, bh = np.linalg.norm(box[0] - box[1]), np.linalg.norm(box[1] - box[2])
        if abs(1 - max(bw, bh) / (min(bw, bh) + 1e-5)) <= 0.1:
            l, r = min(pts[:, 0]), max(pts[:, 0])
            t, b = min(pts[:, 1]), max(pts[:, 1])
            box = np.array([[l, t], [r, t], [r, b], [l, b]], dtype=np.float32)
        box = np.roll(box, 4 - box.sum(axis=1).argmin(), 0)
        det.append(box)
        kept_stats.append([stats[k, 4], x, y, w, h])
    return det, n - 1, kept_stats


def _same_box(got: np.ndarray, want: np.ndarray, atol: float) -> None:
    """The same corners in the same clockwise order, to ``atol``; where
    corners tie for the least x + y (a rectangle at 45 degrees), OpenCV's
    ``boxPoints`` order decides which comes first, so any of them may."""
    sums = want.sum(1)
    ties = np.flatnonzero(sums - sums.min() <= atol)
    assert min(np.abs(got - np.roll(want, -int(k), 0)).max() for k in ties) <= atol, (got, want)


@pytest.mark.parametrize("name", [c for c in CASES if c not in ("edges",)])
def test_plain_kernels_agree_with_opencv_on_made_up_maps(name):
    maps, ext = _case(name)
    lab, st, sc, cnt, over, on, nl, recs = _run(maps, ext)
    det, labelled, stats = _clovaai_boxes(maps[..., 0].copy(), maps[..., 1].copy())
    assert (nl, cnt) == (labelled, len(det))
    assert st[:cnt, 1:].tolist() == stats
    for got, want in zip(recs[:cnt, :8].numpy().reshape(-1, 4, 2) / 2, det):
        # OpenCV's rectangle rounds in float: the same corners to 1e-3 px
        _same_box(got, want, 2e-3)


def test_plain_kernels_agree_with_opencv_on_the_programs_maps():
    m = _narrow()
    pred = CTPNPredictor(params_to_jax(m.state_dict()), model=m, device="cpu")
    text, recs = pred.run_batch(_images(), _infos())
    for i in range(2):
        eh, ew = plain.extent(_infos()[i])
        mp = text.maps[i, :eh, :ew].numpy()
        det, labelled, stats = _clovaai_boxes(mp[..., 0].copy(), mp[..., 1].copy())
        cnt = int(text.count[i])
        assert (int(text.labelled[i]), cnt) == (labelled, len(det))
        for got, want in zip(recs.recs[i, :cnt, :8].numpy().reshape(-1, 4, 2) / 2, det):
            _same_box(got, want, 2e-3)


# ---------------------------------------------------------- surfaces
def test_the_predictor_class_follows_the_network():
    from ctpn_tpu_torch.utils import timer

    m = _narrow()
    craft = CTPNPredictor(params_to_jax(m.state_dict()), model=m, device="cpu")
    assert type(craft) is CRAFTPredictor
    assert (craft.stages, craft.pad_span, craft.graphs.variant()) == (
        timer.CRAFT_STAGES, "craft.pad", ("CRAFT",))
    assert timer.CRAFT_STAGES == ("start", "trunk", "decoder", "label", "boxes")
    cfg_from_list(["NET_NAME", "CRAFT_VGG16_BN"])
    assert CTPNPredictor.__new__(CTPNPredictor).__class__ is CRAFTPredictor
    assert isinstance(EAST, type)  # EAST's dispatch is its own (test_torch_east.py)
    with pytest.raises(ValueError):
        craft.detect_image_host(np.zeros((96, 160, 3), np.uint8))


def test_stage_clock_stamps_craft_stages_on_the_cpu():
    from ctpn_tpu_torch.utils import timer

    m = _narrow()
    timer.enable(True)
    try:
        pred = CTPNPredictor(params_to_jax(m.state_dict()), model=m, device="cpu")
        pred.run_padded(list(_images()), list(_infos()), 2)
        pred.fetch(pred.run_batch(_images(), _infos())[1])
        spans = timer.totals()
        read = pred.clock.read()
    finally:
        timer.enable(False)
        timer.reset()
    assert {"craft.pad", "craft.run", "craft.fetch"} <= set(spans)
    assert set(read) >= {"trunk", "decoder", "label", "boxes"} and read["rows"] == 2


def test_craft_resize_rule():
    buckets = [[736, 1280], [1280, 736], [736, 736]]
    assert craft_resize_factor(720, 1280, 1.5, 1280, buckets) == (1.0, (736, 1280))
    f, b = craft_resize_factor(300, 400, 1.5, 1280, buckets)
    assert (f, b) == (1.5, (736, 736))
    f, b = craft_resize_factor(1000, 1000, 1.5, 1280, buckets)
    assert b == (1280, 736) and f == pytest.approx(0.736)
    for h, w in ((720, 1280), (300, 400), (1000, 1000), (96, 144)):
        assert plain.resize_factor(h, w, 1.5, 1280, buckets) == craft_resize_factor(
            h, w, 1.5, 1280, buckets)


def test_detect_image_unscales_by_the_resize_factor():
    m = _narrow()
    cfg_from_list(["TPU.BUCKETS", [[96, 160]], "TEXT.CANVAS_SIZE", 160])
    pred = CTPNPredictor(params_to_jax(m.state_dict()), model=m, device="cpu")
    small = np.ascontiguousarray(_images(1)[0][::2, ::2])  # 48x80: factor 1.5 -> 72x120
    data, info, f = pred.prep(small)
    assert f == 1.5 and data.shape == (96, 160, 3) and info.tolist() == [72, 120, 1.0]
    out = pred.detect_image(small)
    _, recs = pred.run_batch(data[None], info[None])
    n = int(recs.count[0])
    assert out.shape == (n, 9)
    np.testing.assert_allclose(out[:, :8], recs.recs[0, :n, :8].numpy() / 1.5, rtol=1e-6)


def test_shipped_artifact_finds_boxes_at_the_tiny_bucket():
    # 900x600 renders at a third of their size: the smallest text the
    # weights were trained on (crops scaled 0.8-2.0) is then a few pixels
    cfg_from_list(["NET_NAME", "CRAFT_VGG16_BN", "TPU.COMPUTE_DTYPE", "float32",
                   "TPU.BUCKETS", [[192, 320]], "TEXT.CANVAS_SIZE", 320])
    pred = CTPNPredictor(load_params(str(ARTIFACT), device="cpu"), device="cpu")
    assert isinstance(pred, CRAFTPredictor)
    from PIL import Image

    from ctpn_tpu_torch.data.synth import render_image

    rng = np.random.RandomState(11)
    found = 0
    for _ in range(3):
        img, _ = render_image(rng, width=900, height=600)
        small = np.asarray(Image.fromarray(img).resize((288, 192), Image.BILINEAR))
        out = pred.detect_image(np.ascontiguousarray(small[..., ::-1]))
        assert out.shape[1:] == (9,)
        found += len(out)
    assert found > 0


@pytest.mark.parametrize("path", ["ctpn_tpu_torch/plain/craft.py", "benchmark/reference/craft.py"])
def test_plain_reference_imports_nothing_of_the_package(path):
    tree = ast.parse((REPO / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "contextlib", "hashlib", "math", "os", "typing",
                     "numpy", "torch", "PIL"}, names


def test_benchmark_reference_is_the_plain_reference():
    assert (REPO / "benchmark" / "reference" / "craft.py").read_bytes() == (
        REPO / "ctpn_tpu_torch" / "plain" / "craft.py").read_bytes()


def test_renderer_output_is_unchanged():
    """The renderer's output for a seed, pinned: CRAFT's targets split the
    word boxes it already gives, and draw nothing more from it."""
    from ctpn_tpu_torch.data.synth import render_image

    img, polys = render_image(np.random.RandomState(2024), width=320, height=200)
    digest = hashlib.sha256(img.tobytes() + np.asarray(polys, np.float64).tobytes()).hexdigest()
    assert digest == RENDER_DIGEST


RENDER_DIGEST = "9561e961d80a77016abebdbacd2bb6857c5a2e4046a361319d172611eb70268a"


# ---------------------------------------------------------- training
def test_renderer_gives_each_word_its_characters():
    from ctpn_tpu_torch.cli.train_craft_synth import _render_chars
    from ctpn_tpu_torch.data.synth import render_image

    img, words, chars, word_of = _render_chars(2024)
    again, polys = render_image(np.random.RandomState(2024), width=900, height=600)
    assert np.array_equal(img, again) and np.array_equal(words, np.reshape(polys, (-1, 8)))
    assert len(chars) == len(word_of) >= len(words) and set(word_of) == set(range(len(words)))
    for k, word in enumerate(words):  # every character inside its word's box
        q, c = word.reshape(4, 2), chars[word_of == k].reshape(-1, 4, 2)
        assert (c.min((0, 1)) >= q.min(0) - 2).all() and (c.max((0, 1)) <= q.max(0) + 2).all()


def test_affinity_boxes_join_neighbouring_characters():
    from ctpn_tpu_torch.cli.train_craft_synth import affinity_boxes

    chars = np.array([[[10 + 12 * i, 20], [22 + 12 * i, 20], [22 + 12 * i, 40], [10 + 12 * i, 40]]
                      for i in range(5)], np.float64)
    aff = affinity_boxes(chars)
    assert aff.shape == (4, 4, 2)
    # from the centre of one character to the next's, two thirds as high
    np.testing.assert_allclose(aff[0], [[16, 20 + 10 / 3], [28, 20 + 10 / 3],
                                        [28, 40 - 10 / 3], [16, 40 - 10 / 3]])


def test_targets_peak_inside_each_character():
    from ctpn_tpu_torch.cli.train_craft_synth import craft_targets

    chars = np.array([[8 + 10 * i, 8, 16 + 10 * i, 8, 16 + 10 * i, 24, 8 + 10 * i, 24]
                      for i in range(5)], np.float64)  # five characters of one word
    region, affinity = craft_targets(chars, np.zeros(5, np.int64), 32, 64)
    assert region.shape == affinity.shape == (16, 32)
    # 4 x 8 map pixels a character: the pixel centres nearest the peak read 0.86
    assert region.max() > 0.8 and affinity.max() > 0.8
    row = region[8]
    peaks = [x for x in range(1, 31) if row[x] >= row[x - 1] and row[x] > row[x + 1]
             and row[x] > 0.5]
    assert len(peaks) == 5
    assert region[:2].max() == 0 and affinity[:, :6].max() == 0
    # two words of one character each: no affinity
    _, none = craft_targets(chars[:2], np.array([0, 1]), 32, 64)
    assert none.max() == 0


def test_loss_is_finite_and_falls_over_a_few_cpu_steps():
    from ctpn_tpu_torch.cli.train_craft_synth import craft_targets, ohem_loss

    torch.manual_seed(3)
    m = CRAFT(dtype=torch.float32, **NARROW)
    x = torch.from_numpy(_images(2)[:, :64, :64].copy()).float() - torch.tensor(cfg.PIXEL_MEANS)
    chars = np.array([[8 + 12 * i, 16, 18 + 12 * i, 16, 18 + 12 * i, 40, 8 + 12 * i, 40]
                      for i in range(4)], np.float64)
    r, a = (torch.from_numpy(np.stack([t] * 2)) for t in craft_targets(chars, np.zeros(4, int),
                                                                        64, 64))
    params = [p for n, p in m.named_parameters() if not n.startswith("trunk.")]
    opt = torch.optim.Adam(params, lr=1e-2)
    losses = []
    for _ in range(8):
        with torch.no_grad():
            taps = m.trunk_taps(x)
        maps = m.head(m.decoder(taps))
        loss = ohem_loss(maps[..., 0], r) + ohem_loss(maps[..., 1], a)
        assert torch.isfinite(loss)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0]
