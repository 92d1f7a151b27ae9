"""EAST-VGG16 (RBOX) in the port, held against its plain reference
``ctpn_tpu_torch/plain/east.py`` on the CPU.

The reference is EAST's specification written out in plain PyTorch and
NumPy (float32 network, raster walk, greedy NMS); the JAX package has no
EAST. The kernels' plain versions (``ops/lanms.py``, ``ops/quad_nms.py``)
are what the card's kernels are held to bit for bit by ``chip_smoke.py``
phase 25; here they are held to the reference.
"""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from ctpn_tpu_torch.config import cfg, cfg_from_list, reset_cfg
from ctpn_tpu_torch.inference.pipeline import CTPNPredictor, EASTPredictor
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.models.east import EAST
from ctpn_tpu_torch.models.vgg import VGG16Trunk
from ctpn_tpu_torch.ops.lanms import lanms_walk, lanms_walk_ref
from ctpn_tpu_torch.ops.nms_bitmask import num_words
from ctpn_tpu_torch.ops.nms_resolve import nms_resolve
from ctpn_tpu_torch.ops.quad_nms import quad_bitmask, quad_bitmask_ref, quad_iou
from ctpn_tpu_torch.plain import east as plain
from ctpn_tpu_torch.training.east_loss import east_loss, min_area_rect, rbox_targets
from ctpn_tpu_torch.utils.weights import _flatten, load_params, params_to_jax

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "data" / "artifacts" / "east_vgg16_synth_f16.npz"
LADDER = ((1, 1, 8), (2, 1, 16), (3, 1, 16), (4, 1, 32), (5, 1, 32))
WIDTHS, OUT = (16, 16, 8), 8
BUCKET = (96, 144)


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def _narrow(dtype=torch.float32, seed=0) -> EAST:
    """A narrow EAST on seeded random weights whose heads give words of a
    few tens of pixels: the distances' bias puts them near 12 px, the
    angle's near 0, and the score's bias is set so that 5-30 % of the
    cells pass 0.8."""
    torch.manual_seed(seed)
    m = EAST(dtype=dtype, trunk_stages=LADDER, widths=WIDTHS, out_width=OUT).eval()
    with torch.no_grad():
        m.heads.weight[1:].mul_(0.05)
        m.heads.bias[1:5] = math.log(12 / (512 - 12))
        m.heads.bias[5] = 0.0
        m.heads.bias[0] = 0.0
        x = _images()
        logits = torch.logit(m(torch.from_numpy(x).float() - torch.tensor(cfg.PIXEL_MEANS)).score)
        m.heads.bias[0] = math.log(0.8 / 0.2) - float(torch.quantile(logits.flatten(), 0.85))
    return m


def _images(n=2, seed=7) -> np.ndarray:
    from ctpn_tpu_torch.data.synth import render_image

    rng = np.random.RandomState(seed)
    return np.stack([render_image(rng, width=BUCKET[1], height=BUCKET[0])[0][..., ::-1]
                     for _ in range(n)]).astype(np.uint8)


def _config(model) -> dict:
    return {"model": {"vgg_stages": [list(s) for s in LADDER], "merge_widths": list(WIDTHS),
                      "out_width": OUT, "text_scale": model.text_scale},
            "pixel_means": list(cfg.PIXEL_MEANS),
            "TEXT": {"SCORE_MAP_THRESH": cfg.TEXT.SCORE_MAP_THRESH,
                     "NMS_THRESH": cfg.TEXT.NMS_THRESH}}


def _reference(model) -> plain.ReferenceEAST:
    flat = {k: v for k, v in _flatten(params_to_jax(model.state_dict()))}
    return plain.ReferenceEAST(_config(model), flat, device="cpu")


def _infos(n=2):
    return np.array([[BUCKET[0], BUCKET[1], 1.0], [88, 130, 1.0]][:n], np.float32)


# ---------------------------------------------------------------- trunk
def _old_trunk(trunk: VGG16Trunk, x: torch.Tensor) -> torch.Tensor:
    """The trunk as CTPN ran it before the taps: pools after blocks 1-4."""
    for block, reps, _ in trunk.stages:
        for rep in range(1, reps + 1):
            x = getattr(trunk, f"conv{block}_{rep}").conv_relu(x, pool=rep == reps and block < 5)
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ctpn_trunk_is_unchanged_with_and_without_taps(dtype):
    torch.manual_seed(1)
    net = CTPN(dtype=dtype, trunk_stages=LADDER, lstm_hidden=8, rpn_channels=16).eval()
    x = torch.randn(2, 3, 64, 96).to(dtype)
    with torch.no_grad():
        want = _old_trunk(net.trunk, x)
        got = net.trunk(x)
        taps = net.trunk(x, taps=True)
    assert torch.equal(got, want)
    assert torch.equal(taps[-1], want)
    assert [t.shape[-1] for t in taps] == [24, 12, 6, 6]  # no pool after block 5


def test_pool_last_taps_are_pool2_to_pool5():
    m = _narrow()
    taps = m.trunk_taps(torch.zeros(1, 96, 144, 3))
    assert [tuple(t.shape[1:]) for t in taps] == [(16, 24, 36), (16, 12, 18), (32, 6, 9),
                                                 (32, 3, 4)]


# ------------------------------------------------------- against plain
def test_maps_agree_with_the_reference_in_float32_and_not_in_bfloat16():
    m = _narrow()
    ref = _reference(m)
    x = _images()
    want = ref.maps(x)
    with torch.no_grad():
        xs = torch.from_numpy(x).float() - torch.tensor(cfg.PIXEL_MEANS)
        f32 = m(xs)
        m16 = _narrow(torch.bfloat16)
        b16 = m16(xs)
    share = np.mean([(s > 0.8).mean() for s, _, _ in want])
    assert 0.05 <= share <= 0.30
    # float32 on both sides: only the summation order of the convs and the
    # heads differs (about 1e-6); bf16 rounds every conv's inputs (2**-8
    # relative) and moves the scores by about 1e-2 and the distances by
    # pixels, past these tolerances
    tol = {"score": 1e-4, "geo": 2e-3, "angle": 1e-4}
    for i, (s, g, a) in enumerate(want):
        for name, mine, theirs in (("score", f32.score[i], s), ("geo", f32.geo[i], g),
                                   ("angle", f32.angle[i], a)):
            np.testing.assert_allclose(mine.numpy(), theirs, atol=tol[name], rtol=0)
    worst = max(float(np.abs(b16.score[i].float().numpy() - s).max()) for i, (s, _, _)
                in enumerate(want))
    assert worst > tol["score"]
    worst_geo = max(float(np.abs(b16.geo[i].float().numpy() - g).max()) for i, (_, g, _)
                    in enumerate(want))
    assert worst_geo > tol["geo"]


def _pair_within(a: np.ndarray, b: np.ndarray, px: float) -> None:
    assert a.shape == b.shape, (a.shape, b.shape)
    used = set()
    for row in a:
        d = np.abs(b[:, :8] - row[:8]).max(1)
        j = int(np.argmin(np.where(np.isin(np.arange(len(b)), list(used)), np.inf, d)))
        assert d[j] <= px, d[j]
        used.add(j)


def test_program_quads_pair_with_the_reference_within_half_a_pixel():
    m = _narrow()
    ref = _reference(m)
    x, info = _images(), _infos()
    pred = CTPNPredictor(params_to_jax(m.state_dict()), model=m, device="cpu")
    assert isinstance(pred, EASTPredictor)
    quads, recs = pred.run_batch(x, info)
    for i, want in enumerate(ref.detect(x, info)):
        assert int(quads.cells[i]) == want["cells"]
        got_m = quads.rois[i, :int(quads.count[i])].numpy()
        got_r = recs.recs[i, :int(recs.count[i])].numpy()
        assert len(got_r) >= 1
        _pair_within(got_m[:, 1:], want["merged"][:, 1:], 0.5)
        _pair_within(got_r, want["recs"], 0.5)
        np.testing.assert_allclose(np.sort(got_r[:, 8]), np.sort(want["recs"][:, 8]), atol=1e-3)
    assert int(quads.overflow.sum()) == 0 and int(recs.overflow.sum()) == 0


# ------------------------------------------------------ kernels' plain
def _rects(rng, n, words, jitter=1.5):
    cx, cy = rng.uniform(0, 200, words), rng.uniform(0, 120, words)
    w, h = rng.uniform(10, 60, words), rng.uniform(6, 20, words)
    a = rng.uniform(-0.6, 0.6, words)
    geo = np.stack([h / 2, w / 2, h / 2, w / 2], 1).astype(np.float32)
    base = plain.restore_rbox(cx.astype(np.float32), cy.astype(np.float32), geo,
                              a.astype(np.float32))
    q = base[np.repeat(rng.randint(0, words, (n + 5) // 6), 6)[:n]]
    q = q + rng.normal(0, jitter, q.shape).astype(np.float32)
    s = rng.uniform(0.8, 1.0, n).astype(np.float32)
    return np.concatenate([s[:, None], q], 1).astype(np.float32)


def _cells(rng, counts, tie=False):
    m = max(max(counts), 1)
    cells = np.zeros((len(counts), m, 9), np.float32)
    for i, n in enumerate(counts):
        c = _rects(rng, n, max(n // 10, 1))
        if tie and n:
            c[:] = c[0]
        cells[i, :n] = c
    return cells


@pytest.mark.parametrize("case", ["runs", "ties", "empty", "one", "long"])
def test_walk_plain_version_is_the_reference_walk(rng, case):
    counts = {"runs": [120, 75, 3], "ties": [40, 40], "empty": [0, 50, 0],
              "one": [1, 2], "long": [300, 33, 64]}[case]
    cells = _cells(rng, counts, tie=case == "ties")
    merged, ncells, count, over = lanms_walk(torch.from_numpy(cells),
                                            torch.tensor(counts, dtype=torch.int32), 0.2, 4096)
    want = plain.lanms_walk([cells[i, :n] for i, n in enumerate(counts)], 0.2)
    for i, (wm, wn, tests) in enumerate(want):
        assert int(count[i]) == len(wm) and int(over[i]) == 0
        assert tests == max(counts[i] - 1, 0)
        # the same folds; the reference re-averages after each fold, the
        # kernel's walk keeps sums in steps of 32, so the means differ only
        # by float32 rounding (vertices up to 260 px: ulps of 3e-5 px)
        np.testing.assert_array_equal(ncells[i, :len(wm)].numpy(), wn)
        np.testing.assert_allclose(merged[i, :len(wm), 1:].numpy(), wm[:, 1:], atol=2e-3)
        np.testing.assert_allclose(merged[i, :len(wm), 0].numpy(), wm[:, 0], rtol=1e-5)
        assert not merged[i, len(wm):].any() and not ncells[i, len(wm):].any()
    if case == "ties":
        assert count.tolist() == [1, 1] and ncells[:, 0].tolist() == [40, 40]


def test_walk_counts_the_quads_past_its_cap(rng):
    counts = [200, 30]
    cells = torch.from_numpy(_cells(rng, counts))
    count_t = torch.tensor(counts, dtype=torch.int32)
    full = lanms_walk_ref(cells, count_t, 0.2, 4096)
    capped = lanms_walk_ref(cells, count_t, 0.2, 5)
    assert int(full[2][0]) > 5
    assert capped[2].tolist() == [5, min(int(full[2][1]), 5)]
    assert capped[3].tolist() == [int(full[2][0]) - 5, max(int(full[2][1]) - 5, 0)]
    assert torch.equal(capped[0], full[0][:, :5])


def test_quad_iou_plain_versions_agree_bit_for_bit_and_on_known_values(rng):
    a = _rects(rng, 3000, 300, jitter=4.0)[:, 1:]
    b = np.roll(a, 1, 0)
    assert np.array_equal(quad_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                          plain.quad_iou(a, b))
    sq = np.array([0, 0, 10, 0, 10, 10, 0, 10], np.float32)
    half = sq + np.array([5, 0] * 4, np.float32)
    diamond = np.array([5, -5, 15, 5, 5, 15, -5, 5], np.float32)  # holds sq, twice its area
    far = sq + 100
    got = quad_iou(torch.from_numpy(np.stack([sq, sq, sq, sq])),
                   torch.from_numpy(np.stack([sq, half, far, diamond]))).numpy()
    np.testing.assert_allclose(got, [1.0, 1 / 3, 0.0, 0.5], rtol=1e-6)
    ccw = sq.reshape(4, 2)[::-1].reshape(8).copy()  # the clip's other orientation
    assert float(quad_iou(torch.from_numpy(half), torch.from_numpy(ccw))) == pytest.approx(1 / 3)


@pytest.mark.parametrize("k,valid_n", [(31, 31), (33, 20), (70, 64)])
def test_bitmask_is_in_the_resolve_contract_and_gives_the_reference_nms(rng, k, valid_n):
    b = 3
    quads = torch.from_numpy(_rects(rng, b * k, max(k // 4, 1), jitter=3.0)[:, 1:]).reshape(b, k, 8)
    n = torch.tensor([valid_n, valid_n // 2, 0])
    valid = torch.arange(k)[None] < n[:, None]
    mask = quad_bitmask(quads, valid, 0.2)
    assert mask.shape == (b, k, num_words(k)) and mask.dtype == torch.int32
    bits = ((mask.numpy()[..., None] >> np.arange(32)) & 1).astype(bool).reshape(b, k, -1)[..., :k]
    assert not np.tril(np.ones((k, k), bool))[None].__and__(bits).any()  # only j > i
    assert not bits[~valid.numpy()].any() and not bits.transpose(0, 2, 1)[~valid.numpy()].any()
    keep = nms_resolve(mask, valid)
    for i in range(b):
        want, tests = plain.greedy_nms(quads[i, :int(n[i])].numpy(), 0.2)
        assert np.flatnonzero(keep[i].numpy()).tolist() == want.tolist()
    ident = quads[:, :1].expand(b, k, 8).contiguous()
    keep_i = nms_resolve(quad_bitmask_ref(ident, valid, 0.2), valid)
    assert keep_i.sum(1).tolist() == [1, 1, 0]


# ---------------------------------------------------------- surfaces
def test_shipped_artifact_finds_quads_at_the_tiny_bucket():
    cfg_from_list(["NET_NAME", "EAST_VGG16", "TPU.COMPUTE_DTYPE", "float32",
                   "TPU.BUCKETS", [list(BUCKET)], "TEXT.SCALE", 96, "TEXT.MAX_SCALE", 160,
                   "TEST.SCALES", [96], "TEST.MAX_SIZE", 160])
    pred = CTPNPredictor(load_params(str(ARTIFACT), device="cpu"), device="cpu")
    assert isinstance(pred, EASTPredictor)
    from PIL import Image

    from ctpn_tpu_torch.data.synth import render_image

    rng = np.random.RandomState(11)
    found = 0
    for _ in range(3):
        img, _ = render_image(rng, width=900, height=600)
        small = np.asarray(Image.fromarray(img).resize((144, 96), Image.BILINEAR))
        out = pred.detect_image(np.ascontiguousarray(small[..., ::-1]))
        assert out.shape[1:] == (9,)
        found += len(out)
    assert found > 0


def test_predictor_unscales_east_quads_without_the_line_union():
    m = _narrow()
    pred = CTPNPredictor(params_to_jax(m.state_dict()), model=m, device="cpu")
    recs = np.array([[10, 20, 30, 20, 30, 40, 10, 40, 0.9],
                     [12, 20, 32, 20, 32, 40, 12, 40, 0.8]], np.float32)
    out = pred.unscale(np.concatenate([recs, np.zeros((3, 9), np.float32)]), 2, 2.0,
                       np.array([96, 144, 0.5], np.float32))
    np.testing.assert_allclose(out[:, :8], recs[:, :8])  # factor 2 x 0.5
    np.testing.assert_allclose(out[:, 8], recs[:, 8], rtol=1e-6)
    with pytest.raises(ValueError):
        pred.detect_image_host(np.zeros((96, 144, 3), np.uint8))


def test_the_predictor_class_follows_the_network():
    """CTPN's predictor keeps CTPN's stages, graph key and span; EAST's,
    chosen by its model or by ``cfg.NET_NAME``, carries its own."""
    from ctpn_tpu_torch.utils import timer

    ctpn_net = CTPN(dtype=torch.float32, trunk_stages=LADDER, lstm_hidden=8, rpn_channels=16)
    ctpn = CTPNPredictor(params_to_jax(ctpn_net.state_dict()), model=ctpn_net, device="cpu")
    assert type(ctpn) is CTPNPredictor
    assert (ctpn.stages, ctpn.pad_span) == (timer.STAGES, "predict.pad")
    assert ctpn.graphs.variant() == (ctpn.mode, bool(cfg.TPU.NMS_FUSED))
    m = _narrow()
    east = CTPNPredictor(params_to_jax(m.state_dict()), model=m, device="cpu")
    assert type(east) is EASTPredictor
    assert (east.stages, east.pad_span, east.graphs.variant()) == (
        timer.EAST_STAGES, "east.pad", ("EAST",))
    cfg_from_list(["NET_NAME", "EAST_VGG16"])
    assert CTPNPredictor.__new__(CTPNPredictor).__class__ is EASTPredictor


def test_plain_reference_imports_nothing_of_the_package():
    tree = ast.parse((REPO / "ctpn_tpu_torch" / "plain" / "east.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "contextlib", "hashlib", "math", "os", "typing",
                     "numpy", "torch"}, names


# ---------------------------------------------------------- training
def _restored(geo, angle, y, x):
    q = plain.restore_rbox(np.float32([4 * x]), np.float32([4 * y]),
                           geo[None, y, x].astype(np.float32), angle[None, y, x].astype(np.float32))
    return q[0].reshape(4, 2)


def test_rbox_targets_are_exact_on_an_axis_aligned_box():
    quad = np.array([40, 20, 120, 20, 120, 60, 40, 60], np.float64)
    score, geo, angle, mask = rbox_targets([quad], [False], 128, 160)
    ys, xs = np.nonzero(score)
    # shrunk by 0.3 x 40 = 12 px on every side: x in [52, 108], y in [32, 48]
    assert (4 * xs).min() >= 52 and (4 * xs).max() <= 108
    assert (4 * ys).min() >= 32 and (4 * ys).max() <= 48
    assert len(ys) == 15 * 5 and np.all(angle[ys, xs] == 0)
    for y, x in zip(ys, xs):
        np.testing.assert_allclose(_restored(geo, angle, y, x), quad.reshape(4, 2), atol=1e-4)
    assert mask.min() == 1


def test_rbox_targets_are_exact_on_a_rotated_box_and_mask_dont_care():
    c, w, h, a = np.array([80.0, 64.0]), 90.0, 30.0, 0.3
    u, v = np.array([math.cos(a), math.sin(a)]), np.array([-math.sin(a), math.cos(a)])
    quad = np.stack([c - w / 2 * u - h / 2 * v, c + w / 2 * u - h / 2 * v,
                     c + w / 2 * u + h / 2 * v, c - w / 2 * u + h / 2 * v]).reshape(8)
    cc, ww, hh, aa = min_area_rect(quad)
    np.testing.assert_allclose([*cc, ww, hh, aa], [*c, w, h, a], atol=1e-9)
    small = np.array([5, 5, 9, 5, 9, 8, 5, 8], np.float64)
    score, geo, angle, mask = rbox_targets([quad, small], [False, False], 128, 160)
    ys, xs = np.nonzero(score)
    assert len(ys) > 10 and np.allclose(angle[ys, xs], a)
    for y, x in zip(ys, xs):
        np.testing.assert_allclose(_restored(geo, angle, y, x), quad.reshape(4, 2), atol=1e-3)
    assert mask[1:3, 1:3].min() == 0 and mask[ys, xs].min() == 1  # the small word: don't care


def test_loss_is_finite_and_falls_over_a_few_cpu_steps():
    torch.manual_seed(3)
    m = EAST(dtype=torch.float32, trunk_stages=LADDER, widths=WIDTHS, out_width=OUT)
    x = torch.from_numpy(_images(2)[:, :64, :64].copy()).float() - torch.tensor(cfg.PIXEL_MEANS)
    quads = [np.array([8, 16, 56, 16, 56, 40, 8, 40], np.float64)]
    tg = [torch.from_numpy(np.stack([t] * 2)) for t in rbox_targets(quads, [False], 64, 64)]
    params = [p for n, p in m.named_parameters() if not n.startswith("trunk.")]
    opt = torch.optim.Adam(params, lr=1e-2)
    losses = []
    for _ in range(8):
        with torch.no_grad():
            taps = m.trunk_taps(x)
        out = m.head(m.merge(taps))
        loss, _, _ = east_loss(out.score, out.geo, out.angle, *tg)
        assert torch.isfinite(loss)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0]
