"""O-mode connector, detector and ``TextDetector``: the port against
``ctpn_tpu.postprocess``.

Against the vectorized JAX connector: counts and valid flags exact,
records within 1e-3 px plus 1e-5 relative (the chain fits are f32 matmul
sums in another order; see tests/test_torch_connector.py). Against the
numpy oracle, which fits with ``np.polyfit`` in f64 and walks graphs, the
tolerance is the one the JAX package holds its own connector to
(tests/test_connector.py::TestLines): equal counts, records sorted by
corner, ``rtol=1e-3, atol=0.3``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpn_tpu.config import cfg as jcfg
from ctpn_tpu.postprocess import connector as JC
from ctpn_tpu.postprocess import oracle as O
from ctpn_tpu.postprocess.detector import TextDetector as JaxTextDetector
from ctpn_tpu.postprocess.detector import detect_lines as jax_detect_lines
from ctpn_tpu_torch.config import cfg as tcfg
from ctpn_tpu_torch.config import reset_cfg
from ctpn_tpu_torch.postprocess import connector as TC
from ctpn_tpu_torch.postprocess.detector import TextDetector, detect_lines

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def strip_scene(rng, n_lines=5, im_h=600, im_w=900, slope=0.0, score_lo=0.75):
    """CTPN-like proposals: rows of 16-px strips, shuffled (the scenes of
    tests/test_connector.py::make_strip_scene). With the default scores a
    line's mean is near 0.875 and most lines fall to the 0.9 line-score
    filter; ``score_lo=0.92`` keeps them."""
    boxes, scores = [], []
    for _ in range(n_lines):
        y = rng.uniform(40, im_h - 80)
        h = rng.uniform(20, 40)
        x_start = rng.uniform(0, 150)
        for s in range(rng.randint(3, 20)):
            x1 = x_start + s * 16
            if x1 + 15 >= im_w:
                break
            yy = y + slope * (x1 - x_start) + rng.uniform(-1.5, 1.5)
            boxes.append([x1, yy, x1 + 15, yy + h * rng.uniform(0.95, 1.05)])
            scores.append(rng.uniform(score_lo, 1.0))
    perm = rng.permutation(len(boxes))
    return (np.array(boxes, np.float32)[perm],
            np.array(scores, np.float32)[perm])


def _pad(boxes, scores, n_pad):
    b = np.zeros((n_pad, 4), np.float32)
    s = np.full((n_pad,), -1.0, np.float32)
    b[:len(boxes)], s[:len(boxes)] = boxes, scores
    return b, s, np.arange(n_pad) < len(boxes)


def _batch(seeds, n_pad=160, slope=0.0):
    scenes = [strip_scene(np.random.RandomState(s), slope=slope) for s in seeds]
    return [np.stack(x) for x in zip(*(_pad(b, s, n_pad) for b, s in scenes))]


def _rois(rng, slope, score_lo=0.75):
    """Two images of score-sorted rois with near-duplicates and low scores."""
    rois = []
    for _ in range(2):
        b, s = strip_scene(rng, slope=slope, score_lo=score_lo)
        dup = b[: len(b) // 3] + rng.uniform(-2, 2, (len(b) // 3, 4)).astype(np.float32)
        b = np.concatenate([b, dup])
        s = np.concatenate([s, rng.uniform(0.5, 1.0, len(dup)).astype(np.float32)])
        order = np.argsort(s, kind="stable")[::-1]
        r = np.zeros((200, 5), np.float32)
        r[:, 0] = -1.0
        r[: len(b), 0], r[: len(b), 1:] = s[order], b[order]
        rois.append(r)
    rois = np.stack(rois)
    return rois, rois[..., 0] > -1


# -0.08: the k < 0 branch of the slope compensation
@pytest.mark.parametrize("slope", [0.0, 0.08, -0.08])
def test_connect_text_lines_o_matches_jax(slope):
    b, s, v = _batch([6, 7, 8], slope=slope)
    info = np.tile(np.array([600, 900, 1.0], np.float32), (3, 1))
    got = TC.connect_text_lines(
        torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(v),
        torch.from_numpy(info), mode="O", max_lines=32, max_chain_len=57,
    )
    want = jax.vmap(
        lambda bb, ss, vv, ii: JC.connect_text_lines(
            bb, ss, vv, ii, mode="O", max_lines=32, max_chain_len=57)
    )(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v), jnp.asarray(info))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    assert got.count.sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.recs.numpy(), np.asarray(want.recs), atol=1e-3, rtol=1e-5)


def test_o_records_are_not_clipped():
    """Only H clips to the image: an O line running past the right edge
    keeps its corners there, as in the JAX package."""
    x = np.arange(0, 10) * 16.0 + 800.0
    boxes = np.stack([x, np.full(10, 100.0), x + 15, np.full(10, 130.0)], 1)
    b, s, v = _pad(boxes.astype(np.float32), np.full(10, 0.95, np.float32), 16)
    info = np.array([[600, 900, 1.0]], np.float32)
    args = [torch.from_numpy(a[None]) for a in (b, s, v)] + [torch.from_numpy(info)]
    out = {m: TC.connect_text_lines(*args, mode=m, max_lines=4) for m in ("H", "O")}
    assert int(out["O"].count[0]) == int(out["H"].count[0]) == 1
    assert float(out["O"].recs[0, 0, 2:8:4].max()) > 899.0
    assert float(out["H"].recs[0, 0, 2:8:4].max()) == 899.0


@pytest.mark.parametrize("slope", [0.0, 0.08, -0.08])
def test_detect_lines_o_matches_jax(slope):
    rois, valid = _rois(np.random.RandomState(9), slope)
    info = np.tile(np.array([600, 900, 1.0], np.float32), (2, 1))
    got = detect_lines(torch.from_numpy(rois), torch.from_numpy(valid),
                       torch.from_numpy(info), mode="O", max_lines=32)
    want = jax.vmap(lambda r, v, i: jax_detect_lines(r, v, i, mode="O", max_lines=32))(
        jnp.asarray(rois), jnp.asarray(valid), jnp.asarray(info))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    assert got.count.sum() > 0
    np.testing.assert_allclose(got.recs.numpy(), np.asarray(want.recs), atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("slope", [0.15, -0.2])
@pytest.mark.parametrize("seed", [0, 5])
def test_o_lines_match_oracle(slope, seed):
    """The scenes of tests/test_connector.py::TestLines (4 lines, 128
    slots), with scores that keep the lines, against
    ``get_text_lines_o_np`` and its line filter."""
    boxes, scores = strip_scene(np.random.RandomState(seed), n_lines=4, slope=slope,
                                score_lo=0.92)
    im_size = np.array([600, 900, 1.0], np.float32)
    want = O.get_text_lines_o_np(boxes.astype(np.float64), scores, im_size)
    want = want[O.filter_lines_np(want)]
    b, s, v = _pad(boxes, scores, 128)
    out = TC.connect_text_lines(
        torch.from_numpy(b[None]), torch.from_numpy(s[None]),
        torch.from_numpy(v[None]), torch.from_numpy(im_size[None]),
        mode="O", max_lines=32,
    )
    count = int(out.count[0])
    got = out.recs[0, :count].numpy()
    assert count == len(want) > 0
    go = got[np.lexsort((got[:, 1], got[:, 0]))]
    wo = want[np.lexsort((want[:, 1], want[:, 0]))]
    np.testing.assert_allclose(go, wo, rtol=1e-3, atol=0.3)


@pytest.mark.parametrize("mode", ["H", "O"])
def test_text_detector_matches_jax(mode):
    """The cfg-driven facade: one image's rois in, trimmed records out."""
    rois, valid = _rois(np.random.RandomState(13), 0.08, score_lo=0.92)
    info = np.array([600, 900, 1.0], np.float32)
    tcfg.TPU.MAX_LINES = jcfg.TPU.MAX_LINES  # same slot count in both
    got = TextDetector(mode=mode)
    want = JaxTextDetector(mode=mode)
    assert got.mode == want.mode == mode
    for i in range(2):
        g = got.detect(rois[i], valid[i], info)
        w = want.detect(rois[i], valid[i], info)
        assert g.shape == w.shape and len(g) > 0
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=1e-5)
