"""Geometry ops and the proposal layer: the port against the JAX package.

Anchors and box arithmetic are exact. ``proposal_layer`` runs at the full
608x912 scale (a 38x57x10 head: 21660 anchors, top 12000, NMS 0.7, 1000
kept): ``valid``, ``count`` and the gather order (the score column, which
is gathered, not computed) are exact; the decoded boxes agree within 1e-5
relative (exp may differ by an ulp between XLA and PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpn_tpu.ops import anchors as JA
from ctpn_tpu.ops import boxes as JB
from ctpn_tpu.ops.proposal import proposal_layer as jax_proposal_layer
from ctpn_tpu_torch.config import reset_cfg
from ctpn_tpu_torch.ops import anchors as TA
from ctpn_tpu_torch.ops import boxes as TB
from ctpn_tpu_torch.ops.proposal import proposal_layer

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def test_anchor_ladder_exact():
    np.testing.assert_array_equal(TA.anchor_ladder(), JA.anchor_ladder())
    assert TA.anchor_ladder().dtype == JA.anchor_ladder().dtype


@pytest.mark.parametrize("shape", [(1, 1), (4, 6), (38, 57)])
def test_shifted_anchors_exact(shape):
    np.testing.assert_array_equal(
        TA.shifted_anchors(*shape), JA.shifted_anchors(*shape)
    )


def test_box_ops_exact(rng):
    anchors = JA.shifted_anchors(6, 9)
    deltas = rng.uniform(-0.5, 0.5, (len(anchors), 4)).astype(np.float32)
    raw = rng.uniform(-50, 200, (40, 4)).astype(np.float32)

    w_t, h_t = TB.box_sizes(torch.from_numpy(raw))
    w_j, h_j = JB.box_sizes(jnp.asarray(raw))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))

    clip_t = TB.clip_boxes(torch.from_numpy(raw), 96.0, 144.0)
    clip_j = JB.clip_boxes(jnp.asarray(raw), 96.0, 144.0)
    np.testing.assert_array_equal(clip_t.numpy(), np.asarray(clip_j))

    dec_t = TB.bbox_transform_inv(torch.from_numpy(anchors), torch.from_numpy(deltas))
    dec_j = JB.bbox_transform_inv(jnp.asarray(anchors), jnp.asarray(deltas))
    # x columns are exact; y columns go through exp (ulp-level)
    np.testing.assert_array_equal(dec_t.numpy()[:, 0::2], np.asarray(dec_j)[:, 0::2])
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), rtol=1e-6, atol=1e-4)


def _heads(rng, n, fh, fw, quantize):
    prob = rng.uniform(0, 1, (n, fh, fw, 10)).astype(np.float32)
    if quantize:  # coarse scores: many exact ties exercise the stable sort
        prob = (np.floor(prob * 64) / 64).astype(np.float32)
    pred = rng.uniform(-0.5, 0.5, (n, fh, fw, 40)).astype(np.float32)
    return prob, pred


@pytest.mark.parametrize("quantize", [False, True])
def test_proposal_layer_full_scale_matches_jax(rng, quantize):
    fh, fw = 38, 57
    prob, pred = _heads(rng, 2, fh, fw, quantize)
    # image 0 fills the bucket; image 1 is smaller (cell masks, clipping)
    info = np.array([[608, 912, 1.0], [560, 800, 1.25]], np.float32)
    kw = dict(pre_nms_top_n=12000, post_nms_top_n=1000, nms_thresh=0.7, min_size=8)

    got = proposal_layer(
        torch.from_numpy(prob), torch.from_numpy(pred), torch.from_numpy(info), **kw
    )
    want = jax.vmap(lambda c, b, i: jax_proposal_layer(c, b, i, **kw))(
        jnp.asarray(prob), jnp.asarray(pred), jnp.asarray(info)
    )
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert (got.count.numpy() == 1000).all()  # the cap is reached
    rois_t, rois_j = got.rois.numpy(), np.asarray(want.rois)
    np.testing.assert_array_equal(rois_t[..., 0], rois_j[..., 0])
    np.testing.assert_allclose(rois_t[..., 1:], rois_j[..., 1:], rtol=1e-5, atol=1e-5)


def test_proposal_layer_pads_short_candidate_sets(rng):
    """Fewer candidates than output slots: padding slots are score -1,
    valid False, zero boxes."""
    prob, pred = _heads(rng, 1, 3, 4, False)
    info = np.array([[48, 64, 1.0]], np.float32)
    got = proposal_layer(
        torch.from_numpy(prob), torch.from_numpy(pred), torch.from_numpy(info),
        pre_nms_top_n=100, post_nms_top_n=200,
    )
    c = int(got.count[0])
    assert 0 < c < 120
    assert got.valid[0, :c].all() and not got.valid[0, c:].any()
    assert (got.rois[0, c:, 0] == -1).all() and (got.rois[0, c:, 1:] == 0).all()
