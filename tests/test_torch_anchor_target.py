"""The port's anchor-target layer and IoU against ``ctpn_tpu``'s.

Both sides see the same numpy inputs; the port is fed the JAX package's
uniform draws (``split(rng, B)`` per image, then ``split`` into fg and bg,
then ``uniform(K)``), so the sampled labels must match too. Tolerances:
labels exact (integers); targets and weights within 1e-6 (the encode's
``log`` may differ by an ulp between XLA and PyTorch); IoU and the
intersection fraction bit for bit (same operations in the same order, no
FMA on either side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpn_tpu.ops.anchor_target import anchor_target_batched
from ctpn_tpu.ops.iou import pairwise_intersection_frac as jax_frac
from ctpn_tpu.ops.iou import pairwise_iou as jax_iou
from ctpn_tpu_torch.ops.anchor_target import anchor_target_layer, num_anchors
from ctpn_tpu_torch.ops.iou import pairwise_intersection_frac, pairwise_iou
from tests.conftest import random_boxes

torch.set_num_threads(2)


def jax_draws(rng, n: int, k: int) -> np.ndarray:
    """(2, n, k): the uniforms ``anchor_target_batched(rng, ...)`` draws."""
    out = np.zeros((2, n, k), np.float32)
    for i, r in enumerate(jax.random.split(rng, n)):
        r_fg, r_bg = jax.random.split(r)
        out[0, i] = np.asarray(jax.random.uniform(r_fg, (k,)))
        out[1, i] = np.asarray(jax.random.uniform(r_bg, (k,)))
    return out


def _inputs(rng, n, fh, fw, n_gt, max_gt=32, n_dc=0, max_dc=8, hard_frac=0.0,
            integer=False, scale=1.0):
    im_h, im_w = fh * 16, fw * 16
    gt = np.zeros((n, max_gt, 4), np.float32)
    ishard = np.zeros((n, max_gt), bool)
    dc = np.zeros((n, max_dc, 4), np.float32)
    for i in range(n):
        boxes = random_boxes(rng, n_gt, im_h=im_h / scale, im_w=im_w / scale, max_wh=60)
        if integer:
            boxes = np.floor(boxes)
        gt[i, :n_gt] = boxes * np.float32(scale)
        if hard_frac:
            ishard[i, :n_gt] = rng.uniform(size=n_gt) < hard_frac
        if n_dc:
            dc[i, :n_dc] = random_boxes(rng, n_dc, im_h=im_h, im_w=im_w, max_wh=100)
    valid = np.tile(np.arange(max_gt) < n_gt, (n, 1))
    dc_valid = np.tile(np.arange(max_dc) < n_dc, (n, 1))
    # the last image's true extent is smaller than the bucket
    info = np.tile(np.array([im_h, im_w, scale], np.float32), (n, 1))
    info[-1, :2] = [im_h - 16, im_w - 40]
    return gt, valid, ishard, dc, dc_valid, info


def _compare(inputs, fh, fw, key, **kw):
    n = inputs[0].shape[0]
    want = anchor_target_batched(key, *(jnp.asarray(a) for a in inputs),
                                 feat_h=fh, feat_w=fw, **kw)
    u = torch.from_numpy(jax_draws(key, n, num_anchors(fh, fw)))
    got = anchor_target_layer(*(torch.from_numpy(a) for a in inputs), u[0], u[1],
                              fh, fw, **kw)
    labels = got.labels.numpy()
    assert labels.dtype == np.int32 and labels.shape == (n, fh, fw, 10)
    np.testing.assert_array_equal(labels, np.asarray(want.labels))
    for name in ("bbox_targets", "bbox_inside_weights", "bbox_outside_weights"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == np.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)
    return labels


CASES = {
    "plain": (dict(n_gt=6), dict()),
    "integer_boxes": (dict(n_gt=8, integer=True), dict()),
    "scaled_boxes": (dict(n_gt=8, integer=True, scale=0.8333333), dict()),
    "dontcare": (dict(n_gt=5, n_dc=3), dict()),
    "hard_gt": (dict(n_gt=6, hard_frac=0.5), dict()),
    "ohem": (dict(n_gt=6), dict(ohem=True)),
    "clobber_positives": (dict(n_gt=6), dict(clobber_positives=True)),
    "no_preclude_hard": (dict(n_gt=6, hard_frac=0.5), dict(preclude_hard=False)),
    "small_batchsize": (dict(n_gt=10), dict(rpn_batchsize=40, fg_fraction=0.25)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(rng, case):
    make, kw = CASES[case]
    fh, fw = 8, 10
    labels = _compare(_inputs(rng, 1, fh, fw, **make), fh, fw,
                      jax.random.PRNGKey(5), **kw)
    assert (labels == 1).any() and (labels == 0).any()


def test_batch_of_three_per_image_keys(rng):
    """Three images, one key split per image: each row's sample follows
    its own draws; the rows differ."""
    fh, fw = 8, 12
    labels = _compare(_inputs(rng, 3, fh, fw, n_gt=7, n_dc=2, hard_frac=0.3),
                      fh, fw, jax.random.PRNGKey(11), rpn_batchsize=120)
    assert not np.array_equal(labels[0], labels[1])


def test_subsampling_caps_fg_and_bg():
    """Close-packed gt strips give more fg candidates than the cap: the cap
    and the batch size hold, and the chosen sets equal JAX's."""
    fh, fw = 10, 14
    xs = np.arange(0, fw * 16 - 16, 16)
    strips = np.stack([xs, np.full_like(xs, 32), xs + 15, np.full_like(xs, 80)], 1)
    strips = np.concatenate([strips + np.array([0, dy, 0, dy]) for dy in (0, 96)])
    max_gt = 64
    gt = np.zeros((1, max_gt, 4), np.float32)
    gt[0, :len(strips)] = strips
    inputs = (gt, (np.arange(max_gt) < len(strips))[None], np.zeros((1, max_gt), bool),
              np.zeros((1, 8, 4), np.float32), np.zeros((1, 8), bool),
              np.array([[fh * 16, fw * 16, 1.0]], np.float32))
    labels = _compare(inputs, fh, fw, jax.random.PRNGKey(7), rpn_batchsize=60)
    assert (labels == 1).sum() == 30 and (labels >= 0).sum() == 60


@pytest.mark.parametrize("integer", [True, False])
def test_iou_matches_jax(rng, integer):
    boxes = random_boxes(rng, 40)
    query = random_boxes(rng, 30)
    if integer:
        boxes, query = np.floor(boxes), np.floor(query)
    got = pairwise_iou(torch.from_numpy(boxes), torch.from_numpy(query)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_iou(boxes, query)))
    got = pairwise_intersection_frac(torch.from_numpy(boxes), torch.from_numpy(query))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_frac(boxes, query)))
    # leading dims broadcast: (2, N, 4) against (N', 4)
    stacked = pairwise_iou(torch.from_numpy(np.stack([boxes, boxes])),
                           torch.from_numpy(query))
    assert stacked.shape == (2, 40, 30)
    assert torch.equal(stacked[0], stacked[1])
