"""Bitmask NMS route of the port against the JAX package.

The port's plain bitmask (``suppression_bitmask_ref``) is held against the
Pallas kernel (``suppression_bitmask_pallas``, interpret mode on the CPU)
and ``suppression_bitmask_jnp``; the resolves against JAX's
``nms_fixed_point`` and ``nms_fixed_point_blocked``; the
``NMS_FUSED = False`` route of ``nms_keep_sorted`` against the fused route
and the greedy numpy oracle. All outputs are integer or bool: every
comparison is exact (tolerance 0). The port stores the uint32 words as
int32 with the same bits, so the JAX words are compared through
``.view(np.int32)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpn_tpu.ops import nms as J
from ctpn_tpu.ops.nms_pallas import suppression_bitmask_pallas
from ctpn_tpu.utils import host_ref as H
from ctpn_tpu_torch.config import cfg as tcfg
from ctpn_tpu_torch.config import reset_cfg
from ctpn_tpu_torch.ops import nms as T
from ctpn_tpu_torch.ops.nms_bitmask import (
    pack_bits,
    suppression_bitmask,
    suppression_bitmask_ref,
)
from ctpn_tpu_torch.ops.nms_fused import nms_keep_sorted_fused_ref
from tests.conftest import random_boxes

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def _sorted_dets(rng, n, **kw):
    boxes = random_boxes(rng, n, **kw)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    order = np.argsort(scores, kind="stable")[::-1]
    return boxes[order], scores[order]


def _t(a):
    return torch.from_numpy(np.array(a))


def _words(mask_u32):
    return np.asarray(mask_u32).view(np.int32)


@pytest.mark.parametrize("n", [50, 300, 1300])
def test_plain_bitmask_matches_pallas_and_jnp(rng, n):
    """Exact words at N not a multiple of 32 or of the row block, with
    about a third of the rows invalid."""
    sb, _ = _sorted_dets(rng, n, max_wh=90)
    valid = rng.rand(n) > 0.3
    got = suppression_bitmask_ref(_t(sb)[None], _t(valid)[None], 0.5).numpy()[0]
    want = _words(J.suppression_bitmask_jnp(jnp.asarray(sb), jnp.asarray(valid), 0.5))
    pallas = _words(suppression_bitmask_pallas(
        jnp.asarray(sb), jnp.asarray(valid), 0.5, interpret=True))
    assert got.shape == (n, (n + 31) // 32)
    assert want.any()  # the case sets bits
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


def test_plain_bitmask_batched_thresholds(rng):
    """A batch of two images at both thresholds of the main path; each
    image equals its own JAX mask, and words below the diagonal are 0."""
    n = 700
    dets = [_sorted_dets(rng, n)[0] for _ in range(2)]
    valid = np.stack([rng.rand(n) > 0.2 for _ in range(2)])
    for thresh in (0.7, 0.2):
        got = suppression_bitmask_ref(_t(np.stack(dets)), _t(valid), thresh).numpy()
        for b in range(2):
            want = _words(J.suppression_bitmask_jnp(
                jnp.asarray(dets[b]), jnp.asarray(valid[b]), thresh))
            np.testing.assert_array_equal(got[b], want)
        rows = np.arange(n)[:, None]
        first_col = np.arange(got.shape[2])[None] * 32
        assert not got[:, (first_col + 31) <= rows].any()


@pytest.mark.parametrize(
    "n", [31, 32, 33, 63, 64, 65, 127, 128, 129, 1023, 1024, 1025])
def test_plain_bitmask_at_kernel_tile_edges(rng, n):
    """N one below, at and one above a multiple of a word (32), of the CUDA
    kernel's rows per CTA (64), of a warp's columns (128) and of a tile's
    columns (1024): dense clusters, a tenth of the boxes invalid."""
    c = rng.uniform(0, 500, (8, 2))
    base = np.concatenate([c, c + rng.uniform(30, 100, (8, 2))], 1)
    boxes = base[rng.randint(0, 8, n)] + rng.normal(0, 4, (n, 4))
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
    boxes = boxes.astype(np.float32)
    valid = rng.rand(n) > 0.1
    got = suppression_bitmask_ref(_t(boxes)[None], _t(valid)[None], 0.5).numpy()[0]
    want = _words(J.suppression_bitmask_jnp(jnp.asarray(boxes), jnp.asarray(valid), 0.5))
    assert want.any()
    np.testing.assert_array_equal(got, want)


def test_plain_bitmask_invalid_box_in_diagonal_word():
    """Identical boxes all suppress each other: row i's bits are exactly the
    later valid columns, so an invalid box leaves a hole in every earlier
    row's word and an empty row of its own, the diagonal words included."""
    n = 200
    boxes = np.tile(np.float32([[10, 20, 80, 60]]), (n, 1))
    valid = np.ones(n, bool)
    valid[[0, 37, 64, 95, 127, 128, 199]] = False
    got = suppression_bitmask_ref(_t(boxes)[None], _t(valid)[None], 0.5).numpy()[0]
    want = _words(J.suppression_bitmask_jnp(jnp.asarray(boxes), jnp.asarray(valid), 0.5))
    np.testing.assert_array_equal(got, want)
    bits = (got.view(np.uint32)[:, np.arange(n) // 32] >> (np.arange(n) % 32)) & 1
    later = np.arange(n)[None, :] > np.arange(n)[:, None]
    np.testing.assert_array_equal(bits.astype(bool), later & valid[:, None] & valid[None, :])


@pytest.mark.parametrize("thresh", [0.2, 0.0])
def test_plain_bitmask_touching_boxes(rng, thresh):
    """Boxes 2 px wide on integer x positions: pairs are identical, share one
    pixel column (iw = 1), touch without overlapping (iw = 0) or lie apart.
    Pins what a kernel that skips pairs without x overlap must produce; at
    t = 0 every ordered valid pair suppresses, overlap or not."""
    n = 300
    x = rng.randint(0, 60, n).astype(np.float32)
    y = rng.randint(0, 4, n).astype(np.float32)
    boxes = np.stack([x, y, x + 1, y + 20], 1)
    valid = np.ones(n, bool)
    got = suppression_bitmask_ref(_t(boxes)[None], _t(valid)[None], thresh).numpy()[0]
    want = _words(J.suppression_bitmask_jnp(jnp.asarray(boxes), jnp.asarray(valid), thresh))
    np.testing.assert_array_equal(got, want)
    bits = ((got.view(np.uint32)[:, np.arange(n) // 32] >> (np.arange(n) % 32)) & 1).astype(bool)
    later = np.arange(n)[None, :] > np.arange(n)[:, None]
    dx = np.abs(x[:, None] - x[None, :])
    if thresh == 0.0:
        np.testing.assert_array_equal(bits, later)
    else:
        assert not bits[later & (dx >= 2)].any()  # touching or apart: never
        assert bits[later & (dx == 0)].all()      # at most 3 px apart in y: IoU >= 3/4
        assert bits[later & (dx == 1)].any()      # one shared column: IoU up to 1/3


def test_pack_bits_sets_bit_31():
    bits = torch.zeros((2, 64), dtype=torch.bool)
    bits[0, 31] = bits[0, 0] = bits[1, 63] = True
    np.testing.assert_array_equal(
        pack_bits(bits).numpy().view(np.uint32),
        np.array([[2**31 + 1, 0], [0, 2**31]], np.uint32),
    )


@pytest.mark.parametrize("n,block", [(50, 32), (300, 64), (300, 1024), (1000, 256)])
def test_resolves_match_jax(rng, n, block):
    """The block sizes of tests/test_nms.py's blocked-resolve test."""
    sb, _ = _sorted_dets(rng, n, max_wh=70)
    valid = rng.uniform(size=n) < 0.9
    mask_u32 = J.suppression_bitmask_jnp(jnp.asarray(sb), jnp.asarray(valid), 0.5)
    want = np.asarray(J.nms_fixed_point(mask_u32, jnp.asarray(valid)))
    want_blocked = np.asarray(
        J.nms_fixed_point_blocked(mask_u32, jnp.asarray(valid), block=block))
    mask = _t(_words(mask_u32))[None]
    before = T.nms_fixed_point_blocked.SWEEPS
    got_blocked = T.nms_fixed_point_blocked(mask, _t(valid)[None], block=block)
    got = T.nms_fixed_point(mask, _t(valid)[None])
    np.testing.assert_array_equal(got.numpy()[0], want)
    np.testing.assert_array_equal(got_blocked.numpy()[0], want_blocked)
    # one sweep at least per block, each one host sync
    assert T.nms_fixed_point_blocked.SWEEPS - before >= -(-n // block)


def test_blocked_resolve_rejects_bad_block():
    with pytest.raises(ValueError, match="multiple"):
        T.nms_fixed_point_blocked(
            torch.zeros((1, 40, 2), dtype=torch.int32),
            torch.ones((1, 40), dtype=torch.bool), block=48)


@pytest.mark.parametrize("thresh,max_keep", [(0.7, 300), (0.2, None)])
def test_bitmask_route_matches_fused_route_and_oracle(rng, thresh, max_keep):
    """``NMS_FUSED = False`` through ``nms_keep_sorted``: the same first-K
    survivors as the fused route, and every survivor of the oracle."""
    n = 1300
    sbs, sss = zip(*[_sorted_dets(rng, n, max_wh=60) for _ in range(2)])
    valid = np.stack([rng.rand(n) > 0.25 for _ in range(2)])
    boxes, v = _t(np.stack(sbs)), _t(valid)
    tcfg.TPU.NMS_FUSED = False
    got = T.nms_keep_sorted(boxes, v, thresh, max_keep=max_keep).numpy()
    fused = nms_keep_sorted_fused_ref(boxes, v, thresh, max_keep).numpy()
    for b in range(2):
        rows = np.flatnonzero(valid[b])
        dets = np.hstack([sbs[b], sss[b][:, None]])[rows]
        want = np.zeros(n, bool)
        want[rows[H.py_nms(dets, thresh)]] = True
        np.testing.assert_array_equal(got[b], want)
        k = np.flatnonzero(fused[b])
        m = len(k) if max_keep is None else min(max_keep, len(k))
        np.testing.assert_array_equal(np.flatnonzero(got[b])[:m], k[:m])


def test_nms_mask_and_keep_indices_match_jax(rng):
    """Original-order keep mask and padded keep indices (ties in score go
    to the larger original index, as in the reference)."""
    n = 400
    boxes = random_boxes(rng, n, max_wh=80)
    scores = np.round(rng.uniform(0, 1, n), 2).astype(np.float32)  # ties
    valid = rng.rand(n) > 0.1
    args = (jnp.asarray(boxes), jnp.asarray(scores), 0.4)
    want = np.asarray(J.nms_mask(*args, valid=jnp.asarray(valid), use_pallas=False))
    want_idx, want_count = J.nms_keep_indices(
        *args, 150, valid=jnp.asarray(valid), use_pallas=False)
    tcfg.TPU.NMS_FUSED = False
    tb, ts, tv = _t(boxes)[None], _t(scores)[None], _t(valid)[None]
    got = T.nms_mask(tb, ts, 0.4, valid=tv)
    idx, count = T.nms_keep_indices(tb, ts, 0.4, 150, valid=tv)
    np.testing.assert_array_equal(got.numpy()[0], want)
    np.testing.assert_array_equal(idx.numpy()[0], np.asarray(want_idx))
    assert int(count[0]) == int(want_count)


def test_or_reduce_matches_numpy(rng):
    x = rng.randint(-2**31, 2**31 - 1, (3, 37, 5), dtype=np.int64).astype(np.int32)
    want = np.bitwise_or.reduce(x, axis=1)
    np.testing.assert_array_equal(T.or_reduce(_t(x), 1).numpy(), want)


def test_wrapper_dispatch(rng):
    """CPU tensors run the plain version without a launch; a device that is
    neither CPU nor CUDA raises."""
    sb, _ = _sorted_dets(rng, 100)
    b, v = _t(sb)[None], torch.ones((1, 100), dtype=torch.bool)
    before = suppression_bitmask.LAUNCHES
    assert torch.equal(suppression_bitmask(b, v, 0.7), suppression_bitmask_ref(b, v, 0.7))
    assert suppression_bitmask.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        suppression_bitmask(b.to("meta"), v.to("meta"), 0.7)
    with pytest.raises(ValueError):
        suppression_bitmask(b.double(), v, 0.7)
