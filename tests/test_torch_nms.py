"""Fused-NMS parity: the port's plain PyTorch version against the JAX fused
kernel (Pallas, interpret mode on the CPU) and the greedy numpy oracle.

Keep masks are integer outputs: every comparison here is exact (the first
``max_keep`` survivors, or the whole mask when nothing is capped). The
12000-box scale runs through ``proposal_layer`` in test_torch_ops.py; the
interpret-mode JAX kernel keeps these cases at <= ~2k boxes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpn_tpu.ops.nms_fused import nms_keep_sorted_fused as jax_fused
from ctpn_tpu.utils import host_ref as H
from ctpn_tpu_torch.config import cfg as tcfg
from ctpn_tpu_torch.config import reset_cfg
from ctpn_tpu_torch.ops import nms as tnms
from ctpn_tpu_torch.ops.nms_fused import (
    nms_keep_sorted_fused,
    nms_keep_sorted_fused_ref,
)
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


def _oracle_keep(sb, ss, valid, thresh):
    """Greedy oracle over the valid rows, as a mask in sorted order."""
    rows = np.flatnonzero(valid)
    dets = np.hstack([sb, ss[:, None]])[rows]
    want = np.zeros(len(sb), bool)
    want[rows[H.py_nms(dets, thresh)]] = True
    return want


def _ref(sb, valid, thresh, max_keep=None):
    return nms_keep_sorted_fused_ref(
        torch.from_numpy(np.ascontiguousarray(sb)),
        torch.from_numpy(np.ascontiguousarray(valid)),
        thresh,
        max_keep,
    ).numpy()


def _jax(sb, valid, thresh, max_keep=None):
    return np.asarray(
        jax_fused(
            jnp.asarray(sb), jnp.asarray(valid), thresh,
            max_keep=max_keep, interpret=True,
        )
    )


@pytest.mark.parametrize("thresh", [0.7, 0.2])
@pytest.mark.parametrize("n", [33, 700, 1100])
def test_ref_matches_jax_kernel_and_oracle(rng, thresh, n):
    """Whole masks, no cap; 700 and 1100 are not multiples of 512."""
    sb, ss = _sorted_dets(rng, n)
    valid = np.ones((1, n), bool)
    got = _ref(sb[None], valid, thresh)
    np.testing.assert_array_equal(got, _jax(sb[None], valid, thresh))
    np.testing.assert_array_equal(got[0], _oracle_keep(sb, ss, valid[0], thresh))


@pytest.mark.parametrize("max_keep", [64, 300, 700])
def test_ref_max_keep_prefix(rng, max_keep):
    """The cap lands inside a block (64, 300 in block 0; 700 later): the
    first max_keep survivors are exact against the kernel and the oracle."""
    n = 2100
    sb, ss = _sorted_dets(rng, n, max_wh=60)
    valid = np.ones((1, n), bool)
    got = np.flatnonzero(_ref(sb[None], valid, 0.7, max_keep)[0])
    want = np.flatnonzero(_oracle_keep(sb, ss, valid[0], 0.7))
    jax_idx = np.flatnonzero(_jax(sb[None], valid, 0.7, max_keep)[0])
    m = min(max_keep, len(want))
    assert len(got) >= m
    np.testing.assert_array_equal(got[:m], want[:m])
    np.testing.assert_array_equal(got[:m], jax_idx[:m])


def test_ref_batch_with_invalid_rows(rng):
    n, batch = 700, 2
    sbs, sss, valids = zip(*[
        (*_sorted_dets(rng, n), rng.rand(n) > 0.3) for _ in range(batch)
    ])
    sb, valid = np.stack(sbs), np.stack(valids)
    got = _ref(sb, valid, 0.5)
    np.testing.assert_array_equal(got, _jax(sb, valid, 0.5))
    for b in range(batch):
        np.testing.assert_array_equal(
            got[b], _oracle_keep(sbs[b], sss[b], valids[b], 0.5)
        )
        assert not got[b][~valids[b]].any()


def test_ref_ties_and_duplicates(rng):
    """Exact duplicate boxes (IoU 1) and tied scores: the earlier row in
    sorted order wins, as in the oracle's argsort()[::-1]."""
    base, _ = _sorted_dets(rng, 150, max_wh=50)
    sb = np.repeat(base, 4, axis=0)  # each box four times in a row
    ss = np.repeat(np.linspace(1, 0, 150, dtype=np.float32), 4)
    valid = np.ones((1, len(sb)), bool)
    got = _ref(sb[None], valid, 0.7)[0]
    assert not got[1::4].any() and not got[2::4].any() and not got[3::4].any()
    np.testing.assert_array_equal(got, _jax(sb[None], valid, 0.7)[0])
    # the oracle re-sorts by score: feed it the sorted order explicitly
    want = np.zeros(len(sb), bool)
    want[H.py_nms(np.hstack([sb, np.arange(len(sb), 0, -1)[:, None]]), 0.7)] = True
    np.testing.assert_array_equal(got, want)


def test_ref_dense_chains(rng):
    """Heavily overlapping boxes: deep in-block suppression chains."""
    n = 600
    boxes = (
        np.array([100.0, 100.0, 180.0, 140.0])[None]
        + rng.randn(n, 4) * 6
    ).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    order = np.argsort(scores, kind="stable")[::-1]
    sb, ss = boxes[order], scores[order]
    valid = np.ones((1, n), bool)
    got = _ref(sb[None], valid, 0.5)
    np.testing.assert_array_equal(got, _jax(sb[None], valid, 0.5))
    np.testing.assert_array_equal(got[0], _oracle_keep(sb, ss, valid[0], 0.5))


def test_ref_all_invalid(rng):
    sb, _ = _sorted_dets(rng, 520)
    assert not _ref(sb[None], np.zeros((1, 520), bool), 0.7, 100).any()


def test_wrapper_dispatches_cpu_tensors_to_plain_version(rng):
    sb, _ = _sorted_dets(rng, 300)
    b = torch.from_numpy(sb)[None]
    v = torch.ones((1, 300), dtype=torch.bool)
    before = nms_keep_sorted_fused.LAUNCHES
    got = nms_keep_sorted_fused(b, v, 0.7, max_keep=50)
    assert torch.equal(got, nms_keep_sorted_fused_ref(b, v, 0.7, 50))
    assert nms_keep_sorted_fused.LAUNCHES == before  # no kernel launched


def test_wrapper_rejects_bad_inputs(rng):
    b = torch.zeros((1, 10, 4))
    with pytest.raises(ValueError):
        nms_keep_sorted_fused(b.double(), torch.ones((1, 10), dtype=torch.bool), 0.5)
    with pytest.raises(ValueError):
        nms_keep_sorted_fused(b, torch.ones((1, 10)), 0.5)
    with pytest.raises(ValueError):
        nms_keep_sorted_fused(b[0], torch.ones((10,), dtype=torch.bool), 0.5)


def test_bitmask_nms_not_ported_raises():
    tcfg.TPU.NMS_FUSED = False
    with pytest.raises(NotImplementedError, match="queue B"):
        tnms.nms_keep_sorted(
            torch.zeros((1, 4, 4)), torch.ones((1, 4), dtype=torch.bool), 0.5
        )
