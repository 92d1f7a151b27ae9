"""The resolve phase of the port's bitmask NMS route against the JAX package.

``nms_resolve`` (on the CPU: its plain version) is held against JAX's
``nms_fixed_point`` and ``nms_fixed_point_blocked`` on masks from
``suppression_bitmask_jnp``; a numpy mirror of the CUDA kernel's walk
(``ops/csrc/nms_resolve.cu``: 32-row groups, the in-word chain, the fold of
the kept rows into the suppressed-box vectors of the CTAs that share the
word columns) is held against the same
answers, so the algorithm is checked where no card is needed; the
``NMS_FUSED = False`` route of ``nms_keep_sorted`` against the fused route
and the greedy numpy oracle. All outputs are bool: every comparison is
exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpn_tpu.ops import nms as J
from ctpn_tpu.utils import host_ref as H
from ctpn_tpu_torch.config import cfg as tcfg
from ctpn_tpu_torch.config import reset_cfg
from ctpn_tpu_torch.ops import nms as T
from ctpn_tpu_torch.ops import nms_resolve as R
from ctpn_tpu_torch.ops.nms_fused import nms_keep_sorted_fused_ref
from tests.conftest import random_boxes

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def _t(a):
    return torch.from_numpy(np.array(a))


def _sorted_boxes(rng, n, **kw):
    boxes = random_boxes(rng, n, **kw)
    order = np.argsort(rng.uniform(0, 1, n), kind="stable")[::-1]
    return boxes[order]


def _jax_mask(boxes, valid, thresh):
    """uint32 words of the JAX package's bitmask, as a numpy array."""
    return np.asarray(
        J.suppression_bitmask_jnp(jnp.asarray(boxes), jnp.asarray(valid), thresh))


def _case(name, rng):
    """(boxes (n, 4), valid (n,), thresh) of a named case."""
    if name.startswith("n="):
        n = int(name[2:])
        return _sorted_boxes(rng, n, max_wh=90), np.ones(n, bool), 0.5
    if name == "n1300_30pct_invalid":
        return _sorted_boxes(rng, 1300, max_wh=90), rng.rand(1300) > 0.3, 0.5
    if name == "all_identical":  # one survivor, every later box folded away
        return np.tile(np.float32([[10, 20, 80, 60]]), (200, 1)), np.ones(200, bool), 0.5
    if name == "all_invalid":
        return _sorted_boxes(rng, 100), np.zeros(100, bool), 0.5
    if name == "clusters":  # long chains inside a word
        c = rng.uniform(0, 500, (6, 2))
        base = np.concatenate([c, c + rng.uniform(30, 100, (6, 2))], 1)
        boxes = base[rng.randint(0, 6, 500)] + rng.normal(0, 4, (500, 4))
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
        return boxes.astype(np.float32), rng.rand(500) > 0.1, 0.5
    raise KeyError(name)


SIZES = ["n=1", "n=31", "n=32", "n=33", "n=300", "n=1000", "n1300_30pct_invalid"]
EDGES = ["all_identical", "all_invalid", "clusters"]


def kernel_walk(mask_u32: np.ndarray, valid: np.ndarray, ranks: int = 1) -> np.ndarray:
    """The CUDA kernel's walk over one image, step for step in numpy.

    Group g = rows 32g .. 32g + 31. CTA c of the ``ranks`` CTAs owns the
    word columns ``[c * slice, (c + 1) * slice)`` and a vector ``supp`` over
    them; the owner of word g resolves group g: ``alive = valid_word &
    ~supp[g]``, then the chain clears, for each row still alive at its
    turn, the later boxes of the word that its diagonal word names. Every
    CTA with columns right of g ORs the kept rows' words of its own columns
    into its ``supp``. Words at or left of the diagonal word other than the
    diagonal word itself are never read.
    """
    n, words = mask_u32.shape
    width = -(-words // ranks)
    supp = [np.zeros(width, np.uint32) for _ in range(ranks)]
    keep = np.zeros(n, bool)
    for g in range(words):
        owner = g // width
        rows = range(32 * g, min(32 * g + 32, n))
        alive = 0
        for i in rows:
            alive |= int(valid[i]) << (i % 32)
        alive &= ~int(supp[owner][g - owner * width]) & 0xFFFFFFFF
        for i in rows:
            k = i % 32
            # a row may only suppress later boxes of its own word
            own = int(mask_u32[i, g]) & (0xFFFFFFFF << (k + 1)) & 0xFFFFFFFF
            if (alive >> k) & 1:
                alive &= ~own
        for i in rows:
            if (alive >> (i % 32)) & 1:
                keep[i] = True
                for c in range(owner, ranks):
                    lo, hi = max(c * width, g + 1), min((c + 1) * width, words)
                    if lo < hi:
                        supp[c][lo - c * width:hi - c * width] |= mask_u32[i, lo:hi]
    return keep


@pytest.mark.parametrize("name", SIZES)
def test_resolve_matches_jax(rng, name):
    """The wrapper on CPU tensors against both JAX resolves."""
    boxes, valid, thresh = _case(name, rng)
    mask_u32 = _jax_mask(boxes, valid, thresh)
    want = np.asarray(J.nms_fixed_point(jnp.asarray(mask_u32), jnp.asarray(valid)))
    want_blocked = np.asarray(
        J.nms_fixed_point_blocked(jnp.asarray(mask_u32), jnp.asarray(valid)))
    got = R.nms_resolve(_t(mask_u32.view(np.int32))[None], _t(valid)[None]).numpy()[0]
    np.testing.assert_array_equal(want_blocked, want)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == bool and got.shape == valid.shape


def test_resolve_batched_unequal_survivors(rng):
    """Images of one batch resolve independently: from one tight cluster (a
    handful of survivors) to spread boxes (most survive)."""
    n = 300
    boxes = [np.tile(np.float32([[5, 5, 50, 40]]), (n, 1)),
             _sorted_boxes(rng, n, max_wh=200),
             _sorted_boxes(rng, n, max_wh=20)]
    valid = np.stack([rng.rand(n) > 0.2 for _ in boxes])
    masks = np.stack([_jax_mask(b, v, 0.4) for b, v in zip(boxes, valid)])
    got = R.nms_resolve(_t(masks.view(np.int32)), _t(valid)).numpy()
    counts = got.sum(axis=1)
    assert counts[0] == 1 and counts[0] < counts[1] < counts[2]
    for b in range(len(boxes)):
        want = np.asarray(
            J.nms_fixed_point_blocked(jnp.asarray(masks[b]), jnp.asarray(valid[b])))
        np.testing.assert_array_equal(got[b], want)
        np.testing.assert_array_equal(kernel_walk(masks[b], valid[b]), want)


@pytest.mark.parametrize("name", SIZES + EDGES)
def test_kernel_walk_mirror_matches_jax(rng, name):
    """The kernel's algorithm, mirrored in numpy, gives the fixed point."""
    boxes, valid, thresh = _case(name, rng)
    mask_u32 = _jax_mask(boxes, valid, thresh)
    want = np.asarray(J.nms_fixed_point(jnp.asarray(mask_u32), jnp.asarray(valid)))
    got = kernel_walk(mask_u32, valid)
    np.testing.assert_array_equal(got, want)
    for ranks in (2, 8):  # the cluster sizes that cut the columns
        np.testing.assert_array_equal(kernel_walk(mask_u32, valid, ranks), want)
    plain = R.nms_resolve(_t(mask_u32.view(np.int32))[None], _t(valid)[None]).numpy()[0]
    np.testing.assert_array_equal(plain, want)
    if name == "all_identical":
        assert got.sum() == 1 and got[0]
    if name == "all_invalid":
        assert not got.any()


def test_wrapper_runs_plain_version_on_cpu(rng):
    """CPU tensors run ``nms_fixed_point_blocked`` (its sweeps move) and
    leave ``LAUNCHES`` alone; the plain versions are the same function
    objects under ``ops.nms``."""
    boxes, valid, thresh = _case("n=300", rng)
    mask = _t(_jax_mask(boxes, valid, thresh).view(np.int32))[None]
    launches, sweeps = R.nms_resolve.LAUNCHES, R.nms_fixed_point_blocked.SWEEPS
    got = R.nms_resolve(mask, _t(valid)[None])
    assert R.nms_resolve.LAUNCHES == launches
    assert R.nms_fixed_point_blocked.SWEEPS > sweeps
    assert torch.equal(got, R.nms_fixed_point_blocked(mask, _t(valid)[None]))
    assert T.nms_fixed_point_blocked is R.nms_fixed_point_blocked
    assert T.nms_fixed_point is R.nms_fixed_point
    assert T.nms_resolve is R.nms_resolve


@pytest.mark.parametrize("n", [0, 40])
def test_wrapper_empty_batch_and_no_boxes(n):
    for batch in (0, 2):
        if batch and n:
            continue
        mask = torch.zeros((batch, n, (n + 31) // 32), dtype=torch.int32)
        keep = R.nms_resolve(mask, torch.ones((batch, n), dtype=torch.bool))
        assert keep.shape == (batch, n) and keep.dtype == torch.bool


@pytest.mark.parametrize("bad", ["meta", "mask_dtype", "valid_dtype", "words",
                                 "rows", "valid_ndim"])
def test_wrapper_rejects(bad):
    mask = torch.zeros((1, 40, 2), dtype=torch.int32)
    valid = torch.ones((1, 40), dtype=torch.bool)
    match = "must be"
    if bad == "meta":
        mask, valid, match = mask.to("meta"), valid.to("meta"), "unsupported device"
    elif bad == "mask_dtype":
        mask = mask.long()
    elif bad == "valid_dtype":
        valid = valid.to(torch.uint8)
    elif bad == "words":
        mask = torch.zeros((1, 40, 3), dtype=torch.int32)
    elif bad == "rows":
        mask = torch.zeros((1, 39, 2), dtype=torch.int32)
    elif bad == "valid_ndim":
        valid = valid[0]
    with pytest.raises(ValueError, match=match):
        R.nms_resolve(mask, valid)


def test_wrapper_rejects_mixed_devices():
    with pytest.raises(ValueError, match="same device"):
        R.nms_resolve(torch.zeros((1, 40, 2), dtype=torch.int32),
                      torch.ones((1, 40), dtype=torch.bool).to("meta"))


@pytest.mark.parametrize("thresh,max_keep", [(0.7, 200), (0.2, None)])
def test_bitmask_route_goes_through_resolve(rng, monkeypatch, thresh, max_keep):
    """``nms_keep_sorted`` with ``NMS_FUSED = False`` calls the bitmask and
    the resolve wrappers once each, and equals the fused route's first-K
    survivors and the greedy oracle."""
    n = 700
    boxes = np.stack([_sorted_boxes(rng, n, max_wh=60) for _ in range(2)])
    scores = np.sort(rng.uniform(0, 1, (2, n)).astype(np.float32), axis=1)[:, ::-1]
    valid = np.stack([rng.rand(n) > 0.25 for _ in range(2)])
    calls = []
    resolve = T.nms_resolve

    def counting(mask, v):
        calls.append(tuple(mask.shape))
        return resolve(mask, v)

    monkeypatch.setattr(T, "nms_resolve", counting)
    tcfg.TPU.NMS_FUSED = False
    got = T.nms_keep_sorted(_t(boxes), _t(valid), thresh, max_keep=max_keep).numpy()
    assert calls == [(2, n, (n + 31) // 32)]
    fused = nms_keep_sorted_fused_ref(_t(boxes), _t(valid), thresh, max_keep).numpy()
    for b in range(2):
        rows = np.flatnonzero(valid[b])
        dets = np.hstack([boxes[b], scores[b][:, None]])[rows]
        want = np.zeros(n, bool)
        want[rows[H.py_nms(dets, thresh)]] = True
        np.testing.assert_array_equal(got[b], want)
        k = np.flatnonzero(fused[b])
        m = len(k) if max_keep is None else min(max_keep, len(k))
        np.testing.assert_array_equal(np.flatnonzero(got[b])[:m], k[:m])
