"""H-mode connector and detector: the port against ``ctpn_tpu.postprocess``.

Successor indices are exact, and the chain walk reaches exactly the JAX
connector's reachability matrix, against both the vectorized JAX connector
and the numpy oracle. Line records agree within 1e-3 px plus 1e-5
relative: the chain statistics are sums taken in another order (the walk's
in float64, path order; XLA:CPU's f32 matmuls), and the covariance form
(sum of x*y minus n*mean_x*mean_y) cancels about five of f32's seven
digits, so at y ~ 500 px the two frameworks' records differ by up to
~2e-3 px (~60 ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpn_tpu.postprocess import connector as JC
from ctpn_tpu.postprocess import oracle as O
from ctpn_tpu.postprocess.detector import detect_lines as jax_detect_lines
from ctpn_tpu_torch.config import reset_cfg
from ctpn_tpu_torch.ops.chain_walk import chain_walk
from ctpn_tpu_torch.postprocess import connector as TC
from ctpn_tpu_torch.postprocess.detector import detect_lines

torch.set_num_threads(2)

IM_SIZE = (600, 900)


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def strip_scene(rng, n_lines=5, im_h=600, im_w=900, slope=0.0):
    """CTPN-like proposals: rows of 16-px strips, shuffled."""
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
            scores.append(rng.uniform(0.75, 1.0))
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
    padded = [_pad(b, s, n_pad) for b, s in scenes]
    return scenes, [np.stack(x) for x in zip(*padded)]


@pytest.mark.parametrize("slope", [0.0, 0.08])
def test_successors_exact(slope):
    scenes, (b, s, v) = _batch([0, 1, 2, 3], slope=slope)
    got = TC.build_successors(
        torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(v)
    ).numpy()
    want = np.asarray(jax.vmap(JC.build_successors)(
        jnp.asarray(b), jnp.asarray(s), jnp.asarray(v)))
    np.testing.assert_array_equal(got, want)
    for i, (boxes, scores) in enumerate(scenes):
        graph = O.build_graph_np(boxes.astype(np.float64), scores, IM_SIZE)
        mine = np.zeros_like(graph)
        rows = np.flatnonzero(got[i, :len(boxes)] >= 0)
        mine[rows, got[i, rows]] = True
        np.testing.assert_array_equal(mine, graph)


# the walk's float64 sums, rounded once, against R @ F in float64: within
# one float32 rounding of each sum's magnitude
SUM_RTOL = 2.0 ** -23


@pytest.mark.parametrize("max_len", [None, 57, 3])
def test_reachability_exact(max_len):
    """The chain walk (``ops/chain_walk.py``) reaches exactly the JAX
    connector's reachability matrix R after its squarings: node counts,
    chain starts, and the least x1 and largest x2 over R's members are
    equal; the feature sums are R @ F within one float32 rounding."""
    _, (b, s, v) = _batch([4, 5], n_pad=128)
    succ = TC.build_successors(
        torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(v)
    )
    feats = np.random.RandomState(11).normal(0, 100, (2, 128, 7)).astype(np.float32)
    x1, x2 = b[..., 0], b[..., 2]
    sums, cnt, lo, hi, is_start = chain_walk(
        succ, torch.from_numpy(feats), torch.from_numpy(x1), torch.from_numpy(x2),
        TC.walk_steps(128, max_len))
    for i in range(2):
        jr, js = JC.chain_reachability(jnp.asarray(succ[i].numpy()), max_len)
        r = np.asarray(jr) > 0
        np.testing.assert_array_equal(cnt[i].numpy(), r.sum(1))
        np.testing.assert_array_equal(is_start[i].numpy(), np.asarray(js))
        np.testing.assert_array_equal(lo[i].numpy(), np.where(r, x1[i], np.inf).min(1))
        np.testing.assert_array_equal(hi[i].numpy(), np.where(r, x2[i], -np.inf).max(1))
        want = r @ feats[i].astype(np.float64)
        scale = r @ np.abs(feats[i].astype(np.float64))
        assert np.all(np.abs(sums[i].numpy() - want) <= SUM_RTOL * scale)
    if max_len == 3:  # 4 steps: longer chains are cut, as the squarings cut them
        assert cnt.max() == 5


def test_reachability_matches_oracle_walks():
    """The walks from chain starts are the oracle's walks, shared tails
    included (two heads converging on one node)."""
    succ = np.array([[2, 2, 3, -1, 5, -1, -1]], np.int32)
    onehot = torch.eye(7)[None]  # the sums of one-hot features: the members
    x = torch.zeros((1, 7))
    sums, cnt, _, _, is_start = chain_walk(torch.from_numpy(succ), onehot, x, x, 8)
    graph = np.zeros((7, 7), bool)
    for i, j in enumerate(succ[0]):
        if j >= 0:
            graph[i, j] = True
    walks = O.sub_graphs_np(graph)
    starts = np.flatnonzero(is_start[0].numpy())
    assert len(walks) == len(starts)
    for s, walk in zip(starts, walks):
        assert set(np.flatnonzero(sums[0, s].numpy())) == set(walk)
        assert cnt[0, s] == len(walk)


@pytest.mark.parametrize("slope", [0.0, 0.08])
def test_connect_text_lines_matches_jax(slope):
    _, (b, s, v) = _batch([6, 7, 8], slope=slope)
    info = np.tile(np.array([600, 900, 1.0], np.float32), (3, 1))
    got = TC.connect_text_lines(
        torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(v),
        torch.from_numpy(info), max_lines=32, max_chain_len=57,
    )
    want = jax.vmap(
        lambda bb, ss, vv, ii: JC.connect_text_lines(
            bb, ss, vv, ii, max_lines=32, max_chain_len=57)
    )(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v), jnp.asarray(info))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    assert got.count.sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.recs.numpy(), np.asarray(want.recs), atol=1e-3, rtol=1e-5)


def test_detect_lines_matches_jax():
    """Score-sorted rois with duplicates and low scores: the 0.2 NMS and the
    score filter run before the connector."""
    rng = np.random.RandomState(9)
    rois = []
    for i in range(2):
        b, s = strip_scene(rng)
        dup = b[: len(b) // 3] + rng.uniform(-2, 2, (len(b) // 3, 4)).astype(np.float32)
        b = np.concatenate([b, dup])
        s = np.concatenate([s, rng.uniform(0.5, 1.0, len(dup)).astype(np.float32)])
        order = np.argsort(s, kind="stable")[::-1]
        r = np.zeros((200, 5), np.float32)
        r[:, 0] = -1.0
        r[: len(b), 0], r[: len(b), 1:] = s[order], b[order]
        rois.append(r)
    rois = np.stack(rois)
    valid = rois[..., 0] > -1
    info = np.tile(np.array([600, 900, 1.0], np.float32), (2, 1))
    got = detect_lines(torch.from_numpy(rois), torch.from_numpy(valid),
                       torch.from_numpy(info), max_lines=32)
    want = jax.vmap(lambda r, v, i: jax_detect_lines(r, v, i, max_lines=32))(
        jnp.asarray(rois), jnp.asarray(valid), jnp.asarray(info))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    assert got.count.sum() > 0
    np.testing.assert_allclose(got.recs.numpy(), np.asarray(want.recs), atol=1e-3, rtol=1e-5)


def test_o_mode_not_ported():
    """O mode is ported now: ``mode="O"`` runs and matches the JAX
    connector on a small case (the O-mode cases are in
    tests/test_torch_connector_o.py)."""
    _, (b, s, v) = _batch([6, 7], slope=0.08)
    info = np.tile(np.array([600, 900, 1.0], np.float32), (2, 1))
    got = TC.connect_text_lines(
        torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(v),
        torch.from_numpy(info), mode="O", max_lines=32,
    )
    want = jax.vmap(lambda bb, ss, vv, ii: JC.connect_text_lines(
        bb, ss, vv, ii, mode="O", max_lines=32))(
        jnp.asarray(b), jnp.asarray(s), jnp.asarray(v), jnp.asarray(info))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_allclose(got.recs.numpy(), np.asarray(want.recs), atol=1e-3, rtol=1e-5)
