"""The host post-processing path: the port's copies of the numpy oracles
and ``CTPNPredictor.detect_image_host`` against the JAX package's.

``utils/host_ref.py`` and ``postprocess/oracle.py`` are copies of the JAX
package's modules, so on the same inputs they must give EQUAL arrays.
``detect_image_host`` runs the trunk on the device and everything after the
heads on the host; in f32 with the shipped weights the port's records
must pair one-to-one with the JAX package's within 0.5 px, the standard of
``__graft_entry__.py::_rows_match``.
"""

import os.path as osp

import numpy as np
import pytest
import torch

from ctpn_tpu.config import cfg as jcfg
from ctpn_tpu.data.synth import render_image
from ctpn_tpu.inference.pipeline import CTPNPredictor as JaxPredictor
from ctpn_tpu.postprocess import oracle as JO
from ctpn_tpu.utils import host_ref as JH
from ctpn_tpu.utils.weights import load_params as jax_load_params
from ctpn_tpu_torch.config import cfg as tcfg
from ctpn_tpu_torch.config import reset_cfg
from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
from ctpn_tpu_torch.ops import nms_fused
from ctpn_tpu_torch.ops.anchors import shifted_anchors
from ctpn_tpu_torch.postprocess import oracle as TO
from ctpn_tpu_torch.utils import host_ref as TH
from ctpn_tpu_torch.utils.weights import load_params

torch.set_num_threads(2)

ARTIFACT = osp.join(
    osp.dirname(osp.dirname(osp.abspath(__file__))),
    "data", "artifacts", "ctpn_synth_f16.npz",
)


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def _boxes(rng, n):
    xy = rng.uniform(0, 400, (n, 2))
    wh = rng.uniform(4, 120, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_box_oracles_equal(rng):
    boxes, query = _boxes(rng, 300), _boxes(rng, 40)
    dets = np.hstack([boxes, rng.rand(300, 1)]).astype(np.float32)
    deltas = rng.uniform(-0.3, 0.3, (300, 4))
    for name, args in [
        ("bbox_overlaps_np", (boxes, query)),
        ("bbox_intersections_np", (boxes, query)),
        ("bbox_transform_np", (boxes, query[rng.randint(0, 40, 300)])),
        ("bbox_transform_inv_np", (boxes, deltas)),
        ("clip_boxes_np", (boxes, (300, 350))),
        ("py_nms", (dets, 0.7)),
        ("py_nms", (dets, 0.2)),
    ]:
        _equal(getattr(TH, name)(*args), getattr(JH, name)(*args))


def test_proposal_and_anchor_oracles_equal(rng):
    h, w = 12, 18
    anchors = shifted_anchors(h, w)
    prob = rng.rand(h, w, 10).astype(np.float32)
    pred = rng.uniform(-0.3, 0.3, (h, w, 40)).astype(np.float32)
    info = np.array([h * 16 - 10, w * 16 - 20, 1.0], np.float32)
    for kw in ({}, {"pre_nms_top_n": 500, "post_nms_top_n": 60, "nms_thresh": 0.5}):
        _equal(TH.proposal_layer_np(prob, pred, info, anchors, **kw),
               JH.proposal_layer_np(prob, pred, info, anchors, **kw))
    gt = np.hstack([_boxes(rng, 6), np.ones((6, 1))])
    hard = np.array([0, 1, 0, 0, 0, 0])
    dontcare = _boxes(rng, 2)
    _equal(TH.anchor_target_np(anchors, gt, hard, dontcare, info),
           JH.anchor_target_np(anchors, gt, hard, dontcare, info))


def _strip_scene(rng, slope):
    boxes, scores = [], []
    for _ in range(5):
        y, h, x0 = rng.uniform(40, 520), rng.uniform(20, 40), rng.uniform(0, 150)
        for s in range(rng.randint(3, 20)):
            yy = y + slope * s * 16 + rng.uniform(-1.5, 1.5)
            boxes.append([x0 + s * 16, yy, x0 + s * 16 + 15, yy + h])
            scores.append(rng.uniform(0.8, 1.0))
    perm = rng.permutation(len(boxes))
    return np.array(boxes)[perm], np.array(scores)[perm]


@pytest.mark.parametrize("mode,slope", [("H", 0.0), ("O", 0.1), ("O", -0.1)])
def test_connector_oracles_equal(mode, slope):
    boxes, scores = _strip_scene(np.random.RandomState(4), slope)
    size = np.array([600, 900, 1.0])
    graph = TO.build_graph_np(boxes, scores, size)
    _equal(graph, JO.build_graph_np(boxes, scores, size))
    assert TO.sub_graphs_np(graph) == JO.sub_graphs_np(graph)
    lines = f"get_text_lines_{mode.lower()}_np"
    recs = getattr(TO, lines)(boxes, scores, size)
    _equal(recs, getattr(JO, lines)(boxes, scores, size))
    _equal(TO.filter_lines_np(recs), JO.filter_lines_np(recs))
    got = TO.detect_np(boxes, scores, size, mode=mode)
    assert len(got) > 0
    _equal(got, JO.detect_np(boxes, scores, size, mode=mode))


def rows_match(a, b, atol):
    """One-to-one greedy pairing of records within ``atol``."""
    assert a.shape == b.shape, (a.shape, b.shape)
    used = np.zeros(len(b), bool)
    for k, row in enumerate(a):
        d = np.abs(b - row[None, :]).max(axis=1)
        d[used] = np.inf
        j = int(d.argmin())
        assert d[j] <= atol, f"record {k}: closest diff {d[j]:.4f} > {atol}"
        used[j] = True


@pytest.mark.parametrize("mode", ["H", "O"])
def test_detect_image_host_matches_jax(mode):
    """f32 trunk, shipped weights, synth renders at the 192x288 bucket; no
    NMS kernel wrapper is reached on this path."""
    for c in (jcfg, tcfg):
        c.TPU.COMPUTE_DTYPE = "float32"
        c.TPU.BUCKETS = [[192, 288]]
        c.TEXT.SCALE, c.TEXT.MAX_SCALE = 192, 288
        c.TEST.SCALES, c.TEST.MAX_SIZE = (192,), 288
    rng = np.random.RandomState(21)
    images = [render_image(rng, width=432, height=288)[0][..., ::-1].copy()
              for _ in range(2)]
    jax_pred = JaxPredictor(jax_load_params(ARTIFACT), mode=mode)
    pred = CTPNPredictor(load_params(ARTIFACT, device="cpu"), mode=mode, device="cpu")
    calls = []
    real = nms_fused.nms_keep_sorted_fused
    nms_fused.nms_keep_sorted_fused = lambda *a, **k: calls.append(a) or real(*a, **k)
    try:
        total = 0
        for im in images:
            got = pred.detect_image_host(im)
            rows_match(got, jax_pred.detect_image_host(im), 0.5)
            total += len(got)
    finally:
        nms_fused.nms_keep_sorted_fused = real
    assert total > 0 and not calls
