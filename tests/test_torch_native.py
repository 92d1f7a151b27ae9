"""The port's native host ops (``ctpn_tpu_torch/native.py`` over
``ops/csrc/host_ops.cpp``) against the port's numpy oracles and against
the JAX package's ``ctpn_tpu.native`` and oracles, on the cases of
``tests/test_native.py``.

NMS keep lists and graph successors must be identical; overlaps and
intersections within 1e-6 absolute. The library is built here by the host
C++ compiler at first use; without a compiler the port uses its oracles,
and a compiler that fails raises.
"""

import numpy as np
import pytest
import torch

from ctpn_tpu import native as jax_native
from ctpn_tpu.postprocess import oracle as jax_oracle
from ctpn_tpu.utils import host_ref as jax_host_ref
from ctpn_tpu_torch import native
from ctpn_tpu_torch.ops import _build
from ctpn_tpu_torch.postprocess import oracle as O
from ctpn_tpu_torch.utils import host_ref as H
from tests.conftest import random_boxes
from tests.test_connector import make_strip_scene

torch.set_num_threads(2)

ATOL = 1e-6
GRAPH_SEEDS = (0, 1, 2)  # tests/test_native.py::test_native_graph_matches_oracle


def _nms_dets(rng):
    boxes = random_boxes(rng, 200, max_wh=80)
    scores = rng.uniform(0, 1, 200).astype(np.float32)
    return np.hstack([boxes, scores[:, None]]).astype(np.float32)


def _graph_from_succ(succ, n):
    got = np.zeros((n, n), bool)
    for i, j in enumerate(succ):
        if j >= 0:
            got[i, j] = True
    return got


@pytest.fixture(scope="module")
def built():
    """The compiled library (this machine has a C++ compiler)."""
    assert native.available(), "no host C++ compiler found"


@pytest.mark.parametrize("thresh", [0.3, 0.7])
def test_nms_matches_oracle(built, rng, thresh):
    dets = _nms_dets(rng)
    assert native.nms(dets, thresh) == H.py_nms(dets, thresh)


def test_nms_tie_order():
    """Equal scores: descending index first (the oracle's ``argsort()[::-1]``)."""
    dets = np.array([[0, 0, 10, 10, 0.5], [0, 0, 10, 10, 0.5],
                     [40, 40, 50, 50, 0.9]], np.float32)
    assert native.nms(dets, 0.5) == H.py_nms(dets, 0.5) == [2, 1]
    assert native.nms(np.zeros((0, 5), np.float32), 0.5) == []


def test_overlaps_match_oracle(built, rng):
    b = random_boxes(rng, 50)
    q = random_boxes(rng, 31)
    np.testing.assert_allclose(native.bbox_overlaps(b, q),
                               H.bbox_overlaps_np(b, q), rtol=0, atol=ATOL)
    np.testing.assert_allclose(native.bbox_intersections(b, q),
                               H.bbox_intersections_np(b, q), rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", GRAPH_SEEDS)
def test_graph_matches_oracle(built, seed):
    boxes, scores = make_strip_scene(np.random.RandomState(seed))
    want = O.build_graph_np(boxes.astype(np.float64), scores, (600, 900))
    succ = native.build_graph_successors(boxes, scores, 900)
    assert succ.dtype == np.int32 and succ.min() >= -1
    np.testing.assert_array_equal(_graph_from_succ(succ, len(boxes)), want)


@pytest.mark.parametrize("seed", GRAPH_SEEDS)
def test_matches_jax_package(built, seed):
    """The port's ops against the JAX package's oracles and, where its
    library is built, its compiled ops, on the same inputs."""
    rng = np.random.RandomState(seed)
    dets = _nms_dets(rng)
    b, q = random_boxes(rng, 50), random_boxes(rng, 31)
    boxes, scores = make_strip_scene(rng)
    keep = native.nms(dets, 0.7)
    ov = native.bbox_overlaps(b, q)
    inter = native.bbox_intersections(b, q)
    succ = native.build_graph_successors(boxes, scores, 900)

    assert keep == jax_host_ref.py_nms(dets, 0.7)
    np.testing.assert_allclose(ov, jax_host_ref.bbox_overlaps_np(b, q), rtol=0, atol=ATOL)
    np.testing.assert_allclose(inter, jax_host_ref.bbox_intersections_np(b, q),
                               rtol=0, atol=ATOL)
    want = jax_oracle.build_graph_np(boxes.astype(np.float64), scores, (600, 900))
    np.testing.assert_array_equal(_graph_from_succ(succ, len(boxes)), want)
    if not jax_native.available():
        pytest.skip("native/libctpn_host.so not built: JAX's compiled side left out")
    assert keep == jax_native.nms(dets, 0.7)
    np.testing.assert_allclose(ov, jax_native.bbox_overlaps(b, q), rtol=0, atol=ATOL)
    np.testing.assert_allclose(inter, jax_native.bbox_intersections(b, q),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        succ, jax_native.build_graph_successors(boxes, scores, 900))


def test_oracles_without_a_compiler(rng, monkeypatch):
    """No C++ compiler: every function answers from the numpy oracles."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "cxx", lambda: None)
    assert not native.available()
    dets = _nms_dets(rng)
    assert native.nms(dets, 0.5) == H.py_nms(dets, 0.5)
    b, q = random_boxes(rng, 20), random_boxes(rng, 7)
    np.testing.assert_array_equal(native.bbox_overlaps(b, q),
                                  H.bbox_overlaps_np(b, q).astype(np.float32))
    boxes, scores = make_strip_scene(np.random.RandomState(0))
    want = O.build_graph_np(boxes.astype(np.float64), scores, (600, 900))
    np.testing.assert_array_equal(
        _graph_from_succ(native.build_graph_successors(boxes, scores, 900),
                         len(boxes)), want)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that is present but fails raises with its output; no
    quiet fallback to the oracles."""
    (tmp_path / "host_ops.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="compiler failed for host_ops"):
        native.available()


def test_build_flags_keep_operations_apart():
    """No FMA contraction and no -march=native in the host build."""
    flags = _build._flags("host_ops")
    assert "-ffp-contract=off" in flags
    assert not any(f.startswith("-march") for f in flags)


def test_rejects_malformed_input():
    with pytest.raises(ValueError, match=r"\(N, 5\)"):
        native.nms(np.zeros((3, 4), np.float32), 0.5)
    with pytest.raises(ValueError, match="scores"):
        native.build_graph_successors(np.zeros((3, 4), np.float32),
                                      np.zeros(2, np.float32), 900)


def test_chip_smoke_cases_are_the_tests_cases():
    """``chip_smoke.py`` checks the library on the card machine with its
    own copies of the generators: they give these tests' inputs."""
    import chip_smoke

    for seed in (3, *GRAPH_SEEDS):
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        np.testing.assert_array_equal(chip_smoke.random_boxes(a, 50, max_wh=80),
                                      random_boxes(b, 50, max_wh=80))
        np.testing.assert_array_equal(a.uniform(0, 1, 4), b.uniform(0, 1, 4))
        for x, y in zip(chip_smoke.strip_scene(a), make_strip_scene(b)):
            np.testing.assert_array_equal(x, y)
