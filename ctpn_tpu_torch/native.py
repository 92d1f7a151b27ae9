"""ctypes bindings for the port's host C++ library (port of ``ctpn_tpu.native``).

The library is ``ops/csrc/host_ops.cpp``, the port's own copy of the JAX
package's ``native/host_ops.cpp``, built at first use by ``ops/_build.py``
with the host C++ compiler into ``ctpn_tpu_torch/_build/``. Dispatcher in
the spirit of the reference's `lib/fast_rcnn/nms_wrapper.py`: the compiled
library is used whenever a C++ compiler is found; the port's numpy oracles
(``utils/host_ref.py``, ``postprocess/oracle.py``) stand in only when there
is none. A compiler that is present but fails raises with its output. The
card path never touches this module.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from ctpn_tpu_torch.ops import _build

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    """The typed library, built if needed; None when no C++ compiler is
    found (a failed build raises)."""
    global _lib
    if _lib is not None:
        return _lib
    if _build.cxx() is None:
        return None
    lib = _build.load("host_ops")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.ctpn_nms.restype = ctypes.c_int
    lib.ctpn_nms.argtypes = [f32p, ctypes.c_int, ctypes.c_float, i32p]
    lib.ctpn_bbox_overlaps.restype = None
    lib.ctpn_bbox_overlaps.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int, f32p]
    lib.ctpn_bbox_intersections.restype = None
    lib.ctpn_bbox_intersections.argtypes = [
        f32p, ctypes.c_int, f32p, ctypes.c_int, f32p,
    ]
    lib.ctpn_build_graph.restype = None
    lib.ctpn_build_graph.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, i32p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    """True when the compiled library is in use (built here if needed)."""
    return _load() is not None


def _boxes(a: np.ndarray, cols: int) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.float32)
    if a.ndim != 2 or a.shape[1] != cols:
        raise ValueError(f"expected an (N, {cols}) array, got shape {a.shape}")
    return a


def nms(dets: np.ndarray, thresh: float) -> List[int]:
    """Greedy NMS over (N, 5) ``[x1, y1, x2, y2, score]`` (reference
    `nms_wrapper.nms` semantics, host side); suppresses at IoU >= thresh."""
    dets = _boxes(dets, 5)
    n = len(dets)
    if n == 0:
        return []
    lib = _load()
    if lib is None:
        from ctpn_tpu_torch.utils.host_ref import py_nms

        return py_nms(dets, thresh)
    # evaluation order: score descending, ties by descending index
    order = dets[:, 4].argsort(kind="stable")[::-1].astype(np.int64)
    ordered = np.ascontiguousarray(dets[order])
    keep = np.zeros(n, np.int32)
    kept = lib.ctpn_nms(ordered, n, thresh, keep)
    return [int(order[k]) for k in keep[:kept]]


def bbox_overlaps(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """(N, K) IoU of ``boxes`` (N, 4) against ``query`` (K, 4), float32."""
    boxes, query = _boxes(boxes, 4), _boxes(query, 4)
    lib = _load()
    if lib is None:
        from ctpn_tpu_torch.utils.host_ref import bbox_overlaps_np

        return bbox_overlaps_np(boxes, query).astype(np.float32)
    out = np.zeros((len(boxes), len(query)), np.float32)
    lib.ctpn_bbox_overlaps(boxes, len(boxes), query, len(query), out)
    return out


def bbox_intersections(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """(N, K) intersection over the query box's area, float32."""
    boxes, query = _boxes(boxes, 4), _boxes(query, 4)
    lib = _load()
    if lib is None:
        from ctpn_tpu_torch.utils.host_ref import bbox_intersections_np

        return bbox_intersections_np(boxes, query).astype(np.float32)
    out = np.zeros((len(boxes), len(query)), np.float32)
    lib.ctpn_bbox_intersections(boxes, len(boxes), query, len(query), out)
    return out


def build_graph_successors(
    boxes: np.ndarray,
    scores: np.ndarray,
    im_w: int,
    max_gap: int = 50,
    min_v_overlaps: float = 0.7,
    min_size_sim: float = 0.7,
) -> np.ndarray:
    """(N,) successor indices (-1 = none) of the text-proposal graph."""
    boxes = _boxes(boxes, 4)
    scores = np.ascontiguousarray(scores, np.float32)
    n = len(boxes)
    if scores.shape != (n,):
        raise ValueError(f"expected ({n},) scores, got shape {scores.shape}")
    succ = np.full(n, -1, np.int32)
    if n == 0:
        return succ
    lib = _load()
    if lib is None:
        from ctpn_tpu_torch.postprocess.oracle import build_graph_np

        g = build_graph_np(boxes.astype(np.float64), scores, (0, im_w))
        for i in range(n):
            js = np.flatnonzero(g[i])
            if len(js):
                succ[i] = js[0]
        return succ
    lib.ctpn_build_graph(
        boxes, scores, n, int(im_w), int(max_gap),
        float(min_v_overlaps), float(min_size_sim), succ,
    )
    return succ
