"""Host-side finishing of line records: trim, line-union pass, unscale
(EAST's quads: trim and unscale, :func:`unscale_quads`).

Shared by every surface that returns records in original image
coordinates: the live predictor, ``stream_detect``, the server and the
frozen artifact's loader. It imports no model code, so the loader of a
frozen artifact can use it without ``ctpn_tpu_torch.models``.
"""

from __future__ import annotations

import numpy as np

from ctpn_tpu_torch.postprocess.merge import maybe_merge_line_records


def unscale_records(
    recs: np.ndarray, count: int, f1: float, info, y_off: float = 0.0
) -> np.ndarray:
    """Trim padded line records, apply the (config-gated) scale-aware
    line-union pass, and map boxes back to ORIGINAL image coords (the
    demo's double-resize contract, `demo.py:47-51`).

    ``y_off`` undoes prep_image's TOP_PAD shift (resized-frame pixels):
    boxes move back up and clip at the true top edge."""
    out = np.asarray(recs)[:count].astype(np.float64)
    return _to_original(maybe_merge_line_records(out), f1, info, y_off)


def unscale_quads(
    recs: np.ndarray, count: int, f1: float, info, y_off: float = 0.0
) -> np.ndarray:
    """EAST's records: trimmed and mapped back to ORIGINAL image coords as
    :func:`unscale_records` maps lines, with no line-union pass."""
    return _to_original(np.asarray(recs)[:count].astype(np.float64), f1, info, y_off)


def _to_original(out: np.ndarray, f1: float, info, y_off: float) -> np.ndarray:
    if y_off and len(out):
        out[:, 1:8:2] = np.maximum(out[:, 1:8:2] - y_off, 0.0)
    total_scale = f1 * float(info[2])
    if len(out):
        out[:, :8] /= total_scale
    return out
