"""Text detector: proposals -> text-line records (port of
``ctpn_tpu.postprocess.detector``), batched over images.

The reference's `TextDetector.detect` (`lib/text_connector/detectors.py:19-35`):
score filter (> 0.7), NMS at 0.2 over the score-sorted proposals, the
connector, the final line filter. Everything is fixed-shape and masked.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.ops.nms import nms_keep_sorted
from ctpn_tpu_torch.postprocess.connector import TextLines, connect_text_lines


def detect_lines(
    rois: torch.Tensor,
    roi_valid: torch.Tensor,
    im_info: torch.Tensor,
    mode: str = "H",
    max_lines: int = 128,
    min_score: float = 0.7,
    nms_thresh: float = 0.2,
    max_gap: int = 50,
    min_v_overlaps: float = 0.7,
    min_size_sim: float = 0.7,
    min_ratio: float = 0.5,
    line_min_score: float = 0.9,
    min_width: float = 32.0,
    max_chain_len: Optional[int] = None,
) -> TextLines:
    """(N, P, 5) [score, x1, y1, x2, y2] score-sorted rois -> lines.

    ``rois`` must be sorted by score descending per image (the proposal
    layer's output contract); padding slots carry score -1 and
    ``roi_valid`` False.
    """
    scores = rois[..., 0]
    boxes = rois[..., 1:5].contiguous()
    valid = roi_valid & (scores > min_score)
    keep = nms_keep_sorted(boxes, valid, nms_thresh)
    return connect_text_lines(
        boxes,
        scores,
        keep,
        im_info,
        mode=mode,
        max_lines=max_lines,
        max_gap=max_gap,
        min_v_overlaps=min_v_overlaps,
        min_size_sim=min_size_sim,
        min_ratio=min_ratio,
        line_min_score=line_min_score,
        min_width=min_width,
        max_chain_len=max_chain_len,
    )


class TextDetector:
    """Config-driven facade mirroring the reference class.

    Reads mode and thresholds from the cfg at construction
    (`detectors.py:11-16` + `text_connect_cfg.py`); ``detect(rois, valid,
    im_info)`` takes one image's (P, 5) rois, (P,) valid flags and (3,)
    im_info (arrays or tensors, on any one device) and returns the trimmed
    (M, 9) records as a numpy array.
    """

    def __init__(self, mode: Optional[str] = None):
        self.mode = mode or cfg.TEST.DETECT_MODE
        t = cfg.TEXT
        self._kw = dict(
            mode=self.mode,
            max_lines=cfg.TPU.MAX_LINES,
            min_score=t.TEXT_PROPOSALS_MIN_SCORE,
            nms_thresh=t.TEXT_PROPOSALS_NMS_THRESH,
            max_gap=t.MAX_HORIZONTAL_GAP,
            min_v_overlaps=t.MIN_V_OVERLAPS,
            min_size_sim=t.MIN_SIZE_SIM,
            min_ratio=t.MIN_RATIO,
            line_min_score=t.LINE_MIN_SCORE,
            min_width=float(t.TEXT_PROPOSALS_WIDTH * t.MIN_NUM_PROPOSALS),
        )

    def detect(self, rois, roi_valid, im_info) -> np.ndarray:
        rois = torch.as_tensor(rois, dtype=torch.float32)
        out = detect_lines(
            rois[None],
            torch.as_tensor(roi_valid, dtype=torch.bool, device=rois.device)[None],
            torch.as_tensor(im_info, dtype=torch.float32, device=rois.device)[None],
            **self._kw,
        )
        return out.recs[0, :int(out.count[0])].cpu().numpy()
