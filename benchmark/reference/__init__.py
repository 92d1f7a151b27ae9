"""The benchmark's plain reference of the CTPN detector.

Imports torch, numpy and PIL only: nothing of the program under test and
nothing of JAX. :class:`Reference` runs the network in float32 with TF32
off (or, as the control, in float8) in blocks of images, and the proposal
layer and the detector in NumPy, on inputs that the benchmark made itself.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from reference import postprocess
from reference.model import ReferenceCTPN, load_weights


@contextlib.contextmanager
def no_tf32():
    """Full-precision float32 matmuls and convolutions on the card."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Reference:
    """The detector of ``config`` (a configuration file's contents) with
    the weights in ``weights_file``, on ``device``. ``quant="fp8"`` is the
    control (``model.py``)."""

    def __init__(self, config: dict, weights_file: str, device="cuda",
                 quant: Optional[str] = None, block: int = 8):
        if config["TEST"].get("TOP_PAD", 0):
            raise ValueError("the reference pads no top band (TEST.TOP_PAD 0)")
        if config["mode"] != "H":
            raise ValueError("the reference connects H-mode lines only")
        self.config = config
        self.device = torch.device(device)
        self.block = block
        self.net = ReferenceCTPN(load_weights(weights_file, self.device),
                                 config["model"], config["pixel_means"], quant=quant)

    def heads(self, images: np.ndarray):
        """(N, H, W, 3) uint8 padded images -> per image (prob, deltas)."""
        out = []
        with torch.inference_mode(), no_tf32():
            for lo in range(0, len(images), self.block):
                x = torch.as_tensor(np.ascontiguousarray(images[lo:lo + self.block]))
                h = self.net.forward(x.to(self.device))
                prob, deltas = h.cls_prob.cpu().numpy(), h.bbox_pred.cpu().numpy()
                out += list(zip(prob, deltas))
        return out

    def detect(self, images: np.ndarray, infos: np.ndarray) -> List[Dict[str, np.ndarray]]:
        """Per padded image: ``props`` (M, 5) proposals and ``recs`` (L, 9)
        lines in the bucket's pixels; ``candidates`` and ``pair_tests`` of
        its proposal NMS and ``line_pair_tests`` of its detector NMS."""
        res = []
        for (prob, deltas), info in zip(self.heads(images), infos):
            props, cand, tests = postprocess.proposals(
                prob, deltas, info, self.config["model"], self.config["TEST"])
            recs = postprocess.text_lines(props, info, self.config["TEXT"])
            res.append({"props": props, "recs": recs, "candidates": cand,
                        "pair_tests": tests,
                        "line_pair_tests": line_pair_tests(props, self.config["TEXT"])})
        return res


def line_pair_tests(props: np.ndarray, text_cfg: dict) -> int:
    """Pair tests of the detector's NMS over ``props``."""
    sc = props[:, 0]
    boxes = props[sc > text_cfg["TEXT_PROPOSALS_MIN_SCORE"], 1:5]
    return postprocess.greedy_nms(boxes, text_cfg["TEXT_PROPOSALS_NMS_THRESH"])[1]
