"""End-to-end inference: padded image batch -> text-line records (port of
``ctpn_tpu.inference.pipeline``).

One batched pass per padded bucket: mean-subtract (on the device) -> VGG16
-> BiLSTM -> heads -> proposal decode (fused NMS kernel) -> NMS 0.2 ->
H-mode connector. Only the final padded line records go back to the host,
where ``unscale_records`` trims them, applies the line-union pass and maps
them to original image coordinates.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.models.ctpn import CTPN, CTPNOutputs
from ctpn_tpu_torch.ops.proposal import Proposals, proposal_layer
from ctpn_tpu_torch.postprocess.connector import TextLines
from ctpn_tpu_torch.postprocess.detector import detect_lines
from ctpn_tpu_torch.postprocess.merge import maybe_merge_line_records
from ctpn_tpu_torch.utils.device import resolve_device
from ctpn_tpu_torch.utils.image import load_image_bgr, prep_image, resize_im
from ctpn_tpu_torch.utils.weights import params_from_jax


def unscale_records(
    recs: np.ndarray, count: int, f1: float, info, y_off: float = 0.0
) -> np.ndarray:
    """Trim padded line records, apply the (config-gated) scale-aware
    line-union pass, and map boxes back to ORIGINAL image coords (the
    demo's double-resize contract, `demo.py:47-51`).

    ``y_off`` undoes prep_image's TOP_PAD shift (resized-frame pixels):
    boxes move back up and clip at the true top edge."""
    out = np.asarray(recs)[:count].astype(np.float64)
    out = maybe_merge_line_records(out)
    if y_off and len(out):
        out[:, 1:8:2] = np.maximum(out[:, 1:8:2] - y_off, 0.0)
    total_scale = f1 * float(info[2])
    if len(out):
        out[:, :8] /= total_scale
    return out


def forward_features(model: CTPN, images: torch.Tensor) -> CTPNOutputs:
    """Mean-subtract on the model's device, then the model forward.

    ``images``: (N, H, W, 3) uint8 (the wire format) or float32, BGR.
    """
    means = torch.tensor(cfg.PIXEL_MEANS, dtype=torch.float32, device=images.device)
    return model(images.float() - means)


def proposal_kwargs(
    pre_nms_top_n: Optional[int] = None, post_nms_top_n: Optional[int] = None
) -> Dict[str, Any]:
    """``proposal_layer`` settings from the cfg (TEST parity settings)."""
    return dict(
        pre_nms_top_n=pre_nms_top_n or cfg.TEST.RPN_PRE_NMS_TOP_N,
        post_nms_top_n=post_nms_top_n or cfg.TEST.RPN_POST_NMS_TOP_N,
        nms_thresh=cfg.TEST.RPN_NMS_THRESH,
        min_size=cfg.TEST.RPN_MIN_SIZE,
    )


def lines_kwargs(mode: str = "H", max_lines: Optional[int] = None) -> Dict[str, Any]:
    """``detect_lines`` settings from the cfg (TEXT connector constants)."""
    if mode != "H":
        raise NotImplementedError(
            f"detect mode {mode!r}: only 'H' is ported (O mode is ROADMAP A7)"
        )
    t = cfg.TEXT
    return dict(
        mode=mode,
        max_lines=max_lines or cfg.TPU.MAX_LINES,
        min_score=t.TEXT_PROPOSALS_MIN_SCORE,
        nms_thresh=t.TEXT_PROPOSALS_NMS_THRESH,
        max_gap=t.MAX_HORIZONTAL_GAP,
        min_v_overlaps=t.MIN_V_OVERLAPS,
        min_size_sim=t.MIN_SIZE_SIM,
        min_ratio=t.MIN_RATIO,
        line_min_score=t.LINE_MIN_SCORE,
        min_width=float(t.TEXT_PROPOSALS_WIDTH * t.MIN_NUM_PROPOSALS),
    )


def build_detect_fn(
    model: CTPN,
    mode: str = "H",
    pre_nms_top_n: Optional[int] = None,
    post_nms_top_n: Optional[int] = None,
    max_lines: Optional[int] = None,
    on_stage: Optional[Callable[[str], None]] = None,
) -> Callable[[torch.Tensor, torch.Tensor], Tuple[Proposals, TextLines]]:
    """Returns fn(images, im_info) -> (Proposals, TextLines), batched.

    ``images``: (N, bh, bw, 3) uint8 or float32 BGR (not mean-subtracted),
    ``im_info``: (N, 3), both on the model's device. ``on_stage(name)``,
    if given, is called after each stage ("forward", "proposal_layer",
    "detect_lines"), e.g. to record a CUDA event there.
    """
    props_kw = proposal_kwargs(pre_nms_top_n, post_nms_top_n)
    lines_kw = lines_kwargs(mode, max_lines)
    mark = on_stage or (lambda name: None)

    @torch.inference_mode()
    def detect(images: torch.Tensor, im_info: torch.Tensor):
        outs = forward_features(model, images)
        mark("forward")
        props = proposal_layer(outs.cls_prob, outs.bbox_pred, im_info, **props_kw)
        mark("proposal_layer")
        # chains advance >= 1 column per edge: the bucket's 16-px column
        # count bounds path length (fewer closure squarings)
        lines = detect_lines(
            props.rois, props.valid, im_info,
            max_chain_len=outs.cls_prob.shape[2], **lines_kw,
        )
        mark("detect_lines")
        return props, lines

    return detect


class CTPNPredictor:
    """Model + weights + the detect function, on one device.

    ``params`` is a JAX-layout parameter tree (the flat dict of
    ``utils.weights.load_params`` or a nested flax tree); it is loaded into
    ``model`` (default: ``get_network("VGGnet_test")`` from the cfg).
    Runs on CUDA unless ``device`` says otherwise; without CUDA it raises.
    """

    def __init__(
        self,
        params: Mapping[str, Any],
        model: Optional[CTPN] = None,
        mode: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        from ctpn_tpu_torch.models.factory import get_network

        self.device = resolve_device(device)
        self.model = (model or get_network("VGGnet_test", self.device)).to(self.device)
        self.model.load_state_dict(params_from_jax(params))
        self.model.eval()
        self.mode = mode or cfg.TEST.DETECT_MODE
        self._detect = build_detect_fn(self.model, mode=self.mode)

    def run_batch(self, images: np.ndarray, im_info: np.ndarray):
        """(N, bh, bw, 3) uint8/float32 batch -> (Proposals, TextLines) on
        the device."""
        x = torch.as_tensor(np.ascontiguousarray(images)).to(self.device)
        info = torch.as_tensor(np.asarray(im_info, np.float32)).to(self.device)
        return self._detect(x, info)

    def run_padded(self, images, infos, batch_size: int):
        """Run a possibly-partial batch padded to ``batch_size`` (callers
        slice outputs by the true item count; padded rows are garbage)."""
        pad = batch_size - len(images)
        stacked = np.stack(list(images) + [images[0]] * pad)
        stacked_i = np.stack(list(infos) + [infos[0]] * pad)
        return self.run_batch(stacked, stacked_i)

    def detect_image(self, im_bgr: np.ndarray) -> np.ndarray:
        """One uint8 BGR image -> (M, 9) line records in ORIGINAL image
        coords, through the demo's double resize (`demo.py:59-60` then
        `test.py:18-24`)."""
        resized, f1 = resize_im(im_bgr, cfg.TEXT.SCALE, cfg.TEXT.MAX_SCALE)
        data, info, pad = prep_image(resized)
        _, lines = self.run_batch(data[None], info[None])
        return unscale_records(
            lines.recs[0].cpu().numpy(), int(lines.count[0]), f1, info,
            y_off=pad,
        )

    def detect_path(self, path: str) -> np.ndarray:
        return self.detect_image(load_image_bgr(path))

    def warmup(self, bucket: Optional[Tuple[int, int]] = None, batch: int = 1):
        """Run once on a gray dummy batch (reference `demo.py:95-97`):
        builds the kernels and lets cuDNN pick its algorithms."""
        bh, bw = bucket or tuple(cfg.TPU.BUCKETS[0])
        img = np.full((batch, bh, bw, 3), 128, np.uint8)
        info = np.tile(np.array([bh, bw, 1.0], np.float32), (batch, 1))
        _, lines = self.run_batch(img, info)
        lines.count.cpu()
