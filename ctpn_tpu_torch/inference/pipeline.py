"""End-to-end inference: padded image batch -> text-line records (port of
``ctpn_tpu.inference.pipeline``).

One batched pass per padded bucket: mean-subtract (on the device) -> VGG16
-> BiLSTM -> heads -> proposal decode (fused NMS kernel) -> NMS 0.2 ->
connector (H or O mode). Only the final padded line records go back to the
host, where ``unscale_records`` trims them, applies the line-union pass and
maps them to original image coordinates. The same program
(:func:`detect_program`) is what ``inference/frozen.py`` exports. On the
card ``CTPNPredictor`` captures it once per shape as a CUDA graph and
replays it (``inference/graphs.py``, the counterpart of the JAX package's
program per bucket); on the CPU it runs eagerly.

``CTPNPredictor.detect_image_host`` is the other split, the reference's
``demo_pb.py``: the card runs the network only, and the proposal decode and
the connector run on the host (``utils/host_ref.py``,
``postprocess/oracle.py``).

With ``cfg.NET_NAME`` ``EAST_VGG16`` the predictor is an
:class:`EASTPredictor`, which runs EAST (``models/east.py``) through
:func:`east_program` instead: mean subtract,
the trunk's taps, the merge branch and heads, then the post-process of
``postprocess/east.py`` (threshold, raster compaction, RBOX restore, the
locality-aware walk, quad NMS), all on the card in the captured program; it
answers with ``(EastQuads, EastRecords)`` in place of ``(Proposals,
TextLines)``, and the host only unscales the quads (no line-union pass).

With ``cfg.NET_NAME`` ``CRAFT_VGG16_BN`` it is a :class:`CRAFTPredictor`,
which runs CRAFT (``models/craft.py``) through :func:`craft_program`: the
normalisation, the trunk's taps, the decoder, then the connected
components and the boxes of ``postprocess/craft.py``, all on the card in
the captured program; it answers with ``(CraftText, CraftRecords)``, and
the host resizes by CRAFT's rule and unscales the boxes.

With ``cfg.NET_NAME`` ``DB_RESNET50_DCN`` it is a :class:`DBPredictor`,
which runs DBNet (``models/dbnet.py``) through :func:`db_program`: the
normalisation, the deformable trunk, the neck and the binarize head, then
the components and the scored, unclipped boxes of ``postprocess/db.py``,
all on the card in the captured program; it answers with ``(DBText,
DBRecords)``, whose records are in the original image's pixels already,
and the host resizes by DB's rule.

Each predictor's host calls are spans of its ``span_prefix``
(``<prefix>.pad``, ``.run``, ``.fetch``, ``.unscale``): none for CTPN's,
whose padding is ``predict.pad``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.inference.graphs import DetectGraphs
from ctpn_tpu_torch.inference.records import unscale_quads, unscale_records
from ctpn_tpu_torch.models.craft import CRAFT
from ctpn_tpu_torch.models.ctpn import CTPN, CTPNOutputs
from ctpn_tpu_torch.models.dbnet import DBNet
from ctpn_tpu_torch.models.east import EAST
from ctpn_tpu_torch.ops.proposal import Proposals, proposal_layer
from ctpn_tpu_torch.postprocess.connector import TextLines
from ctpn_tpu_torch.postprocess.detector import detect_lines
from ctpn_tpu_torch.postprocess.craft import (CraftRecords, CraftText, craft_kwargs,
                                              craft_postprocess)
from ctpn_tpu_torch.postprocess.db import DBRecords, DBText, db_kwargs, db_postprocess
from ctpn_tpu_torch.postprocess.east import EastQuads, EastRecords, east_kwargs, east_postprocess
from ctpn_tpu_torch.utils import timer
from ctpn_tpu_torch.utils.device import device_constant, resolve_device
from ctpn_tpu_torch.utils.image import (craft_resize_factor, db_resize_size, load_image_bgr,
                                        prep_image, resize_by_factor, resize_im, resize_to)
from ctpn_tpu_torch.utils.weights import params_from_jax


def mean_subtracted(images: torch.Tensor) -> torch.Tensor:
    """``images`` (N, H, W, 3) uint8 or float32 BGR minus the pixel means,
    float32, on their device."""
    pixel = tuple(float(m) for m in cfg.PIXEL_MEANS)
    means = device_constant(("pixel_means", pixel), images.device,
                            lambda: np.asarray(pixel, np.float32))
    return images.float() - means


def forward_features(
    model: Callable[[torch.Tensor], CTPNOutputs], images: torch.Tensor
) -> CTPNOutputs:
    """Mean-subtract on the model's device, then the model forward.

    ``images``: (N, H, W, 3) uint8 (the wire format) or float32, BGR.
    ``model`` is a ``CTPN`` or any callable with its forward's contract.
    """
    return model(mean_subtracted(images))


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
    """``detect_lines`` settings from the cfg (TEXT connector constants):
    CTPN's connector, whose modes are H and O."""
    if mode not in ("H", "O"):
        raise ValueError(f"CTPN's detect mode must be 'H' or 'O', got {mode!r}")
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


def detect_program(
    model: Callable[[torch.Tensor], CTPNOutputs],
    images: torch.Tensor,
    im_info: torch.Tensor,
    props_kw: Mapping[str, Any],
    lines_kw: Mapping[str, Any],
    on_stage: Optional[Callable[[str], None]] = None,
) -> Tuple[Proposals, TextLines]:
    """The detect program: mean subtract, forward, proposals, lines.

    Plain tensor code and the kernels' ops, with no host sync and no
    tensor made from host data (the constants stay on the device,
    ``utils/device.py::device_constant``), so that ``torch.export`` can
    trace it (``inference/frozen.py``) and a CUDA graph can capture it
    (``inference/graphs.py``).
    """
    mark = on_stage or (lambda name: None)
    outs = forward_features(model, images)
    mark("forward")
    props = proposal_layer(outs.cls_prob, outs.bbox_pred, im_info, **props_kw)
    mark("proposal_layer")
    # chains advance >= 1 column per edge: the bucket's 16-px column
    # count bounds path length (a shorter chain walk)
    lines = detect_lines(
        props.rois, props.valid, im_info,
        max_chain_len=outs.cls_prob.shape[2], **lines_kw,
    )
    mark("detect_lines")
    return props, lines


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

    @torch.inference_mode()
    def detect(images: torch.Tensor, im_info: torch.Tensor):
        return detect_program(model, images, im_info, props_kw, lines_kw, on_stage)

    return detect


def east_program(
    model: EAST,
    images: torch.Tensor,
    im_info: torch.Tensor,
    kw: Mapping[str, Any],
    on_stage: Optional[Callable[[str], None]] = None,
) -> Tuple[EastQuads, EastRecords]:
    """EAST's detect program: mean subtract, the trunk's taps (``trunk``),
    the merge branch and heads (``merge``), then ``decode``, ``lanms`` and
    ``quad_nms`` (``postprocess/east.py``); ``on_stage`` is called after
    each. Like :func:`detect_program`, no host sync: a CUDA graph captures
    all of it."""
    mark = on_stage or (lambda name: None)
    taps = model.trunk_taps(mean_subtracted(images))
    mark("trunk")
    outs = model.head(model.merge(taps))
    mark("merge")
    return east_postprocess(outs, im_info, kw, mark)


def build_east_detect_fn(
    model: EAST, on_stage: Optional[Callable[[str], None]] = None
) -> Callable[[torch.Tensor, torch.Tensor], Tuple[EastQuads, EastRecords]]:
    """Returns fn(images, im_info) -> (EastQuads, EastRecords), batched,
    with the cfg's thresholds and caps (``east_kwargs``)."""
    kw = east_kwargs()

    @torch.inference_mode()
    def detect(images: torch.Tensor, im_info: torch.Tensor):
        return east_program(model, images, im_info, kw, on_stage)

    return detect


def craft_normalised(images: torch.Tensor) -> torch.Tensor:
    """``images`` (N, H, W, 3) uint8 or float32 BGR in the network's
    channel order (``cfg.CHANNEL_ORDER``), minus ``cfg.PIXEL_MEANS`` and
    over ``cfg.PIXEL_STDS`` (both in that order), float32, on their device."""
    order = str(cfg.CHANNEL_ORDER)
    if order not in ("BGR", "RGB"):
        raise ValueError(f"cfg.CHANNEL_ORDER must be 'BGR' or 'RGB', got {order!r}")
    pixel = tuple(float(m) for m in cfg.PIXEL_MEANS)
    stds = tuple(float(m) for m in cfg.PIXEL_STDS)
    means = device_constant(("pixel_means", pixel), images.device,
                            lambda: np.asarray(pixel, np.float32))
    x = images.float()
    if order == "RGB":
        x = x.flip(-1)
    x = x - means
    if stds != (1.0, 1.0, 1.0):
        x = x / device_constant(("pixel_stds", stds), images.device,
                                lambda: np.asarray(stds, np.float32))
    return x


def craft_program(
    model: CRAFT,
    images: torch.Tensor,
    im_info: torch.Tensor,
    kw: Mapping[str, Any],
    on_stage: Optional[Callable[[str], None]] = None,
) -> Tuple[CraftText, CraftRecords]:
    """CRAFT's detect program: the normalisation and the trunk's taps
    (``trunk``), slice5, the decoder and the heads (``decoder``), then
    ``label`` and ``boxes`` (``postprocess/craft.py``); ``on_stage`` is
    called after each. Like :func:`detect_program`, no host sync: a CUDA
    graph captures all of it."""
    mark = on_stage or (lambda name: None)
    taps = model.trunk_taps(craft_normalised(images))
    mark("trunk")
    maps = model.maps(taps)
    mark("decoder")
    return craft_postprocess(maps, im_info, kw, mark)


def build_craft_detect_fn(
    model: CRAFT, on_stage: Optional[Callable[[str], None]] = None
) -> Callable[[torch.Tensor, torch.Tensor], Tuple[CraftText, CraftRecords]]:
    """Returns fn(images, im_info) -> (CraftText, CraftRecords), batched,
    with the cfg's thresholds and cap (``craft_kwargs``)."""
    kw = craft_kwargs()

    @torch.inference_mode()
    def detect(images: torch.Tensor, im_info: torch.Tensor):
        return craft_program(model, images, im_info, kw, on_stage)

    return detect


def db_program(
    model: DBNet,
    images: torch.Tensor,
    im_info: torch.Tensor,
    kw: Mapping[str, Any],
    on_stage: Optional[Callable[[str], None]] = None,
) -> Tuple[DBText, DBRecords]:
    """DB's detect program: the normalisation and the trunk (``trunk``,
    after a stamp before and after each deformable site), the FPN
    (``neck``, after its children ``neck.lateral``, ``neck.topdown``,
    ``neck.smooth`` and ``neck.fuse``), the binarize head (``head``, after
    ``head.conv`` and ``head.map``), then ``label`` and ``boxes``
    (``postprocess/db.py``); ``on_stage`` is called at each. Like
    :func:`detect_program`, no host sync: a CUDA graph captures all of it.
    ``im_info`` (N, 4): each image's resized rows and columns, then its
    original rows and columns."""
    mark = on_stage or (lambda name: None)
    feats = model.trunk(craft_normalised(images), mark)
    mark("trunk")
    fuse = model.neck(feats, mark)
    mark("neck")
    prob = model.head(fuse, mark)
    mark("head")
    return db_postprocess(prob, im_info, kw, mark)


def build_db_detect_fn(
    model: DBNet, on_stage: Optional[Callable[[str], None]] = None
) -> Callable[[torch.Tensor, torch.Tensor], Tuple[DBText, DBRecords]]:
    """Returns fn(images, im_info) -> (DBText, DBRecords), batched, with
    the cfg's thresholds and cap (``db_kwargs``)."""
    kw = db_kwargs()

    @torch.inference_mode()
    def detect(images: torch.Tensor, im_info: torch.Tensor):
        return db_program(model, images, im_info, kw, on_stage)

    return detect


def _stamped(clock, detect):
    """``detect`` behind the stage clock's ``start`` stamp."""

    def program(images: torch.Tensor, im_info: torch.Tensor):
        clock.stamp("start")
        return detect(images, im_info)

    return program


class CTPNPredictor:
    """Model + weights + the detect function, on one device.

    ``params`` is a JAX-layout parameter tree (the flat dict of
    ``utils.weights.load_params`` or a nested flax tree); it is loaded into
    ``model`` (default: ``get_network("VGGnet_test")`` from the cfg).
    Runs on CUDA unless ``device`` says otherwise; without CUDA it raises.
    ``CTPNPredictor(...)`` gives an :class:`EASTPredictor` instead when
    ``cfg.NET_NAME`` is ``EAST_VGG16`` or ``model`` is an ``EAST``, a
    :class:`CRAFTPredictor` for CRAFT and a :class:`DBPredictor` for DBNet.

    ``buckets_run`` records, in first-run order, each (height, width)
    bucket that ``run_batch`` has run: the server reports it where the JAX
    package reports its compiled programs. ``program`` is the eager detect
    program (:func:`build_detect_fn`, on tensors on the device);
    ``graphs`` captures it (``inference/graphs.py``): one program per
    (batch, bucket, input dtype, mode, ``TPU.NMS_FUSED``) on the card,
    none on the CPU. With tracing on as the predictor is built
    (``utils/timer.py``), ``clock`` is a :class:`~ctpn_tpu_torch.utils.timer.StageClock`
    that the program stamps at its start and after each stage, so each
    run, a replay of the captured graph included, writes a row; else
    ``clock`` is None and the program is the plain one.
    """

    stages = timer.STAGES  # the stage clock's stages
    # the host calls' spans: ``<prefix>.pad``, ``.run``, ``.fetch`` and
    # ``.unscale``; None: CTPN's, whose padding alone is a span
    span_prefix: Optional[str] = None

    def __new__(cls, params=None, model=None, mode=None, device="cuda"):
        from ctpn_tpu_torch.models.factory import CRAFT_NAMES, DB_NAMES, EAST_NAMES

        if cls is CTPNPredictor and (
                isinstance(model, EAST) or (model is None and cfg.NET_NAME in EAST_NAMES)):
            cls = EASTPredictor
        elif cls is CTPNPredictor and (
                isinstance(model, CRAFT) or (model is None and cfg.NET_NAME in CRAFT_NAMES)):
            cls = CRAFTPredictor
        elif cls is CTPNPredictor and (
                isinstance(model, DBNet) or (model is None and cfg.NET_NAME in DB_NAMES)):
            cls = DBPredictor
        return super().__new__(cls)

    @property
    def pad_span(self) -> str:
        return f"{self.span_prefix}.pad" if self.span_prefix else "predict.pad"

    def _span(self, step: str):
        """The span ``<prefix>.<step>`` of a host call; none without a prefix."""
        if self.span_prefix is None:
            return contextlib.nullcontext()
        return timer.span(f"{self.span_prefix}.{step}")

    def __init__(
        self,
        params: Mapping[str, Any],
        model: Optional[torch.nn.Module] = None,
        mode: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.model = (model or self._network()).to(self.device)
        self.model.load_state_dict(self._state(params))
        self.model.eval()
        self.mode = mode or cfg.TEST.DETECT_MODE
        self.clock = timer.StageClock(self.device, self.stages) if timer.enabled() else None
        if self.clock is None:
            self.program = self._build()
        else:
            self.program = _stamped(self.clock, self._build(on_stage=self.clock.stamp))
        self.graphs = DetectGraphs(self.program, self.device, variant=self._variant())
        self.buckets_run: Dict[Tuple[int, int], None] = {}

    def _network(self) -> torch.nn.Module:
        from ctpn_tpu_torch.models.factory import get_network

        return get_network("VGGnet_test", self.device)

    def _state(self, params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        return params_from_jax(params)

    def _build(self, on_stage: Optional[Callable[[str], None]] = None):
        return build_detect_fn(self.model, mode=self.mode, on_stage=on_stage)

    def _variant(self) -> Callable[[], Tuple]:
        mode = self.mode  # (not self: no reference cycle holds the graphs)
        return lambda: (mode, bool(cfg.TPU.NMS_FUSED))

    def run_batch(self, images: np.ndarray, im_info: np.ndarray):
        """Run the batched program on host arrays (``graphs``: on the card the
        first call of a shape runs it and captures it); returns once the
        work is queued, with no host sync: callers fetch with ``.cpu()``."""
        with self._span("run"):
            self.buckets_run.setdefault(tuple(int(d) for d in images.shape[1:3]))
            return self.graphs(np.ascontiguousarray(images),
                               np.asarray(im_info, np.float32))

    def run_padded(self, images, infos, batch_size: int):
        """Run a possibly-partial batch padded to ``batch_size`` (callers
        slice outputs by the true item count; padded rows are garbage)."""
        pad = batch_size - len(images)
        with timer.span(self.pad_span):
            stacked = np.stack(list(images) + [images[0]] * pad)
            stacked_i = np.stack(list(infos) + [infos[0]] * pad)
        return self.run_batch(stacked, stacked_i)

    def fetch(self, recs, i: int = 0) -> Tuple[np.ndarray, int]:
        """Image ``i``'s padded records and their count, on the host."""
        with self._span("fetch"):
            return recs.recs[i].cpu().numpy(), int(recs.count[i])

    def unscale(self, recs: np.ndarray, count: int, f1: float, info,
                y_off: float = 0.0) -> np.ndarray:
        """One image's padded records on the host -> records in ORIGINAL
        image coords (:meth:`_unscale`)."""
        with self._span("unscale"):
            return self._unscale(recs, count, f1, info, y_off)

    def _unscale(self, recs: np.ndarray, count: int, f1: float, info,
                 y_off: float = 0.0) -> np.ndarray:
        """CTPN's: ``unscale_records`` (the line union, then unscale)."""
        return unscale_records(recs, count, f1, info, y_off=y_off)

    def detect_image(self, im_bgr: np.ndarray) -> np.ndarray:
        """One uint8 BGR image -> (M, 9) records in ORIGINAL image coords,
        through the demo's double resize (`demo.py:59-60` then
        `test.py:18-24`)."""
        resized, f1 = resize_im(im_bgr, cfg.TEXT.SCALE, cfg.TEXT.MAX_SCALE)
        data, info, pad = prep_image(resized)
        _, lines = self.run_batch(data[None], info[None])
        recs, count = self.fetch(lines)
        return self.unscale(recs, count, f1, info, y_off=pad)

    def detect_path(self, path: str) -> np.ndarray:
        return self.detect_image(load_image_bgr(path))

    def detect_image_host(self, im_bgr: np.ndarray) -> np.ndarray:
        """demo_pb.py parity mode: the card runs only the network up to the
        head tensors; the proposal decode and the text connector run on the
        host (NumPy oracles), like the reference's frozen-graph flow
        (`demo_pb.py:73-98`). No NMS kernel launches."""
        from ctpn_tpu_torch.ops.anchors import shifted_anchors
        from ctpn_tpu_torch.postprocess.oracle import detect_np
        from ctpn_tpu_torch.utils.host_ref import proposal_layer_np

        resized, f1 = resize_im(im_bgr, cfg.TEXT.SCALE, cfg.TEXT.MAX_SCALE)
        data, info, pad = prep_image(resized)
        x = torch.as_tensor(data[None]).to(self.device)
        with torch.inference_mode():
            outs = forward_features(self.model, x)
        th, tw = int(info[0]) // 16, int(info[1]) // 16
        prob = outs.cls_prob[0, :th, :tw].cpu().numpy()
        pred = outs.bbox_pred[0, :th, :tw].cpu().numpy()
        blob = proposal_layer_np(
            prob, pred, info, shifted_anchors(th, tw),
            pre_nms_top_n=cfg.TEST.RPN_PRE_NMS_TOP_N,
            post_nms_top_n=cfg.TEST.RPN_POST_NMS_TOP_N,
            nms_thresh=cfg.TEST.RPN_NMS_THRESH,
            min_size=cfg.TEST.RPN_MIN_SIZE,
        )
        recs = detect_np(
            blob[:, 1:5].astype(np.float64),
            blob[:, 0].astype(np.float64),
            info,
            mode=self.mode,
        ).astype(np.float64)
        return unscale_records(recs, len(recs), f1, info, y_off=pad)

    def warmup(self, bucket: Optional[Tuple[int, int]] = None, batch: int = 1):
        """Run once on a gray dummy batch (reference `demo.py:95-97`):
        builds the kernels and lets cuDNN pick its algorithms."""
        bh, bw = bucket or tuple(cfg.TPU.BUCKETS[0])
        img = np.full((batch, bh, bw, 3), 128, np.uint8)
        info = np.tile(np.array([bh, bw, 1.0], np.float32), (batch, 1))
        _, lines = self.run_batch(img, info)
        lines.count.cpu()


class EASTPredictor(CTPNPredictor):
    """:class:`CTPNPredictor` for EAST (``models/east.py``, default
    ``get_network(cfg.NET_NAME)``): the program is :func:`east_program`,
    which answers with ``(EastQuads, EastRecords)`` (``postprocess/east.py``)
    in place of ``(Proposals, TextLines)``; ``graphs``' key carries
    ``"EAST"``; the stage clock has EAST's stages; :meth:`unscale` unscales
    the quads alone (no line union); there is no host post-process
    (:meth:`detect_image_host`). Its host calls are ``ctpn.east.*`` spans.
    """

    stages = timer.EAST_STAGES
    span_prefix = "east"

    def _network(self) -> torch.nn.Module:
        from ctpn_tpu_torch.models.factory import get_network

        return get_network(cfg.NET_NAME, self.device)

    def _build(self, on_stage: Optional[Callable[[str], None]] = None):
        return build_east_detect_fn(self.model, on_stage=on_stage)

    def _variant(self) -> Callable[[], Tuple]:
        return lambda: ("EAST",)

    def _unscale(self, recs: np.ndarray, count: int, f1: float, info,
                 y_off: float = 0.0) -> np.ndarray:
        """One image's padded quads on the host -> quads ``[x1, y1, ...,
        x4, y4, score]`` in ORIGINAL image coords (``unscale_quads``)."""
        return unscale_quads(recs, count, f1, info, y_off=y_off)

    def detect_image_host(self, im_bgr: np.ndarray) -> np.ndarray:
        raise ValueError("detect_image_host runs CTPN's host post-process; EAST has none")


class CRAFTPredictor(CTPNPredictor):
    """:class:`CTPNPredictor` for CRAFT (``models/craft.py``, default
    ``get_network(cfg.NET_NAME)``): the program is :func:`craft_program`,
    which answers with ``(CraftText, CraftRecords)``
    (``postprocess/craft.py``) in place of ``(Proposals, TextLines)``;
    ``graphs``' key carries ``"CRAFT"``; the stage clock has CRAFT's
    stages; the host resizes by CRAFT's rule (:meth:`detect_image`) and
    unscales the boxes alone (no line union); there is no host
    post-process (:meth:`detect_image_host`). Its host calls are
    ``ctpn.craft.*`` spans. The trunk's ``conv5_3``, which CRAFT never
    runs, is dropped from the weights (the shipped trunk artifact holds it).
    """

    stages = timer.CRAFT_STAGES
    span_prefix = "craft"

    def _network(self) -> torch.nn.Module:
        from ctpn_tpu_torch.models.factory import get_network

        return get_network(cfg.NET_NAME, self.device)

    def _state(self, params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in params_from_jax(params).items()
                if not k.startswith("trunk.conv5_3.")}

    def _build(self, on_stage: Optional[Callable[[str], None]] = None):
        return build_craft_detect_fn(self.model, on_stage=on_stage)

    def _variant(self) -> Callable[[], Tuple]:
        return lambda: ("CRAFT",)

    def _unscale(self, recs: np.ndarray, count: int, f1: float, info,
                 y_off: float = 0.0) -> np.ndarray:
        """One image's padded boxes on the host -> boxes ``[x1, y1, ..., x4,
        y4, score]`` in ORIGINAL image coords (``unscale_quads``)."""
        return unscale_quads(recs, count, f1, info, y_off=y_off)

    def prep(self, im_bgr: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
        """One uint8 BGR image -> (padded image, im_info [h, w, 1], factor)
        by CRAFT's resize (:func:`~ctpn_tpu_torch.utils.image.craft_resize_factor`,
        bilinear; a factor of 1 copies the pixels)."""
        h, w = im_bgr.shape[:2]
        f, (bh, bw) = craft_resize_factor(h, w, float(cfg.TEXT.MAG_RATIO),
                                          int(cfg.TEXT.CANVAS_SIZE), cfg.TPU.BUCKETS)
        resized = im_bgr if f == 1.0 else resize_by_factor(im_bgr, f)
        rh, rw = min(resized.shape[0], bh), min(resized.shape[1], bw)
        data = np.zeros((bh, bw, 3), np.uint8)
        data[:rh, :rw] = resized[:rh, :rw]
        return data, np.array([rh, rw, 1.0], np.float32), f

    def detect_image(self, im_bgr: np.ndarray) -> np.ndarray:
        """One uint8 BGR image -> (M, 9) boxes in ORIGINAL image coords."""
        data, info, f = self.prep(im_bgr)
        _, recs = self.run_batch(data[None], info[None])
        boxes, count = self.fetch(recs)
        return self.unscale(boxes, count, f, info)

    def detect_image_host(self, im_bgr: np.ndarray) -> np.ndarray:
        raise ValueError("detect_image_host runs CTPN's host post-process; CRAFT has none")


class DBPredictor(CTPNPredictor):
    """:class:`CTPNPredictor` for DBNet (``models/dbnet.py``, default
    ``get_network(cfg.NET_NAME)``): the program is :func:`db_program`,
    which answers with ``(DBText, DBRecords)`` (``postprocess/db.py``) in
    place of ``(Proposals, TextLines)``, its records already in the
    original image's pixels; ``graphs``' key carries ``"DB"``; the stage
    clock has DB's stages; the host resizes by DB's rule (:meth:`prep`) and
    only trims the records (:meth:`unscale`); there is no host
    post-process (:meth:`detect_image_host`). Its host calls are
    ``ctpn.db.*`` spans."""

    stages = timer.DB_STAGES
    span_prefix = "db"

    def _network(self) -> torch.nn.Module:
        from ctpn_tpu_torch.models.factory import get_network

        return get_network(cfg.NET_NAME, self.device)

    def _build(self, on_stage: Optional[Callable[[str], None]] = None):
        return build_db_detect_fn(self.model, on_stage=on_stage)

    def _variant(self) -> Callable[[], Tuple]:
        return lambda: ("DB",)

    def _unscale(self, recs: np.ndarray, count: int, f1: float, info,
                 y_off: float = 0.0) -> np.ndarray:
        """One image's records on the host, trimmed to ``count``: ``[x1, y1,
        ..., x4, y4, score]`` in ORIGINAL image coords (the program mapped
        them)."""
        return np.asarray(recs)[:count].astype(np.float64)

    def prep(self, im_bgr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One uint8 BGR image -> (image padded into its bucket, im_info
        [resized h, resized w, original h, original w]) by DB's resize
        (:func:`~ctpn_tpu_torch.utils.image.db_resize_size`, bilinear)."""
        h, w = im_bgr.shape[:2]
        (rh, rw), (bh, bw) = db_resize_size(h, w, int(cfg.TEXT.DB_SHORT_SIDE), cfg.TPU.BUCKETS)
        data = np.zeros((bh, bw, 3), np.uint8)
        data[:rh, :rw] = resize_to(im_bgr, rh, rw)
        return data, np.array([rh, rw, h, w], np.float32)

    def detect_image(self, im_bgr: np.ndarray) -> np.ndarray:
        """One uint8 BGR image -> (M, 9) boxes in ORIGINAL image coords."""
        data, info = self.prep(im_bgr)
        _, recs = self.run_batch(data[None], info[None])
        boxes, count = self.fetch(recs)
        return self.unscale(boxes, count, 1.0, info)

    def warmup(self, bucket: Optional[Tuple[int, int]] = None, batch: int = 1):
        bh, bw = bucket or tuple(cfg.TPU.BUCKETS[0])
        img = np.full((batch, bh, bw, 3), 128, np.uint8)
        info = np.tile(np.array([bh, bw, bh, bw], np.float32), (batch, 1))
        _, recs = self.run_batch(img, info)
        recs.count.cpu()

    def detect_image_host(self, im_bgr: np.ndarray) -> np.ndarray:
        raise ValueError("detect_image_host runs CTPN's host post-process; DB has none")
