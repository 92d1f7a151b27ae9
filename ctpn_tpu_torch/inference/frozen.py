"""Frozen inference artifact: exported detect programs + weights in ONE file
(port of ``ctpn_tpu.inference.frozen``).

The reference freezes its graph into `data/ctpn.pb`, which `demo_pb.py:66-75`
runs without the model-building code. Here the whole detect program of
``inference/pipeline.py::detect_program`` (uint8 batch -> mean subtract ->
VGG16 -> BiLSTM -> heads -> proposal decode with its NMS -> NMS 0.2 ->
connector) is traced by ``torch.export.export`` and stored as the bytes of
``torch.export.save``, one program per exported (batch, height, width),
with the weights stored once beside them in the same ``.npz``. The output
ABI is a flat tuple of tensors, as in the JAX artifact:

    (rois, roi_valid, roi_count, recs, line_valid, line_count)

The weights are an input of every program (a dict of tensors in the
order ``meta["param_names"]``), not state saved inside it, so three
programs of VGG16 cost one copy of the weights.

Loading needs ``torch``, ``numpy`` and ``ctpn_tpu_torch.ops``: no model
code and no cfg. That is the one difference from the JAX artifact, whose
Pallas kernel is inlined into its StableHLO. The hand-written kernels are
``torch.library`` ops (``ctpn_torch::nms_keep_sorted_fused``,
``suppression_bitmask``, ``nms_resolve``, ``fused_stem_block``,
``conv_epilogue``, ``successors``, ``chain_walk``): the program holds each
as one node, and the op's registration (``ops/_kernel.py``, whose registry
this module imports) gives it its kernel where the program runs, so an artifact
exported on the card launches the same kernels as the live pipeline (and
counts them in the same ``LAUNCHES``).
An artifact exported before the conv epilogue existed holds the separate
aten passes instead, and still loads.

The loader refuses an artifact exported for another device type (it never
moves a program to the CPU quietly), a CUDA artifact without a CUDA device,
an artifact of another torch major.minor version (``torch.export``'s
format is tied to the version that wrote it), and the JAX package's
StableHLO artifact. It runs the programs with TF32 matmuls off, as the
live pipeline runs its BiLSTM's float32 matmuls: a program does not carry
the global precision flags.

A data-parallel artifact (``export_frozen(..., dp_devices=N)``, as in the
JAX package) holds one program per shape traced at the per-device batch
``n / N`` and stored under the global key ``program/{n}x{h}x{w}``. The
loader puts a copy of the weights and of each program on each of N devices
(a program traced on card 0 is moved to card k by
``torch.export.passes.move_to_device_pass``) and runs the dim-0 slices as
``parallel/dp.py::shard_detect_fn`` does, returning the global ABI tuple.

On the card a loaded program runs as the live pipeline does: captured
once per shape as a CUDA graph and replayed (``inference/graphs.py``; one
wrapper per device, or one per replica through ``shard_detect_fn``).
"""

from __future__ import annotations

import io
import json
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ctpn_tpu_torch.inference.graphs import DetectGraphs
from ctpn_tpu_torch.ops import _kernel
from ctpn_tpu_torch.ops.proposal import Proposals
from ctpn_tpu_torch.parallel.dp import shard_detect_fn
from ctpn_tpu_torch.parallel.mesh import as_devices, data_devices
from ctpn_tpu_torch.postprocess.connector import TextLines
from ctpn_tpu_torch.utils.device import full_f32_matmul, resolve_device

# the op registrations: a loaded program resolves its kernel nodes there
_kernel.registry()

FORMAT = "ctpn-torch-frozen-v1"
JAX_FORMAT = "ctpn-frozen-v1"  # ctpn_tpu's StableHLO artifact
ABI = ("rois", "roi_valid", "roi_count", "recs", "line_valid", "line_count")


def is_frozen(path: str) -> bool:
    """True if ``path`` is a frozen artifact (an ``.npz`` with a ``__meta__``
    entry, of either package) rather than a weights-only ``.npz``."""
    if not path.endswith(".npz"):
        return False
    try:
        with np.load(path) as z:
            return "__meta__" in z.files
    except (OSError, ValueError):
        return False


def _major_minor(version: str) -> Tuple[str, ...]:
    return tuple(version.split("+")[0].split(".")[:2])


class _DetectProgram(torch.nn.Module):
    """The flat-ABI detect program over a parameter dict.

    The model is held out of the module's state (in a list), so the
    exported program takes the weights as its first input and saves none.
    """

    def __init__(self, model: torch.nn.Module, props_kw, lines_kw):
        super().__init__()
        self._model = [model]
        self.props_kw = dict(props_kw)
        self.lines_kw = dict(lines_kw)

    def forward(self, params: Dict[str, torch.Tensor], images: torch.Tensor,
                im_info: torch.Tensor):
        from ctpn_tpu_torch.inference.pipeline import detect_program

        model = self._model[0]

        def net(x):
            return torch.func.functional_call(model, params, (x,))

        props, lines = detect_program(net, images, im_info, self.props_kw,
                                      self.lines_kw)
        return (props.rois, props.valid, props.count,
                lines.recs, lines.valid, lines.count)


def export_frozen(
    params: Mapping[str, Any],
    out_path: str,
    shapes: Optional[Sequence[Tuple[int, int, int]]] = None,
    mode: Optional[str] = None,
    model: Optional[torch.nn.Module] = None,
    dp_devices: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> str:
    """Export the full detect program + weights into ``out_path`` (.npz).

    ``params`` is a JAX-layout parameter tree (as ``CTPNPredictor`` takes).
    ``shapes``: (batch, bucket_h, bucket_w) triples; defaults to every
    cfg.TPU.BUCKETS shape at batch 1 (the demo contract). The programs are
    traced on ``device`` and run only on a device of its type. The cfg at
    export time fixes the route (``TPU.NMS_FUSED``, ``TPU.FUSED_STEM``),
    the compute dtype and every threshold inside the programs.

    ``dp_devices``: export each program data-parallel over that many
    devices (weights replicated, batch dim-0 sharded). Every shape's batch
    must divide evenly (``ValueError``) and that many devices of the type
    must be visible (``RuntimeError``); the loader needs as many.
    ``devices``, if given, is the list the run will use instead of the
    visible ones (it may name one card twice); the programs are traced on
    its first entry.
    """
    from ctpn_tpu_torch.config import cfg
    from ctpn_tpu_torch.inference.pipeline import lines_kwargs, proposal_kwargs
    from ctpn_tpu_torch.models.factory import get_network
    from ctpn_tpu_torch.utils.weights import params_from_jax

    dev = resolve_device(device)
    if shapes is None:
        shapes = [(1, bh, bw) for bh, bw in cfg.TPU.BUCKETS]
    n_dev = int(dp_devices or 1)
    if n_dev > 1:
        bad = [tuple(s) for s in shapes if s[0] % n_dev]
        if bad:
            raise ValueError(f"batch of shapes {bad} not divisible by "
                             f"dp_devices={n_dev}")
        devs = data_devices(n_dev, dev) if devices is None else as_devices(devices)
        if len(devs) < n_dev:
            raise RuntimeError(f"dp_devices={n_dev} but only {len(devs)} devices given")
        dev = devs[0]
    model = (model or get_network("VGGnet_test", dev)).to(dev).eval()
    state = {k: v.to(dev) for k, v in params_from_jax(params).items()}
    model.load_state_dict(state)  # checks names and shapes
    mode = mode or cfg.TEST.DETECT_MODE
    program = _DetectProgram(model, proposal_kwargs(), lines_kwargs(mode))

    blobs: Dict[str, np.ndarray] = {}
    for n, bh, bw in shapes:
        per = n // n_dev  # the batch of one device's program
        images = torch.zeros((per, bh, bw, 3), dtype=torch.uint8, device=dev)
        info = torch.tensor([[bh, bw, 1.0]] * per, dtype=torch.float32, device=dev)
        with torch.no_grad():
            exported = torch.export.export(program, (state, images, info), strict=False)
        exported.example_inputs = None  # else the archive keeps the weights too
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        blobs[f"program/{n}x{bh}x{bw}"] = np.frombuffer(buf.getvalue(), np.uint8)

    meta = {
        "format": FORMAT,
        "abi": list(ABI),
        "mode": mode,
        "shapes": [list(s) for s in shapes],
        "device": dev.type,
        "param_names": list(state),
        # the loader's detect_image applies the demo's double resize
        # (`demo.py:21-25` then `test.py:18-24`) from these stored values:
        # the artifact does not depend on the consumer's config
        "text_scale": int(cfg.TEXT.SCALE),
        "text_max_scale": int(cfg.TEXT.MAX_SCALE),
        "test_scale": int(cfg.TEST.SCALES[0]),
        "test_max_size": int(cfg.TEST.MAX_SIZE),
        "dp_devices": n_dev,
        "torch_version": torch.__version__,
    }
    if dev.type == "cuda":
        meta["device_name"] = torch.cuda.get_device_name(dev)
        meta["compute_capability"] = list(torch.cuda.get_device_capability(dev))
    arrays = {f"param/{k}": v.detach().cpu().numpy() for k, v in state.items()}
    if not out_path.endswith(".npz"):
        out_path += ".npz"
    np.savez(out_path, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             **blobs, **arrays)
    return out_path


class FrozenCTPN:
    """Loader and runner of a frozen artifact, on ``device`` (default the
    card; the artifact must have been exported for that device type).

    A data-parallel artifact (``meta["dp_devices"]`` N > 1) runs over
    ``devices``, default the first N visible devices of the type
    (``mesh.data_devices``); fewer than N raise ``RuntimeError``. Several
    entries may name one device (the CPU tests run N replicas on the CPU).
    """

    def __init__(self, path: str, device: Union[str, torch.device] = "cuda",
                 devices: Optional[Sequence[Union[str, torch.device]]] = None):
        self.device = resolve_device(device)
        with np.load(path) as z:
            if "__meta__" not in z.files:
                raise ValueError(f"{path}: not a frozen artifact (no __meta__)")
            self.meta = json.loads(bytes(z["__meta__"]).decode())
            fmt = self.meta.get("format")
            if fmt == JAX_FORMAT:
                raise ValueError(
                    f"{path} is a frozen artifact of the JAX package (StableHLO "
                    "programs), which the PyTorch port cannot run: re-export "
                    "the weights with `ctpn-torch-export --frozen`"
                )
            if fmt != FORMAT:
                raise ValueError(f"{path}: not a {FORMAT} artifact (format {fmt!r})")
            wrote = self.meta["torch_version"]
            if _major_minor(wrote) != _major_minor(torch.__version__):
                raise RuntimeError(
                    f"{path} was exported by torch {wrote}; this is torch "
                    f"{torch.__version__}: re-export with this version "
                    "(`ctpn-torch-export --frozen`)"
                )
            if self.meta["device"] != self.device.type:
                raise RuntimeError(
                    f"{path} was exported for device type "
                    f"{self.meta['device']!r}, asked to run on "
                    f"{self.device.type!r}: re-export on this device "
                    "(`ctpn-torch-export --frozen --device ...`)"
                )
            self.devices = self._dp_devices(path, devices)
            self.device = self.devices[0]
            host = {name: torch.from_numpy(z[f"param/{name}"])
                    for name in self.meta["param_names"]}
            self._params = {dev: {k: v.to(dev) for k, v in host.items()}
                            for dev in dict.fromkeys(self.devices)}
            self._blobs = {
                tuple(int(d) for d in k.split("/")[1].split("x")): bytes(z[k])
                for k in z.files if k.startswith("program/")
            }
        self._programs: Dict[Tuple[Tuple[int, int, int], torch.device], Any] = {}
        # DetectGraphs of the device, or the sharded fn over the devices
        self.runner = None

    def _dp_devices(self, path: str, devices) -> list:
        """The devices the programs run on: ``[self.device]``, or N of the
        artifact's device type for a data-parallel one."""
        n_dev = int(self.meta.get("dp_devices") or 1)
        if n_dev == 1:
            return [self.device]
        devs = (data_devices(n_dev, self.device) if devices is None
                else as_devices(devices))
        if len(devs) < n_dev:
            raise RuntimeError(
                f"{path}: its programs were exported for {n_dev} devices; "
                f"{len(devs)} given"
            )
        if any(d.type != self.device.type for d in devs):
            raise ValueError(f"devices {devs} are not all of type {self.device.type!r}")
        return devs[:n_dev]

    @property
    def shapes(self):
        """Exported (batch, bucket_h, bucket_w) triples."""
        return sorted(self._blobs)

    def _program(self, key, dev: torch.device):
        """The program of ``key`` on ``dev``, loaded once per device."""
        if (key, dev) not in self._programs:
            loaded = torch.export.load(io.BytesIO(self._blobs[key]))
            if dev.type == "cuda":
                # traced on one card, whose index its device constants
                # carry; a constant kept on the host by an older export
                # would be copied in on every run (and a capture refuses
                # a copy from pageable memory): every tensor goes to dev
                from torch.export.passes import move_to_device_pass

                loaded = move_to_device_pass(loaded, str(as_devices([dev])[0]))
            self._programs[(key, dev)] = loaded.module()
        return self._programs[(key, dev)]

    def program_on(self, dev: torch.device):
        """The eager detect(images, im_info) on ``dev``: the loaded program
        of the batch's shape (a replica's slice of it when data parallel),
        on tensors on ``dev``."""
        params, n_dev = self._params[dev], len(self.devices)

        def detect(images, im_info):
            n, h, w = (int(d) for d in images.shape[:3])
            program = self._program((n * n_dev, h, w), dev)
            with torch.inference_mode(), full_f32_matmul():
                out = program(params, images, im_info)
            return Proposals(*out[:3]), TextLines(*out[3:])
        return detect

    def run_batch(self, images: np.ndarray, im_info: np.ndarray):
        """(N, bh, bw, 3) uint8 BGR + (N, 3) im_info -> the flat ABI tuple
        of tensors on the artifact's (first) device (queued; fetch with
        ``.cpu()``)."""
        key = (int(images.shape[0]), int(images.shape[1]), int(images.shape[2]))
        if key not in self._blobs:
            raise ValueError(
                f"no exported program for shape {key}; artifact has "
                f"{self.shapes}"
            )
        for dev in dict.fromkeys(self.devices):  # loaded here: not thread-safe
            self._program(key, dev)
        if self.runner is None:
            self.runner = (shard_detect_fn(self.program_on, self.devices)
                           if len(self.devices) > 1
                           else DetectGraphs(self.program_on(self.device), self.device))
        props, lines = self.runner(np.ascontiguousarray(images, np.uint8),
                                   np.asarray(im_info, np.float32))
        return (*props, *lines)

    def detect_image(self, im_bgr: np.ndarray) -> np.ndarray:
        """One uint8 BGR image -> (M, 9) line records in ORIGINAL coords.

        Same double-resize + unscale contract as CTPNPredictor.detect_image
        (`demo.py:47-60`), with the artifact's stored scales, padded into
        one of its exported batch-1 buckets.
        """
        from ctpn_tpu_torch.inference.records import unscale_records
        from ctpn_tpu_torch.utils.image import (pick_bucket, prep_image,
                                                resize_factor, resize_im)

        m = self.meta
        resized, f1 = resize_im(im_bgr, m["text_scale"], m["text_max_scale"])
        buckets = [(h, w) for n, h, w in self.shapes if n == 1]
        if not buckets:
            raise ValueError("artifact has no batch-1 program")
        f2 = resize_factor(resized.shape[0], resized.shape[1],
                           m["test_scale"], m["test_max_size"])
        data, info, pad = prep_image(
            resized, scale=m["test_scale"], max_scale=m["test_max_size"],
            bucket=pick_bucket(int(resized.shape[0] * f2),
                               int(resized.shape[1] * f2), buckets),
        )
        out = self.run_batch(data[None], info[None])
        recs, count = out[3], out[5]
        return unscale_records(recs[0].cpu().numpy(), int(count[0]), f1, info,
                               y_off=pad)

    def detect_path(self, path: str) -> np.ndarray:
        from ctpn_tpu_torch.utils.image import load_image_bgr

        return self.detect_image(load_image_bgr(path))


class FrozenPredictor:
    """CTPNPredictor-compatible facade over a frozen artifact.

    Exposes the ``mode`` / ``device`` / ``run_batch`` / ``run_padded`` /
    ``detect_image`` / ``warmup`` / ``buckets_run`` surface that
    ``serving.py`` and ``inference/streaming.py`` drive, so a frozen file
    deploys interchangeably with live weights. It runs only the exported
    shapes: a max_batch-8 server needs ``--frozen-shapes 8x608x912,...``.
    """

    def __init__(self, frozen: FrozenCTPN, mode: Optional[str] = None):
        self.frozen = frozen
        if mode and mode != frozen.meta["mode"]:
            raise ValueError(
                f"artifact was frozen in mode {frozen.meta['mode']!r}; "
                f"cannot serve mode {mode!r}: re-export"
            )
        self.mode = frozen.meta["mode"]
        self.device = frozen.device
        self.buckets_run: Dict[Tuple[int, int], None] = {}

    def run_batch(self, images: np.ndarray, im_info: np.ndarray):
        out = self.frozen.run_batch(images, im_info)
        self.buckets_run.setdefault((int(images.shape[1]), int(images.shape[2])))
        return Proposals(*out[:3]), TextLines(*out[3:])

    def run_padded(self, images, infos, batch_size: int):
        pad = batch_size - len(images)
        stacked = np.stack(list(images) + [images[0]] * pad)
        stacked_i = np.stack(list(infos) + [infos[0]] * pad)
        return self.run_batch(stacked, stacked_i)

    def detect_image(self, im_bgr: np.ndarray) -> np.ndarray:
        return self.frozen.detect_image(im_bgr)

    def warmup(self, bucket: Optional[Tuple[int, int]] = None, batch: int = 1):
        """Run the exported programs once (all shapes at ``batch``, or one
        bucket)."""
        shapes = [s for s in self.frozen.shapes if s[0] == batch]
        if bucket is not None:
            shapes = [s for s in shapes if (s[1], s[2]) == tuple(bucket)]
        if not shapes:
            raise ValueError(
                f"artifact has no batch-{batch} program"
                + (f" for bucket {tuple(bucket)}" if bucket else "")
                + f"; exported shapes: {self.frozen.shapes}"
            )
        for n, bh, bw in shapes:
            img = np.full((n, bh, bw, 3), 128, np.uint8)
            info = np.tile(np.array([bh, bw, 1.0], np.float32), (n, 1))
            _, lines = self.run_batch(img, info)
            lines.count.cpu()
