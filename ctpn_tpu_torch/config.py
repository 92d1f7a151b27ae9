"""Unified configuration system (the port's own copy of ``ctpn_tpu.config``).

The PyTorch port keeps the same schema and key names as the JAX package so
that one YAML file (``configs/text.yml``) loads into both; the ``TPU.*``
knobs keep their names too. Of those, the port reads ``BUCKETS``,
``COMPUTE_DTYPE``, ``PARAM_DTYPE``, ``MAX_LINES``, ``NMS_FUSED`` and
``FUSED_STEM``; the others (tile sizes, ``PACKED_STEM``, whose packed
block equals the stock convs) are accepted and change nothing.

Re-implements the reference's global-EasyDict config
(`lib/fast_rcnn/config.py:7-316`) and the separate hard-coded text-connector
config (`lib/text_connector/text_connect_cfg.py:1-12`) as ONE schema, keeping
the public key names from `ctpn/text.yml` so reference configs load unchanged.

Additions over the reference (TPU-specific, all under new keys so strict YAML
merging of old configs still passes):

* ``TPU.*``      — shape buckets, compute dtype, mesh axes, padded-set sizes.
* ``TEXT.*``     — the text-connector constants, overridable from YAML
                   (the reference hard-codes them as class attributes).

The reference merge semantics are preserved: unknown keys raise ``KeyError``
and type mismatches raise ``ValueError`` (`config.py:264-276` in the
reference), with the same narrow exception that ints may widen to floats.
"""

from __future__ import annotations

import copy
import os.path as osp
from typing import Any, Dict, List

import numpy as np
import yaml


class AttrDict(dict):
    """A dict whose items are also attributes (stand-in for easydict)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover - attribute protocol
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def copy(self) -> "AttrDict":
        return _to_attrdict(copy.deepcopy(dict(self)))


def _to_attrdict(d: Any) -> Any:
    if isinstance(d, dict):
        return AttrDict({k: _to_attrdict(v) for k, v in d.items()})
    return d


def _default_cfg() -> AttrDict:
    """Build the default config tree.

    Defaults mirror the reference's `lib/fast_rcnn/config.py` values for every
    key the CTPN pipeline actually reads, plus the text-connector statics
    (`text_connect_cfg.py`) under ``TEXT`` and TPU build knobs under ``TPU``.
    """
    c = AttrDict()

    # ---- top level (reference config.py:11-25, 199-227) ----
    c.GPU_ID = 0
    c.IS_RPN = True
    c.ANCHOR_SCALES = [16]
    c.NCLASSES = 2
    c.USE_GPU_NMS = True  # kept for YAML compat; NMS always runs on-device
    c.IS_MULTISCALE = False
    c.IS_EXTRAPOLATING = True
    c.REGION_PROPOSAL = "RPN"
    c.NET_NAME = "VGGnet"
    c.SUBCLS_NAME = "voxel_exemplars"
    c.DEDUP_BOXES = 1.0 / 16.0
    # BGR pixel means, same ordering/values as reference config.py:200
    c.PIXEL_MEANS = [102.9801, 115.9465, 122.7717]
    c.RNG_SEED = 3
    c.EPS = 1e-14
    c.ROOT_DIR = osp.abspath(osp.join(osp.dirname(__file__), ".."))
    c.DATA_DIR = ""
    c.MODELS_DIR = ""
    c.MATLAB = "matlab"
    c.EXP_DIR = "default"
    c.LOG_DIR = "default"

    # ---- TRAIN (reference config.py:27-145 + text.yml) ----
    t = AttrDict()
    t.restore = 0
    t.max_steps = 100000
    t.SOLVER = "Momentum"
    t.OHEM = False
    t.WEIGHT_DECAY = 0.0005
    t.LEARNING_RATE = 0.001
    t.MOMENTUM = 0.9
    t.GAMMA = 0.1
    t.STEPSIZE = 50000
    t.DISPLAY = 10
    t.LOG_IMAGE_ITERS = 100
    t.RANDOM_DOWNSAMPLE = False
    t.SCALES_BASE = (0.25, 0.5, 1.0, 2.0, 3.0)
    t.KERNEL_SIZE = 5
    t.ASPECTS = (1,)
    t.SCALES = (600,)
    t.MAX_SIZE = 1000
    t.IMS_PER_BATCH = 1
    t.BATCH_SIZE = 300
    t.FG_FRACTION = 0.3
    t.FG_THRESH = 0.5
    t.BG_THRESH_HI = 0.5
    t.BG_THRESH_LO = 0.0
    t.USE_FLIPPED = True
    t.BBOX_REG = True
    t.BBOX_THRESH = 0.5
    t.BBOX_INSIDE_WEIGHTS = [0, 1, 0, 1]
    t.SNAPSHOT_ITERS = 1000
    t.SNAPSHOT_INFIX = ""
    t.SNAPSHOT_PREFIX = "VGGnet_fast_rcnn"
    t.USE_PREFETCH = True  # real async prefetch exists in this framework
    t.BBOX_NORMALIZE_TARGETS = True
    t.BBOX_NORMALIZE_TARGETS_PRECOMPUTED = True
    t.BBOX_NORMALIZE_MEANS = (0.0, 0.0, 0.0, 0.0)
    t.BBOX_NORMALIZE_STDS = (0.1, 0.1, 0.2, 0.2)
    t.ASPECT_GROUPING = True
    t.HAS_RPN = True
    t.PROPOSAL_METHOD = "gt"
    t.PRECLUDE_HARD_SAMPLES = True
    t.RPN_POSITIVE_OVERLAP = 0.7
    t.RPN_NEGATIVE_OVERLAP = 0.3
    t.RPN_CLOBBER_POSITIVES = False
    t.RPN_FG_FRACTION = 0.5
    t.RPN_BATCHSIZE = 300
    t.RPN_NMS_THRESH = 0.7
    t.RPN_PRE_NMS_TOP_N = 12000
    t.RPN_POST_NMS_TOP_N = 2000
    t.RPN_MIN_SIZE = 8
    t.RPN_BBOX_INSIDE_WEIGHTS = [0, 1, 0, 1]
    t.RPN_POSITIVE_WEIGHT = -1.0
    t.DONTCARE_AREA_INTERSECTION_HI = 0.5
    c.TRAIN = t

    # ---- TEST (reference config.py:147-197) ----
    s = AttrDict()
    s.SCALES = (600,)
    s.MAX_SIZE = 1000
    s.NMS = 0.3
    s.BBOX_REG = True
    s.HAS_RPN = True
    s.DETECT_MODE = "H"
    s.RPN_NMS_THRESH = 0.7
    s.RPN_PRE_NMS_TOP_N = 12000
    s.RPN_POST_NMS_TOP_N = 1000
    s.RPN_MIN_SIZE = 8
    # Pad the top of the image by up to this many pixels inside the bucket
    # (mean-color band) before the trunk, giving the row-0 classifier cells
    # receptive-field support for frame-clipped text (006.jpg's top line
    # scores 0.61 without context vs 0.98 with; docs/TRAINING.md round-5c).
    # Boxes shift back on the host (`pipeline.py::unscale_records`).
    # Default OFF: measured on the reference goldens the pad recovers
    # clipped text the goldens don't credit and splits their top lines
    # (F 0.948 -> 0.900 @ IoU 0.3) — a knob for frame-cropped corpora,
    # not for golden parity. 0 = reference-exact layout.
    s.TOP_PAD = 0
    s.checkpoints_path = "checkpoints/"
    c.TEST = s

    # ---- TEXT connector (reference text_connect_cfg.py:1-12) ----
    x = AttrDict()
    x.SCALE = 600
    x.MAX_SCALE = 1200
    x.TEXT_PROPOSALS_WIDTH = 16
    x.MIN_NUM_PROPOSALS = 2
    x.MIN_RATIO = 0.5
    x.LINE_MIN_SCORE = 0.9
    x.MAX_HORIZONTAL_GAP = 50
    x.TEXT_PROPOSALS_MIN_SCORE = 0.7
    x.TEXT_PROPOSALS_NMS_THRESH = 0.2
    x.MIN_V_OVERLAPS = 0.7
    x.MIN_SIZE_SIM = 0.7
    # scale-aware line-union pass over the FINAL line records (new; no
    # reference equivalent — postprocess/merge.py). Joins lines whose
    # horizontal gap is <= ratio x the smaller line's height; a scale-free
    # generalization of MAX_HORIZONTAL_GAP that keeps display-size text in
    # one record. 0 disables (reference-exact output; the golden-parity
    # gate pins it to 0). Measured on the reference demo set vs
    # data/results: F 0.74 -> 0.90 @ IoU 0.3 (docs/TRAINING.md round 5).
    x.LINE_MERGE_GAP_RATIO = 1.25
    x.LINE_MERGE_MIN_V_OVERLAP = 0.5
    c.TEXT = x

    # ---- TPU build knobs (new; no reference equivalent) ----
    p = AttrDict()
    # (height, width) padding buckets; inputs pad to the smallest fitting
    # bucket so every compiled shape is static. Multiples of 16 (stride).
    # Cover the TEST resize envelope (short 600 / long <= 1000) both ways.
    p.BUCKETS = [[608, 608], [608, 912], [608, 1024], [912, 608], [1024, 608]]
    p.COMPUTE_DTYPE = "bfloat16"  # conv/matmul compute dtype
    p.PARAM_DTYPE = "float32"
    p.MAX_GT = 512  # padded ground-truth strips per image
    p.MAX_DONTCARE = 64  # padded dontcare areas per image
    p.MAX_PROPOSALS = 1000  # post-NMS proposals carried into the connector
    p.MAX_LINES = 128  # padded text lines per image
    p.NMS_TILE = 256  # Pallas NMS bitmask row-tile size (multiple of 8)
    p.NMS_TILE_J = 2048  # Pallas NMS bitmask column-tile size (mult. of 16)
    p.NMS_FUSED = True  # single-kernel NMS (build+resolve fused, early exit)
    p.NMS_FUSED_BLOCK = 512  # fused NMS block size (multiple of 32)
    # route VGG block 1 through the fused Pallas stem (inference graphs
    # only). Default off: slower than XLA on DMA-limited backends — see
    # docs/PERFORMANCE.md "Fused-stem kernel post-mortem"
    p.FUSED_STEM = False
    # batch-packed VGG block 1 (inference graphs, even batches): two images
    # share the channel dim through block-diagonal weights, halving the HBM
    # bytes of the half-lane 64-channel stage. Exact to bf16 accumulation
    # order; measured 1.06x on stage 1 (docs/PERFORMANCE.md round 4).
    p.PACKED_STEM = False
    p.MESH_AXIS = "data"  # data-parallel mesh axis name
    p.PREFETCH_DEPTH = 2  # host->device pipeline depth
    p.REMAT = False  # rematerialize the backbone in the backward pass
    # (trades ~1.3x step FLOPs for ~3x activation memory — enables much
    # larger per-chip batches; jax.checkpoint on the model apply)
    c.TPU = p

    return c


cfg: AttrDict = _default_cfg()


def get_cfg() -> AttrDict:
    """Return the live global config (reference exposes the module global)."""
    return cfg


def reset_cfg() -> AttrDict:
    """Restore all defaults in place (test isolation helper)."""
    fresh = _default_cfg()
    cfg.clear()
    cfg.update(fresh)
    return cfg


def _merge_into(a: Dict[str, Any], b: AttrDict, path: str = "") -> None:
    """Strictly merge dict ``a`` into config ``b`` (reference `config.py:256-286`).

    * keys in ``a`` must already exist in ``b`` → ``KeyError`` otherwise;
    * value types must match (ints may become floats, lists/tuples interchange);
    * nested dicts recurse.
    """
    if not isinstance(a, dict):
        raise TypeError(f"expected dict at {path or '<root>'}, got {type(a)}")
    for k, v in a.items():
        if k not in b:
            raise KeyError(f"{path}{k} is not a valid config key")
        old = b[k]
        if isinstance(old, dict) and isinstance(v, dict):
            _merge_into(v, old, path=f"{path}{k}.")
            continue
        b[k] = _coerce(v, old, f"{path}{k}")


def _coerce(new: Any, old: Any, key: str) -> Any:
    if old is None or new is None:
        return new
    old_t, new_t = type(old), type(new)
    if old_t is new_t:
        return new
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, (list, tuple)) and isinstance(new, (list, tuple)):
        return old_t(new)
    if isinstance(old, np.ndarray):
        return np.array(new, dtype=old.dtype)
    if isinstance(old, bool) and isinstance(new, int):
        return bool(new)
    if isinstance(old, (int, float)) and isinstance(new, (int, float)):
        return old_t(new)
    raise ValueError(
        f"Type mismatch ({old_t} vs {new_t}) for config key: {key}"
    )


def cfg_from_file(filename: str) -> AttrDict:
    """Load a YAML config and merge it into the global config.

    Same contract as reference `config.py:288-294`; accepts `ctpn/text.yml`
    unchanged.
    """
    with open(filename, "r") as f:
        yaml_cfg = yaml.safe_load(f)
    if yaml_cfg:
        _merge_into(yaml_cfg, cfg)
    return cfg


def cfg_from_list(cfg_list: List[str]) -> AttrDict:
    """Apply ``["KEY.SUBKEY", value, ...]`` overrides (reference `config.py:296-316`)."""
    assert len(cfg_list) % 2 == 0, "cfg_from_list expects key/value pairs"
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = full_key.split(".")
        d = cfg
        for subkey in key_list[:-1]:
            if subkey not in d:
                raise KeyError(f"{full_key} is not a valid config key")
            d = d[subkey]
        subkey = key_list[-1]
        if subkey not in d:
            raise KeyError(f"{full_key} is not a valid config key")
        if isinstance(v, str):
            try:
                v = yaml.safe_load(v)
            except yaml.YAMLError:
                pass
        d[subkey] = _coerce(v, d[subkey], full_key)
    return cfg
