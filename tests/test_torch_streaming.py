"""``stream_detect`` of the port against the JAX package's.

Both stream the same seeded synthetic text renders (``ctpn_tpu/data/
synth.py``), written to disk as PNG, through their prep workers, bucket
flush and padded fixed-size batches, on the shipped weights in float32 at
the 192x288 bucket. Records pair one-to-one within 0.5 px
(``__graft_entry__.py::_rows_match``), for each route of this slice:

* ``NMS_FUSED = False`` alone: the bitmask route;
* ``NMS_FUSED = False`` with ``FUSED_STEM = True``: the stem rounds its
  output to bf16 in both packages, at the same points, and on these seeds
  no rounding flip moves a record past 0.5 px.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from ctpn_tpu.config import cfg as jcfg
from ctpn_tpu.data.synth import render_image
from ctpn_tpu.inference.pipeline import CTPNPredictor as JaxPredictor
from ctpn_tpu.inference.streaming import stream_detect as jax_stream_detect
from ctpn_tpu.utils.weights import load_params as jax_load_params
from ctpn_tpu_torch.config import cfg as tcfg
from ctpn_tpu_torch.config import reset_cfg
from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
from ctpn_tpu_torch.inference.streaming import stream_detect
from ctpn_tpu_torch.ops import nms
from ctpn_tpu_torch.utils.weights import load_params
from tests.test_torch_pipeline import ARTIFACT, rows_match

torch.set_num_threads(2)

SMALL = {
    "TPU.COMPUTE_DTYPE": "float32",
    "TPU.BUCKETS": [[192, 288]],
    "TEXT.SCALE": 192, "TEXT.MAX_SCALE": 288,
    "TEST.SCALES": (192,), "TEST.MAX_SIZE": 288,
}


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def _set_both(pairs):
    for c in (jcfg, tcfg):
        for key, value in pairs.items():
            section, name = key.split(".")
            c[section][name] = value


def _write_renders(tmp_path, seed, n):
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        rgb = render_image(rng, width=432, height=288)[0]
        path = tmp_path / f"render{i}.png"
        Image.fromarray(rgb).save(path)
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("fused_stem", [False, True])
def test_stream_detect_matches_jax(tmp_path, fused_stem):
    _set_both(dict(SMALL, **{"TPU.NMS_FUSED": False, "TPU.FUSED_STEM": fused_stem}))
    paths = _write_renders(tmp_path, 21, 3)
    # batch 2 over 3 images: one full batch and one padded partial batch
    want = dict(jax_stream_detect(
        paths, JaxPredictor(jax_load_params(ARTIFACT), mode="H"),
        batch_size=2, workers=2))
    pred = CTPNPredictor(load_params(ARTIFACT, device="cpu"), device="cpu")
    assert pred.model.trunk.fused_stem == fused_stem
    sweeps = nms.nms_fixed_point_blocked.SWEEPS
    got = dict(stream_detect(paths, pred, batch_size=2, workers=2))
    assert set(got) == set(want) == set(paths)
    assert nms.nms_fixed_point_blocked.SWEEPS > sweeps  # the bitmask route ran
    total = 0
    for path in paths:
        rows_match(got[path], want[path], 0.5)
        total += len(got[path])
    assert total > 0  # the comparison saw real detections
    assert pred.buckets_run == {(192, 288): None}
