"""End to end: ``CTPNPredictor(device="cpu").detect_image`` of the port
against the JAX package's ``CTPNPredictor.detect_image``.

Both run the shipped artifact in float32 on synthetic text renders
(``ctpn_tpu/data/synth.py``, seeded). The final records (after the
line-union pass and unscaling) must pair one-to-one within 0.5 px, the
standard of ``__graft_entry__.py::_rows_match``. The tier-1 case runs a
small bucket; the 608x912 bucket of the default config is marked slow.
"""

import os.path as osp

import numpy as np
import pytest
import torch

from ctpn_tpu.config import cfg as jcfg
from ctpn_tpu.data.synth import render_image
from ctpn_tpu.inference.pipeline import CTPNPredictor as JaxPredictor
from ctpn_tpu.utils.weights import load_params as jax_load_params
from ctpn_tpu_torch.config import cfg as tcfg
from ctpn_tpu_torch.config import reset_cfg
from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
from ctpn_tpu_torch.utils.weights import load_params

torch.set_num_threads(2)

ARTIFACT = osp.join(
    osp.dirname(osp.dirname(osp.abspath(__file__))),
    "data", "artifacts", "ctpn_synth_f16.npz",
)


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


def _renders(seed, n, width, height):
    rng = np.random.RandomState(seed)
    return [render_image(rng, width=width, height=height)[0][..., ::-1].copy()
            for _ in range(n)]


def rows_match(a, b, atol):
    """One-to-one greedy pairing of records within ``atol``."""
    assert a.shape == b.shape, (a.shape, b.shape)
    used = np.zeros(len(b), bool)
    for k, row in enumerate(a):
        d = np.abs(b - row[None, :]).max(axis=1)
        d[used] = np.inf
        j = int(d.argmin())
        assert d[j] <= atol, f"record {k}: closest diff {d[j]:.4f} > {atol}"
        used[j] = True


def _compare(images):
    jax_pred = JaxPredictor(jax_load_params(ARTIFACT), mode="H")
    pred = CTPNPredictor(load_params(ARTIFACT, device="cpu"), device="cpu")
    total = 0
    for im in images:
        want = jax_pred.detect_image(im)
        got = pred.detect_image(im)
        rows_match(got, want, 0.5)
        total += len(got)
    assert total > 0  # the comparison saw real detections


def test_detect_image_matches_jax_small_bucket():
    _set_both({
        "TPU.COMPUTE_DTYPE": "float32",
        "TPU.BUCKETS": [[192, 288]],
        "TEXT.SCALE": 192, "TEXT.MAX_SCALE": 288,
        "TEST.SCALES": (192,), "TEST.MAX_SIZE": 288,
    })
    _compare(_renders(11, 3, 432, 288))


@pytest.mark.slow
def test_detect_image_matches_jax_full_bucket():
    _set_both({"TPU.COMPUTE_DTYPE": "float32"})
    _compare(_renders(12, 2, 900, 600))


def test_o_mode_not_ported():
    with pytest.raises(NotImplementedError, match="A7"):
        CTPNPredictor(load_params(ARTIFACT, device="cpu"), mode="O", device="cpu")
