"""The reference against the port's CPU path on small renders (float32),
and the control against the reference."""

import numpy as np
import pytest

from conftest import ROOT
from harness import compare
from harness.core import Run, apply_program_config
from inputs import make
from reference import Reference, prep
from tiny import overrides


@pytest.fixture(scope="module")
def setting():
    run = Run("h_device_b48", 5, 1, False, ROOT, device="cpu",
              overrides=overrides("h_device_b48"))
    imgs = make.variants(5, 2, [(288, 192), (192, 256), (256, 192)], 1)
    return run, imgs


def _port(run):
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.utils.weights import load_params

    apply_program_config(run.config)
    weights = str(ROOT / run.config["weights"]["file"])
    return CTPNPredictor(load_params(weights, device="cpu"), device="cpu")


def test_reference_agrees_with_the_port_on_padded_images(setting):
    run, imgs = setting
    port = _port(run)
    ref = Reference(run.config, str(ROOT / run.config["weights"]["file"]), device="cpu")
    for im in imgs:
        x, info, _ = prep.prep(make.bgr(im), run.config)
        props, lines = port.run_batch(x[None], info[None])
        mine = ref.detect(x[None], info[None])[0]
        p = props.rois[0, :int(props.count[0])].numpy()
        r = lines.recs[0, :int(lines.count[0])].numpy()
        assert len(p) == len(mine["props"])
        np.testing.assert_allclose(p, mine["props"], atol=1e-3)
        assert len(r) == len(mine["recs"])
        np.testing.assert_allclose(r, mine["recs"], atol=0.5)


def test_float8_control_departs_from_the_reference(setting):
    run, imgs = setting
    weights = str(ROOT / run.config["weights"]["file"])
    ref = Reference(run.config, weights, device="cpu")
    low = Reference(run.config, weights, device="cpu", quant="fp8")
    x = np.stack([prep.prep(make.bgr(im), run.config)[0] for im in imgs[:1]])
    a = ref.heads(x)[0][0]
    b = low.heads(x)[0][0]
    assert np.abs(a - b).max() > 1e-3
    t = compare.tally_props([(ref.detect(x, np.array([[96, 144, 1.0]]))[0]["props"],
                              low.detect(x, np.array([[96, 144, 1.0]]))[0]["props"])],
                            0.7, 0.7)
    assert t.score_gap() > 0
