"""An answer does not depend on what shares its batch, in every bucket shape
(``scripts/torch_slot_dependence.py``, which ``chip_smoke.py`` phase 23
runs on the card). On the CPU, with the shipped artifact in float32 (as
``tests/test_torch_pipeline.py`` sets it) at three small buckets, square,
wide and tall:

* one render of ``data/synth.py`` sized into the bucket and prepped as the
  server's handler preps it, through the port's ``run_padded`` in slot 0
  and in slot B-1 behind noise JPEGs, at B = 8 and 16: the raw records
  equal bit for bit, and there are records;
* the same render through the JAX package's ``run_padded``: the two
  answers pair one-to-one within 0.5 px
  (``__graft_entry__.py::_rows_match``'s standard);
* the script's layer hook (``param_modules``, ``layer_diffs``) covers every
  module that has parameters: each parameter of the model belongs to a
  module whose output it compared, and on the CPU every difference is 0.0.
"""

import importlib.util
import os.path as osp

import numpy as np
import pytest
import torch

from ctpn_tpu.config import cfg as jcfg
from ctpn_tpu.inference.pipeline import CTPNPredictor as JaxPredictor
from ctpn_tpu.utils.weights import load_params as jax_load_params
from ctpn_tpu_torch.config import cfg as tcfg
from ctpn_tpu_torch.config import reset_cfg
from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.utils.weights import load_params
from tests.test_torch_pipeline import ARTIFACT, rows_match
from tests.test_torch_train_step import TINY

torch.set_num_threads(2)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
BUCKETS = [[192, 192], [192, 288], [288, 192]]  # square, wide, tall
SMALL = {
    "TPU.COMPUTE_DTYPE": "float32",
    "TPU.BUCKETS": BUCKETS,
    "TEXT.SCALE": 184, "TEXT.MAX_SCALE": 280,
    "TEST.SCALES": (184,), "TEST.MAX_SIZE": 280,
}


def _set_both():
    for c in (jcfg, tcfg):
        for key, value in SMALL.items():
            section, name = key.split(".")
            c[section][name] = value


def _slot_script():
    spec = importlib.util.spec_from_file_location(
        "torch_slot_dependence", osp.join(REPO, "scripts", "torch_slot_dependence.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def setup():
    """The script, one render and 16 noise images per bucket (handler
    prep), and the port's predictor, all at the small cfg."""
    reset_cfg()
    _set_both()
    slot = _slot_script()
    content = slot.bucket_content(seed=5, photos=())
    pred = CTPNPredictor(load_params(ARTIFACT, device="cpu"), device="cpu")
    reset_cfg()
    return slot, content, pred


@pytest.fixture(autouse=True)
def _small_cfg():
    reset_cfg()
    _set_both()
    yield
    reset_cfg()


@pytest.mark.parametrize("batch", [8, 16])
@pytest.mark.parametrize("bucket", [tuple(b) for b in BUCKETS], ids=["square", "wide", "tall"])
def test_render_first_and_last_slot_bit_equal(setup, bucket, batch):
    slot, content, pred = setup
    images, noise = content[bucket]
    assert images[0][0].shape[:2] == bucket and len(noise) >= batch - 1
    row = slot.slot_runs(pred, images[:1], noise, batch)
    assert row["slots_first"] == [0] and row["slots_last"] == [batch - 1]
    assert row["counts"][0] > 0  # the comparison saw lines
    assert row["records"] == [0.0] and row["rois"] == [0.0]


@pytest.mark.parametrize("bucket", [tuple(b) for b in BUCKETS], ids=["square", "wide", "tall"])
def test_render_matches_jax_run_padded(setup, bucket):
    _, content, pred = setup
    data, info = content[bucket][0][0]
    _, lines = pred.run_padded([data], [info], 8)
    got = lines.recs[0, :int(lines.count[0])].numpy()
    jax_pred = JaxPredictor(jax_load_params(ARTIFACT))
    _, jlines = jax_pred.run_padded([data], [info], 8)
    want = np.asarray(jlines.recs)[0, :int(np.asarray(jlines.count)[0])]
    assert len(got) > 0
    rows_match(got, want, 0.5)


def test_layer_hook_covers_every_module_with_parameters(setup):
    slot = setup[0]
    torch.manual_seed(0)
    model = CTPN(dtype=torch.float32, **TINY).eval()
    mods = slot.param_modules(model)
    with_params = {n or "model" for n, m in model.named_modules()
                   if any(True for _ in m.parameters())}
    assert set(mods) == with_params
    assert {"bilstm", "rpn_bbox_pred", "rpn_cls_score", "rpn_conv"} <= set(mods)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (4, 64, 80, 3)).astype(np.uint8)
    diffs = slot.layer_diffs(model, images, torch.device("cpu"), (1, 3))
    assert set(diffs) == set(mods)
    compared = [mods[n] for n, d in diffs.items() if d is not None]
    covered = {id(p) for m in compared for p in m.parameters()}
    assert all(id(p) in covered for p in model.parameters())
    # every leaf module with parameters of its own is compared itself,
    # except the BiLSTM's projections, whose weights its forward applies
    uncompared = {n for n, d in diffs.items() if d is None}
    assert uncompared == {"bilstm.input_proj", "bilstm.out_proj"}
    assert all(d == 0.0 for d in diffs.values() if d is not None)
