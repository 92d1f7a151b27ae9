"""The port's solver loop, its checkpoints and the train, prepare and
export CLIs, on the CPU at a tiny bucket.

* ``SolverWrapper`` takes three steps, logs them and writes checkpoints;
* a run restored from the step-2 checkpoint takes the same third step as
  a run that never stopped (one training image, so both see the same
  batch; the draw generator and the Adam moments come back): parameters
  equal, bit for bit;
* ``ctpn-torch-prepare``, ``ctpn-torch-train`` (with ``--restore``) and
  ``ctpn-torch-export --ckpt`` as subprocesses; the exported ``.npz``
  holds the solver's parameters (in float16, the format's precision);
* an orbax step directory and a training run without CUDA are refused.
"""

import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

from ctpn_tpu_torch.config import cfg_from_list, reset_cfg
from ctpn_tpu_torch.data.prepare import split_labels, to_voc
from ctpn_tpu_torch.data.roidb import get_training_roidb
from ctpn_tpu_torch.data.synth import generate_dataset
from ctpn_tpu_torch.data.voc import PascalVOC
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.training import checkpoint
from ctpn_tpu_torch.training.solver import SolverWrapper
from ctpn_tpu_torch.utils.weights import params_to_jax

torch.set_num_threads(2)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY_STAGES = ((1, 1, 8), (2, 1, 8), (3, 1, 16), (4, 1, 16), (5, 1, 16))
TINY = dict(trunk_stages=TINY_STAGES, lstm_hidden=16, rpn_channels=32)
SMALL = ["TRAIN.SCALES", "[64]", "TRAIN.MAX_SIZE", "96",
         "TPU.BUCKETS", "[[64,96],[96,64]]", "TPU.MAX_GT", "64"]


@pytest.fixture(autouse=True)
def _small_cfg(tmp_path):
    reset_cfg()
    cfg_from_list(SMALL + ["ROOT_DIR", str(tmp_path), "TRAIN.SOLVER", "Adam",
                           "TRAIN.DISPLAY", "1", "TRAIN.SNAPSHOT_ITERS", "2",
                           "TRAIN.USE_FLIPPED", "False"])
    yield
    reset_cfg()


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Two synthetic scenes with their ``gt_*.txt`` polygons."""
    return generate_dataset(str(tmp_path_factory.mktemp("raw")), n_images=2, seed=4)


def _roidb(tmp_path, raw):
    work = tmp_path / "prep"
    split_labels(*raw, str(work / "img"), str(work / "lbl"))
    devkit = tmp_path / "VOCdevkit2007"
    to_voc(str(work / "lbl"), str(work / "img"), str(devkit / "VOC2007"))
    return get_training_roidb(PascalVOC("trainval", "2007", devkit_path=str(devkit)))


def _solver(out, roidb):
    torch.manual_seed(0)
    model = CTPN(dtype=torch.float32, **TINY)
    return SolverWrapper(roidb, str(out), model=model, data_parallel=False, device="cpu")


def _params(sw):
    return {n: p.detach().clone() for n, p in sw.model.named_parameters()}


def test_three_steps_checkpoint_and_restore(tmp_path, raw, capsys):
    roidb = _roidb(tmp_path, raw)[:1]
    straight = _solver(tmp_path / "a", roidb)
    last = straight.train_model(3)
    out = capsys.readouterr().out
    assert [ln.split(",")[0] for ln in out.splitlines() if ln.startswith("iter:")] == \
        ["iter: 1 / 3", "iter: 2 / 3", "iter: 3 / 3"]
    assert last["step"] == 3 and np.isfinite(last["total_loss"])
    rows = [json.loads(ln) for ln in open(tmp_path / "a" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert checkpoint.saved_steps(str(tmp_path / "a")) == [2, 3]
    ckpt = checkpoint.load(str(tmp_path / "a"))
    assert ckpt["step"] == 3 and ckpt["solver"] == "Adam"
    assert ckpt["opt_state"]["count"] == 3

    # stop at 2, restore, take step 3: the same parameters
    _solver(tmp_path / "b", roidb).train_model(2)
    resumed = _solver(tmp_path / "b", roidb)
    assert resumed.train_model(3, restore=True)["step"] == 3
    want, got = _params(straight), _params(resumed)
    for n in want:
        assert torch.equal(got[n], want[n]), n
    # restoring at the end takes no step
    again = _solver(tmp_path / "b", roidb)
    assert again.train_model(3, restore=True) == {}
    for n in want:
        assert torch.equal(_params(again)[n], want[n]), n


def test_checkpoints_keep_the_newest(tmp_path, monkeypatch):
    monkeypatch.setattr(checkpoint, "KEEP", 2)
    for step in range(1, 5):
        checkpoint.save(str(tmp_path), step, {"x": torch.zeros(1)})
    assert checkpoint.saved_steps(str(tmp_path)) == [3, 4]
    assert checkpoint.latest_step(str(tmp_path / "none")) is None


def test_orbax_checkpoint_refused(tmp_path):
    """A step of the JAX solver (the committed fixture, written by
    ``ctpn_tpu``'s ``CheckpointManager``): resuming from it is refused with a
    message naming the export that carries the parameters over, and that
    export (``--ckpt``) writes its ``state.params``."""
    import shutil

    shutil.copytree(osp.join(REPO, "tests", "data", "orbax", "solver"), tmp_path / "run")
    run = str(tmp_path / "run")
    with pytest.raises(ValueError, match="orbax.*ctpn-torch-export --ckpt"):
        checkpoint.load(run)
    from ctpn_tpu_torch.cli.export_model import main as export_main

    export_main(["--ckpt", run, "--out", str(tmp_path / "x.npz")])
    want = checkpoint.load_jax_params(run, checkpoint.latest_step(run))
    with np.load(tmp_path / "x.npz") as got:
        assert sorted(got.files) == ["rpn_bbox_pred/bias", "rpn_bbox_pred/kernel",
                                     "rpn_cls_score/bias", "rpn_cls_score/kernel"]
        for k in got.files:
            a, b = k.split("/")
            assert np.array_equal(got[k], want[a][b].astype(np.float16)), k


def test_train_refuses_without_cuda():
    """The default device is the card; without CUDA the CLI raises."""
    from ctpn_tpu_torch.cli.train_net import main as train_main

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--max-iters", "1"])


def _cli(*args):
    proc = subprocess.run(
        [sys.executable, "-m", *args], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_prepare_train_export_clis(tmp_path, raw):
    devkit = tmp_path / "data" / "VOCdevkit2007"
    (tmp_path / "data").mkdir()
    out = _cli("ctpn_tpu_torch.cli.prepare_data", "--images", raw[0], "--labels", raw[1],
               "--out", str(tmp_path / "TEXTVOC"), "--link", str(devkit), "--device", "cpu")
    assert "split 2 images" in out and osp.islink(devkit)
    train = ["ctpn_tpu_torch.cli.train_net", "--device", "cpu", "--set", *SMALL,
             "ROOT_DIR", str(tmp_path), "TRAIN.SNAPSHOT_ITERS", "1", "TRAIN.DISPLAY", "1"]
    out = _cli(*train[:1], "--max-iters", "1", *train[1:])
    assert "iter: 1 / 1" in out and "done solving" in out
    out = _cli(*train[:1], "--max-iters", "2", "--restore", *train[1:])
    iters = [ln.split(",")[0] for ln in out.splitlines() if ln.startswith("iter:")]
    assert iters == ["iter: 2 / 2"]
    solver_dir = tmp_path / "output" / "default" / "voc_2007_trainval"
    assert checkpoint.saved_steps(str(solver_dir)) == [1, 2]

    npz = tmp_path / "trained.npz"
    out = _cli("ctpn_tpu_torch.cli.export_model", "--ckpt", str(solver_dir),
               "--out", str(npz))
    assert "restored step 2" in out
    want = params_to_jax(checkpoint.load(str(solver_dir))["params"])
    flat = {}

    def walk(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = v

    walk(want)
    with np.load(npz) as got:
        assert sorted(got.files) == sorted(flat)
        for k, v in flat.items():
            assert got[k].dtype == np.float16
            np.testing.assert_array_equal(got[k], v.astype(np.float16), err_msg=k)
