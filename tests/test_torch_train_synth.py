"""The synthetic train -> export -> holdout-score run of the port
(``ctpn_tpu_torch/cli/train_synth.py``, ``cli/eval_holdout.py``) against
the JAX scripts, and the solver's TensorBoard opt-in, on the CPU.

* ``prepare_corpus`` writes the files, byte for byte, that the JAX
  script's generate -> split_labels -> to_voc sequence writes
  (``scripts/train_synth.py:88-118``);
* ``eval_holdout`` with the shipped artifact, f32 compute, at a small
  bucket: its report equals the JAX ``scripts/eval_holdout.py``'s, and the
  holdout references of both merges are identical files;
* a two-iteration ``train_synth`` run in two segments goes through
  train -> resume -> export -> score;
* with ``CTPN_TPU_TENSORBOARD=1`` the event file holds the six scalars at
  the logged steps with the values of ``metrics.jsonl``; without the
  ``tensorboard`` package one warning line and training goes on;
* ``scripts/training_report.py`` reads the port's ``metrics.jsonl``.
"""

import contextlib
import importlib.util
import io
import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

from ctpn_tpu.config import cfg_from_list as jax_cfg_from_list
from ctpn_tpu.config import reset_cfg as jax_reset_cfg
from ctpn_tpu.data.prepare import split_labels as jax_split_labels
from ctpn_tpu.data.prepare import to_voc as jax_to_voc
from ctpn_tpu.data.synth import generate_dataset as jax_generate_dataset
from ctpn_tpu_torch.cli import eval_holdout, train_synth
from ctpn_tpu_torch.config import cfg_from_list, reset_cfg
from ctpn_tpu_torch.data.prepare import split_labels, to_voc
from ctpn_tpu_torch.data.roidb import get_training_roidb
from ctpn_tpu_torch.data.synth import generate_dataset
from ctpn_tpu_torch.data.voc import PascalVOC
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.training import checkpoint
from ctpn_tpu_torch.training.solver import TB_SCALARS, SolverWrapper

torch.set_num_threads(2)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
ARTIFACT = osp.join(REPO, "data", "artifacts", "ctpn_synth_f16.npz")
JAX_RUN = osp.join(REPO, "docs", "runs", "synth_ft5d_1500_edgeclip_metrics.jsonl")
# training at the reduced scale of tests/test_torch_solver.py
SMALL = ["TRAIN.SCALES", "[64]", "TRAIN.MAX_SIZE", "96",
         "TPU.BUCKETS", "[[64,96],[96,64]]", "TPU.MAX_GT", "64"]
# detection where the shipped weights find lines in the synthetic scenes,
# f32 so both packages compute alike
EVAL = ["TEXT.SCALE", "304", "TEXT.MAX_SCALE", "464",
        "TPU.BUCKETS", "[[304,464],[464,304]]", "TPU.COMPUTE_DTYPE", "float32"]
TINY_STAGES = ((1, 1, 8), (2, 1, 8), (3, 1, 16), (4, 1, 16), (5, 1, 16))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", osp.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = osp.join(d, f)
            with open(p, "rb") as fh:
                out[osp.relpath(p, root)] = fh.read()
    return out


def test_prepare_corpus_matches_jax(tmp_path):
    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    with contextlib.redirect_stdout(io.StringIO()):
        held = train_synth.prepare_corpus(port_root, images=3, holdout=2)

    # scripts/train_synth.py:88-118 with the JAX package's functions
    raw = osp.join(jax_root, "raw")
    img_dir, gt_dir = jax_generate_dataset(raw, n_images=5)
    stems = sorted(osp.splitext(f)[0] for f in os.listdir(img_dir) if f.endswith(".jpg"))
    work = osp.join(jax_root, "work")
    jax_split_labels(img_dir, gt_dir, osp.join(work, "re_image"), osp.join(work, "label_tmp"))
    for s in stems[-2:]:
        lp = osp.join(work, "label_tmp", s + ".txt")
        if osp.exists(lp):
            os.remove(lp)
    jax_to_voc(osp.join(work, "label_tmp"), osp.join(work, "re_image"),
               osp.join(jax_root, "VOCdevkit2007", "VOC2007"))

    assert held == stems[-2:]
    got, want = _tree(port_root), _tree(jax_root)
    assert sorted(got) == sorted(want)
    assert any(p.startswith("VOCdevkit2007") for p in want)
    for p in want:
        assert got[p] == want[p], p


@pytest.fixture(scope="module")
def holdout_runs(tmp_path_factory):
    """``eval_holdout`` of both packages on 4 holdout images (both
    orientations, so both buckets) with the shipped artifact."""
    args = ["--artifact", ARTIFACT, "--images", "4", "--holdout", "4"]
    roots = {k: str(tmp_path_factory.mktemp(k)) for k in ("port", "jax")}
    jax_script = _script("eval_holdout")
    buf = io.StringIO()
    try:
        jax_cfg_from_list(list(EVAL))
        with contextlib.redirect_stdout(buf):
            jax_script.main(args + ["--root", roots["jax"]])
    finally:
        jax_reset_cfg()
    try:
        reset_cfg()
        cfg_from_list(list(EVAL))
        with contextlib.redirect_stdout(io.StringIO()):
            port_report = eval_holdout.main(args + ["--root", roots["port"],
                                                    "--device", "cpu"])
    finally:
        reset_cfg()
    return roots, port_report, json.loads(buf.getvalue())


def test_eval_holdout_report_matches_jax(holdout_runs):
    _, port_report, jax_report = holdout_runs
    assert port_report == jax_report
    # the bucket finds lines: the equality is not one of empty sets
    assert port_report["geometric@0.5"]["candidate_boxes"] > 0
    assert set(port_report) == {"artifact", "holdout_images"} | {
        f"{m}@{iou}" for m in ("connector", "geometric") for iou in (0.3, 0.5, 0.6)}


@pytest.mark.parametrize("merge", ["connector", "geometric"])
def test_holdout_refs_match_jax(holdout_runs, merge):
    roots, _, _ = holdout_runs
    got = _tree(osp.join(roots["port"], f"gt_{merge}"))
    want = _tree(osp.join(roots["jax"], f"gt_{merge}"))
    assert len(want) == 4 and got == want


def test_train_synth_two_segments_export_and_score(tmp_path):
    """Two iterations at batch 1, one per segment: the second segment
    resumes at iteration 2, then exports and scores the holdout."""
    root = str(tmp_path / "run")
    cmd = [sys.executable, "-m", "ctpn_tpu_torch.cli.train_synth", "--root", root,
           "--images", "2", "--holdout", "2", "--iters", "2", "--segment-iters", "1",
           "--batch", "1", "--lr", "2e-5", "--init-artifact", ARTIFACT,
           "--device", "cpu", "--set", *SMALL, "TEXT.SCALE", "64",
           "TEXT.MAX_SCALE", "96", "ROOT_DIR", root]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=240,
                         env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stdout + out.stderr
    text = out.stdout
    seg1, seg2 = text.split("== segment -> iter 2 ==")
    assert "== segment -> iter 1 ==" in seg1 and "holdout detection" not in seg1
    assert [ln.split()[1] for ln in seg1.splitlines() if ln.startswith("iter: ")] == ["1"]
    assert [ln.split()[1] for ln in seg2.splitlines() if ln.startswith("iter: ")] == ["2"]
    assert checkpoint.saved_steps(osp.join(root, "output")) == [1, 2]
    rows = [json.loads(ln) for ln in open(osp.join(root, "output", "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2]
    assert np.isfinite([r["model_loss"] for r in rows]).all()
    assert osp.exists(osp.join(root, "artifact.npz"))
    for merge in ("connector", "geometric"):
        head = f"holdout detection vs gt ({merge}-merge): "
        report = json.loads(seg2.split(head)[1].split("\n}")[0] + "\n}")
        assert report["reference_boxes"] > 0 and "per_file" not in report
    held = sorted(os.listdir(osp.join(root, "raw", "image")))[-2:]
    assert sorted(os.listdir(osp.join(root, "results"))) == [
        "res_" + osp.splitext(f)[0] + ".txt" for f in held]


def test_train_synth_two_ranks(tmp_path):
    """``--nproc 2 --device cpu``: this process prepares the corpus, each of
    two segments trains under ``torchrun`` over two gloo ranks (one image of
    the global batch of 2 each; rank 0 logs and writes the checkpoint), then
    this process exports and scores the holdout."""
    root = str(tmp_path / "run")
    cmd = [sys.executable, "-m", "ctpn_tpu_torch.cli.train_synth", "--root", root,
           "--images", "2", "--holdout", "2", "--iters", "2", "--segment-iters", "1",
           "--batch", "2", "--nproc", "2", "--lr", "2e-5", "--init-artifact", ARTIFACT,
           "--device", "cpu", "--set", *SMALL, "TEXT.SCALE", "64",
           "TEXT.MAX_SCALE", "96", "ROOT_DIR", root]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    text = out.stdout
    assert text.count("== generating synthetic dataset ==") == 1  # the parent's only
    seg1, seg2 = text.split("== segment -> iter 2 ==")
    assert "== segment -> iter 1 ==" in seg1 and "holdout detection" not in seg1
    assert seg1.count("== training ==") == 2  # two ranks train
    assert [ln.split()[1] for ln in seg1.splitlines() if ln.startswith("iter: ")] == ["1"]
    assert [ln.split()[1] for ln in seg2.splitlines() if ln.startswith("iter: ")] == ["2"]
    assert text.count("final:") == 2  # rank 0 of each segment
    assert checkpoint.saved_steps(osp.join(root, "output")) == [1, 2]
    rows = [json.loads(ln) for ln in open(osp.join(root, "output", "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2]
    assert np.isfinite([r["model_loss"] for r in rows]).all()
    assert osp.exists(osp.join(root, "artifact.npz"))
    assert seg2.index("== export + detect holdout ==") > seg2.rindex("final:")
    assert "holdout detection vs gt (geometric-merge)" in seg2


@pytest.fixture
def tiny_roidb(tmp_path):
    reset_cfg()
    cfg_from_list(SMALL + ["ROOT_DIR", str(tmp_path), "TRAIN.SOLVER", "Adam",
                           "TRAIN.DISPLAY", "1", "TRAIN.SNAPSHOT_ITERS", "100",
                           "TRAIN.USE_FLIPPED", "False"])
    raw = generate_dataset(str(tmp_path / "raw"), n_images=1, seed=4)
    split_labels(*raw, str(tmp_path / "img"), str(tmp_path / "lbl"))
    to_voc(str(tmp_path / "lbl"), str(tmp_path / "img"),
           str(tmp_path / "VOCdevkit2007" / "VOC2007"))
    yield get_training_roidb(PascalVOC(
        "trainval", "2007", devkit_path=str(tmp_path / "VOCdevkit2007")))
    reset_cfg()


def _train_tiny(roidb, out, steps=3):
    torch.manual_seed(0)
    model = CTPN(dtype=torch.float32, trunk_stages=TINY_STAGES, lstm_hidden=16,
                 rpn_channels=32)
    sw = SolverWrapper(roidb, str(out), model=model, data_parallel=False, device="cpu")
    sw.train_model(steps)
    return [json.loads(ln) for ln in open(out / "metrics.jsonl")]


def test_tensorboard_scalars_are_the_metrics(tiny_roidb, tmp_path, monkeypatch, capsys):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    monkeypatch.setenv("CTPN_TPU_TENSORBOARD", "1")
    rows = _train_tiny(tiny_roidb, tmp_path / "tb")
    assert [r["step"] for r in rows] == [1, 2, 3]
    events = [f for f in os.listdir(tmp_path / "tb") if f.startswith("events.out.tfevents")]
    assert len(events) == 1
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert set(acc.Tags()["scalars"]) == set(TB_SCALARS)
    for tag in TB_SCALARS:
        got = [(e.step, np.float32(e.value)) for e in acc.Scalars(tag)]
        assert got == [(r["step"], np.float32(r[tag])) for r in rows], tag
    assert "warning" not in capsys.readouterr().out


def test_tensorboard_missing_package_warns(tiny_roidb, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("CTPN_TPU_TENSORBOARD", "1")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    rows = _train_tiny(tiny_roidb, tmp_path / "no_tb", steps=1)
    assert len(rows) == 1
    warnings = [ln for ln in capsys.readouterr().out.splitlines() if "warning" in ln]
    assert len(warnings) == 1 and "tensorboard" in warnings[0]
    assert not [f for f in os.listdir(tmp_path / "no_tb") if f.startswith("events")]


def test_training_report_reads_port_metrics(tiny_roidb, tmp_path):
    rows = _train_tiny(tiny_roidb, tmp_path / "rep")
    with open(JAX_RUN) as f:
        jax_keys = set(json.loads(f.readline()))
    assert all(set(r) == jax_keys for r in rows)
    out = tmp_path / "TRAINING.md"
    with contextlib.redirect_stdout(io.StringIO()):
        _script("training_report").main(
            ["--metrics", str(tmp_path / "rep" / "metrics.jsonl"), "--batch", "1",
             "--out", str(out)])
    curve = out.read_text().split("## Loss curve")[1].split("## LR decay")[0]
    assert "| steps | total loss | model loss | cls | box |" in curve
    # three steps fill some of the ten windows; those hold finite means
    filled = [ln for ln in curve.splitlines() if ln.startswith("| ") and "nan" not in ln]
    assert len(filled) >= 1 + 3
