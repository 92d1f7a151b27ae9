"""End-to-end validation run: synthesize data, train, export, detect, score
(port of ``scripts/train_synth.py``).

    python -m ctpn_tpu_torch.cli.train_synth --iters 1000 --images 200 --root output/synth

Pipeline: the seeded synth generator (``data/synth.py``) -> prepare (strip
split + VOC tree) -> VOC loader -> training (``training/solver.py``) ->
checkpoints -> ``.npz`` export -> streaming detection of the held-out
images -> box-level P/R/F against the synthetic ground truth
(``eval.py``), whose words are merged into lines two ways.

Where the port differs from the JAX script:

* the export is the ``.npz`` artifact ``<root>/artifact.npz``; the JAX
  script exports an orbax directory ``<root>/artifact``.
  ``--init-artifact`` takes either (an ``.npz`` or an orbax artifact
  directory);
* ``--segment-iters`` runs each segment as a child process that resumes
  from the newest ``<root>/output/checkpoints/<step>`` (the port's
  checkpoints keep the JAX solver's layout), one straight after another;
* it runs on the card unless ``--device cpu`` is given, and takes config
  overrides (``--set KEY VALUE ...``) as the port's other CLIs do;
* ``--nproc N`` trains data parallel over N ranks (one card each; gloo
  ranks with ``--device cpu``): each training segment runs under
  ``torchrun --standalone --nproc_per_node N``, whose ranks only train,
  each on its slice of the global batch ``--batch``. The preparation, the
  export and the scoring stay in this process. The JAX script gets the
  same from its solver, which is data parallel over every local device by
  default.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ctpn_tpu_torch.eval import (
    compare_result_dirs,
    merge_words_to_lines,
    merge_words_to_lines_geometric,
)

MODULE = "ctpn_tpu_torch.cli.train_synth"
# the two line merges of the gt words: "connector" uses the detector's own
# grouping rule (an upper bound that shares the detector's bias),
# "geometric" is the independent criterion quality claims should quote
MERGES = {"connector": merge_words_to_lines,
          "geometric": merge_words_to_lines_geometric}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default="output/ctpn_synth")
    p.add_argument("--images", type=int, default=200)
    p.add_argument("--holdout", type=int, default=16)
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--stepsize", type=int, default=None,
                   help="LR step-decay boundary (cfg.TRAIN.STEPSIZE)")
    p.add_argument("--ohem", action="store_true",
                   help="enable online hard example mining "
                        "(cfg.TRAIN.OHEM): hardest-negative selection in "
                        "the loss instead of random bg subsampling")
    p.add_argument("--no-dp", action="store_true")
    p.add_argument("--restore", action="store_true",
                   help="resume training from the newest checkpoint")
    p.add_argument("--init-artifact", default=None,
                   help="initialize params from an exported inference "
                        "artifact (.npz or orbax directory) before training: "
                        "fine-tune from shipped "
                        "weights instead of from scratch (superseded once "
                        "--restore finds a checkpoint)")
    p.add_argument("--train-only", action="store_true",
                   help="skip export + holdout eval (segment of a longer run)")
    p.add_argument("--segment-iters", type=int, default=None,
                   help="run training in child processes of <= this many "
                        "iters each, resuming from the newest checkpoint "
                        "between them")
    p.add_argument("--nproc", type=int, default=1,
                   help="train data parallel: each training segment under "
                        "torchrun with this many ranks (one card each)")
    p.add_argument("--device", default="cuda", help="default cuda")
    p.add_argument("--set", dest="set_cfg", nargs="*", default=None,
                   metavar="KEY VALUE", help="config overrides")
    return p.parse_args(argv)


# -- corpus ------------------------------------------------------------------
def raw_corpus(root: str, n_total: int) -> Tuple[str, str, List[str]]:
    """(image dir, label dir, sorted stems) of the seeded corpus under
    ``<root>/raw``; generated unless it already holds ``n_total`` images
    (the generator is deterministic, so a complete tree is reused)."""
    from ctpn_tpu_torch.data.synth import generate_dataset

    raw = osp.join(root, "raw")
    img_dir, gt_dir = osp.join(raw, "image"), osp.join(raw, "label")
    have = (len([f for f in os.listdir(img_dir) if f.endswith(".jpg")])
            if osp.isdir(img_dir) else 0)
    if have != n_total:
        img_dir, gt_dir = generate_dataset(raw, n_images=n_total)
    stems = sorted(osp.splitext(f)[0]
                   for f in os.listdir(img_dir) if f.endswith(".jpg"))
    return img_dir, gt_dir, stems


def prepare_corpus(root: str, images: int, holdout: int) -> List[str]:
    """Corpus -> strip labels -> ``<root>/VOCdevkit2007/VOC2007`` with the
    last ``holdout`` stems left out; returns those holdout stems."""
    from ctpn_tpu_torch.data.prepare import split_labels, to_voc

    os.makedirs(root, exist_ok=True)
    print("== generating synthetic dataset ==", flush=True)
    img_dir, gt_dir, all_stems = raw_corpus(root, images + holdout)
    held = all_stems[-holdout:]

    work = osp.join(root, "work")
    stems = split_labels(img_dir, gt_dir, osp.join(work, "re_image"),
                         osp.join(work, "label_tmp"))
    for s in held:  # holdout stems never reach the VOC tree
        lp = osp.join(work, "label_tmp", s + ".txt")
        if osp.exists(lp):
            os.remove(lp)
    to_voc(osp.join(work, "label_tmp"), osp.join(work, "re_image"),
           osp.join(root, "VOCdevkit2007", "VOC2007"))
    print(f"prepared {len(stems) - len(held)} train images", flush=True)
    return held


# -- training ----------------------------------------------------------------
def train(
    root: str,
    iters: int,
    batch: int = 8,
    lr: float = 2e-4,
    stepsize: Optional[int] = None,
    ohem: bool = False,
    restore: bool = False,
    init_artifact: Optional[str] = None,
    data_parallel: bool = True,
    device: str = "cuda",
) -> Dict[str, float]:
    """Train on ``<root>/VOCdevkit2007`` into ``<root>/output`` with the
    JAX script's ``cfg.TRAIN`` settings; returns the last logged metrics."""
    from ctpn_tpu_torch.config import cfg
    from ctpn_tpu_torch.data.roidb import get_training_roidb
    from ctpn_tpu_torch.data.voc import PascalVOC
    from ctpn_tpu_torch.training.solver import train_net

    print("== training ==", flush=True)
    cfg.TRAIN.LEARNING_RATE = lr
    if stepsize:
        cfg.TRAIN.STEPSIZE = stepsize
    cfg.TRAIN.OHEM = bool(ohem)
    cfg.TRAIN.SNAPSHOT_ITERS = max(200, iters // 6)
    cfg.TRAIN.DISPLAY = 20
    cfg.TRAIN.USE_FLIPPED = True

    imdb = PascalVOC("trainval", "2007",
                     devkit_path=osp.join(root, "VOCdevkit2007"))
    roidb = get_training_roidb(imdb)
    return train_net(
        roidb, osp.join(root, "output"), max_iters=iters, restore=restore,
        data_parallel=data_parallel, batch_size=batch,
        pretrained_model=init_artifact, device=device,
    )


# -- holdout scoring -----------------------------------------------------------
def export(root: str) -> str:
    """The latest checkpoint under ``<root>/output`` -> ``<root>/artifact.npz``."""
    from ctpn_tpu_torch.cli.export_model import main as export_main

    art = osp.join(root, "artifact.npz")
    export_main(["--ckpt", osp.join(root, "output"), "--out", art])
    return art


def detect_holdout(artifact: str, img_dir: str, stems: Sequence[str],
                   res_dir: str, device: str = "cuda") -> None:
    """``stream_detect`` (batch 4) over the holdout images with the
    artifact's weights; one ``res_<stem>.txt`` of integer line boxes each."""
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.inference.streaming import stream_detect
    from ctpn_tpu_torch.utils.weights import load_params

    predictor = CTPNPredictor(load_params(artifact, device=device), device=device)
    os.makedirs(res_dir, exist_ok=True)
    paths = [osp.join(img_dir, s + ".jpg") for s in stems]
    for path, recs in stream_detect(paths, predictor, batch_size=4):
        stem = osp.splitext(osp.basename(path))[0]
        with open(osp.join(res_dir, f"res_{stem}.txt"), "w") as f:
            for box in recs:
                xs, ys = box[0:8:2], box[1:8:2]
                f.write(f"{int(min(xs))},{int(min(ys))},"
                        f"{int(max(xs))},{int(max(ys))}\r\n")


def write_holdout_refs(gt_dir: str, stems: Sequence[str],
                       ref_dirs: Mapping[str, str]) -> None:
    """The ground truth as ``res_*.txt`` references, one directory per
    merge (``ref_dirs``: ``{"connector" | "geometric": dir}``, the keys of
    ``MERGES``). The gt is per word (ICDAR style) and the detector emits
    lines, so the words are merged into the lines a perfect detector could
    produce."""
    for d in ref_dirs.values():
        os.makedirs(d, exist_ok=True)
    for s in stems:
        words = []
        with open(osp.join(gt_dir, f"gt_{s}.txt")) as f:
            for line in f:
                v = line.strip().split(",")[:8]
                if len(v) == 8:
                    xs = [float(v[i]) for i in (0, 2, 4, 6)]
                    ys = [float(v[i]) for i in (1, 3, 5, 7)]
                    words.append([min(xs), min(ys), max(xs), max(ys)])
        words = np.asarray(words, np.float64).reshape(-1, 4)
        for label, d in ref_dirs.items():
            with open(osp.join(d, f"res_{s}.txt"), "w") as out:
                for x0, y0, x1, y1 in MERGES[label](words):
                    out.write(f"{int(x0)},{int(y0)},{int(x1)},{int(y1)}\r\n")


def score(res_dir: str, ref_dir: str, iou: float = 0.5) -> dict:
    """P/R/F of the detections against one reference directory, without
    the per-file counts."""
    out = compare_result_dirs(res_dir, ref_dir, iou_thresh=iou)
    out.pop("per_file")
    return out


# -- segments ------------------------------------------------------------------
def run_segments(args: argparse.Namespace, argv: Sequence[str]) -> None:
    """Run ``args.iters`` as child processes of at most
    ``args.segment_iters`` each (one child without it), resuming where the
    checkpoints end. With ``--nproc N`` each child is ``torchrun`` over N
    ranks that only train; this process then exports and scores."""
    from ctpn_tpu_torch.training.checkpoint import saved_steps

    # "--flag=value" -> "--flag value", so the rewrites below find the flags
    base: List[str] = []
    for a in argv:
        base.extend(a.split("=", 1) if a.startswith("--") and "=" in a else [a])
    for flag in ("--segment-iters", "--nproc"):
        if flag in base:
            i = base.index(flag)
            del base[i:i + 2]
    launch = [sys.executable, "-m"]
    if args.nproc > 1:
        launch += ["torch.distributed.run", "--standalone", "--nproc_per_node",
                   str(args.nproc), "-m"]
    steps = saved_steps(osp.join(args.root, "output"))
    done = steps[-1] if steps else 0
    first = True
    while done < args.iters:
        done = min(done + (args.segment_iters or args.iters), args.iters)
        seg = [*launch, MODULE, *base]
        if "--iters" in seg:
            seg[seg.index("--iters") + 1] = str(done)
        else:
            seg.extend(["--iters", str(done)])
        if (steps or not first) and "--restore" not in seg:
            seg.append("--restore")
        if (done < args.iters or args.nproc > 1) and "--train-only" not in seg:
            seg.append("--train-only")
        first = False
        print(f"== segment -> iter {done} ==", flush=True)
        subprocess.run(seg, check=True)


def score_holdout(args: argparse.Namespace, holdout: Sequence[str]) -> None:
    """Export the newest checkpoint, detect the holdout and print P/R/F
    against both merges of its ground truth."""
    print("== export + detect holdout ==", flush=True)
    art = export(args.root)
    img_dir = osp.join(args.root, "raw", "image")
    res_dir = osp.join(args.root, "results")
    detect_holdout(art, img_dir, holdout, res_dir, device=args.device)
    ref_dirs = {"connector": osp.join(args.root, "gt_results"),
                "geometric": osp.join(args.root, "gt_results_geo")}
    write_holdout_refs(osp.join(args.root, "raw", "label"), holdout, ref_dirs)
    for label, d in ref_dirs.items():
        print(f"holdout detection vs gt ({label}-merge):",
              json.dumps(score(res_dir, d), indent=2), flush=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    from ctpn_tpu_torch.config import cfg_from_list
    from ctpn_tpu_torch.parallel.dp import env_world_size

    if args.set_cfg:
        cfg_from_list(args.set_cfg)
    rank = int(os.environ.get("RANK", "0"))
    if env_world_size() > 1:  # a rank under torchrun: the parent prepared
        metrics = train(
            args.root, args.iters, batch=args.batch, lr=args.lr,
            stepsize=args.stepsize, ohem=args.ohem, restore=args.restore,
            init_artifact=args.init_artifact, device=args.device,
        )
        if rank == 0:
            print("final:", json.dumps(metrics), flush=True)
        return
    if args.nproc > 1:
        holdout = prepare_corpus(args.root, args.images, args.holdout)
        run_segments(args, argv)
        if not args.train_only:
            score_holdout(args, holdout)
        return
    if args.segment_iters and args.iters > args.segment_iters:
        run_segments(args, argv)
        return

    holdout = prepare_corpus(args.root, args.images, args.holdout)
    metrics = train(
        args.root, args.iters, batch=args.batch, lr=args.lr,
        stepsize=args.stepsize, ohem=args.ohem, restore=args.restore,
        init_artifact=args.init_artifact, data_parallel=not args.no_dp,
        device=args.device,
    )
    print("final:", json.dumps(metrics), flush=True)
    if not args.train_only:
        score_holdout(args, holdout)


if __name__ == "__main__":
    main()
