"""Holdout detection quality of an artifact on the seeded synthetic corpus
(port of ``scripts/eval_holdout.py``).

The synth generator is deterministic (``data/synth.py::generate_dataset``,
seed 3), so the training corpus of any past run is reproducible: this
scores an ``.npz`` artifact on the holdout split that
``ctpn_tpu_torch.cli.train_synth`` (and the JAX ``scripts/train_synth.py``)
would have used, without the original training root.

    python -m ctpn_tpu_torch.cli.eval_holdout --artifact data/artifacts/ctpn_synth_f16.npz \\
        --images 800 --holdout 32 [--device cuda] [--set KEY VALUE ...]

Prints one JSON object with P/R/F at several IoU thresholds under both
ground-truth line merges (``connector``: the detector's own rule, an upper
bound sharing its bias; ``geometric``: the independent number quality
claims should quote).
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
from typing import Optional, Sequence

from ctpn_tpu_torch.cli.train_synth import (
    detect_holdout,
    raw_corpus,
    score,
    write_holdout_refs,
)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--artifact", default="data/artifacts/ctpn_synth_f16.npz")
    p.add_argument("--root", default="output/ctpn_synth_eval")
    p.add_argument("--images", type=int, default=800,
                   help="training-set size of the run being scored (the "
                        "holdout is the stems AFTER these)")
    p.add_argument("--holdout", type=int, default=32)
    p.add_argument("--ious", default="0.3,0.5,0.6")
    p.add_argument("--device", default="cuda", help="default cuda")
    p.add_argument("--set", dest="set_cfg", nargs="*", default=None,
                   metavar="KEY VALUE", help="config overrides")
    args = p.parse_args(argv)

    from ctpn_tpu_torch.config import cfg_from_list

    if args.set_cfg:
        cfg_from_list(args.set_cfg)
    img_dir, gt_dir, stems = raw_corpus(args.root, args.images + args.holdout)
    holdout = stems[-args.holdout:]
    res_dir = osp.join(args.root, "results")
    detect_holdout(args.artifact, img_dir, holdout, res_dir, device=args.device)
    ref_dirs = {label: osp.join(args.root, f"gt_{label}")
                for label in ("connector", "geometric")}
    write_holdout_refs(gt_dir, holdout, ref_dirs)

    report = {"artifact": args.artifact, "holdout_images": args.holdout}
    for label, d in ref_dirs.items():
        for iou in [float(v) for v in args.ious.split(",")]:
            s = score(res_dir, d, iou)
            report[f"{label}@{iou}"] = {
                k: round(s[k], 4) if isinstance(s[k], float) else s[k]
                for k in ("precision", "recall", "f_measure",
                          "candidate_boxes", "reference_boxes", "matched")
            }
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
