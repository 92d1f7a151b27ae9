"""Inference demo CLI (port of ``ctpn_tpu.cli.demo``; reference
`ctpn/demo.py` + `ctpn/demo_pb.py`).

    ctpn-torch-demo --cfg configs/text.yml \
        --artifact data/artifacts/ctpn_synth_f16.npz [--images data/demo] \
        [--output data/results] [--mode H|O] [--host-postprocess] \
        [--frozen artifact.npz] [--set KEY VALUE ...] [--device cuda]

Like the reference it writes ``res_<stem>.txt`` corner CSVs and overlay
images scaled back to the original size (`demo.py:28-52`). The detection
runs as one batched program on the card; ``--host-postprocess`` stops the
card at the head tensors and decodes on the host (``demo_pb.py``);
``--frozen`` runs an exported artifact without building the model.
``--device cpu`` runs the port with the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp

import numpy as np
from PIL import Image, ImageDraw

from ctpn_tpu_torch.config import cfg, cfg_from_file, cfg_from_list
from ctpn_tpu_torch.utils.image import load_image_bgr
from ctpn_tpu_torch.utils.timer import Stopwatch


def draw_and_save(im_bgr: np.ndarray, recs: np.ndarray, out_img: str, out_txt: str):
    """Write overlay + res_*.txt (reference `demo.py:28-52` contract:
    min/max corner CSV lines terminated with CRLF)."""
    img = Image.fromarray(im_bgr[..., ::-1].astype(np.uint8))
    draw = ImageDraw.Draw(img)
    with open(out_txt, "w") as f:
        for box in recs:
            xs = box[0:8:2]
            ys = box[1:8:2]
            if box[8] >= 0.9:
                color = (255, 0, 0)
            elif box[8] >= 0.8:
                color = (0, 255, 0)
            else:
                color = (255, 255, 0)
            quad = [
                (box[0], box[1]), (box[2], box[3]),
                (box[6], box[7]), (box[4], box[5]),
            ]
            draw.polygon(quad, outline=color)
            line = ",".join(
                str(int(v))
                for v in (min(xs), min(ys), max(xs), max(ys))
            )
            f.write(line + "\r\n")
    img.save(out_img)


def main(argv=None):
    p = argparse.ArgumentParser(description="CTPN text detection demo")
    p.add_argument("--cfg", default=None)
    p.add_argument("--artifact", default=None,
                   help="weights artifact: .npz or orbax directory "
                        "(ctpn-torch-export output, or the JAX package's)")
    p.add_argument("--images", default="data/demo")
    p.add_argument("--output", default="data/results")
    p.add_argument("--mode", default=None, choices=[None, "H", "O"])
    p.add_argument(
        "--host-postprocess",
        action="store_true",
        help="run proposal decode + connector on the host (demo_pb.py parity "
        "mode: the card stops at the raw head outputs)",
    )
    p.add_argument(
        "--frozen", default=None,
        help="frozen artifact (.npz from ctpn-torch-export --frozen): the "
        "demo_pb.py flow, exported programs run without building the model",
    )
    p.add_argument(
        "--set", dest="set_cfg", nargs="*", default=None, metavar="KEY VALUE",
        help="config overrides, e.g. --set TEXT.LINE_MERGE_GAP_RATIO 0 "
        "for reference-exact raw connector output",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    args = p.parse_args(argv)

    if args.cfg:
        cfg_from_file(args.cfg)
    if args.set_cfg:
        cfg_from_list(args.set_cfg)
    if args.mode:
        cfg.TEST.DETECT_MODE = args.mode

    if args.frozen:
        from ctpn_tpu_torch.inference.frozen import FrozenCTPN

        if args.host_postprocess:
            raise SystemExit("--host-postprocess needs live params, not --frozen")
        predictor = FrozenCTPN(args.frozen, device=args.device)
        baked = predictor.meta["mode"]
        if args.mode and args.mode != baked:
            raise SystemExit(
                f"--mode {args.mode} conflicts with the artifact's baked "
                f"mode {baked!r}; re-export with --frozen for that mode"
            )
    else:
        from ctpn_tpu_torch.inference.pipeline import CTPNPredictor

        if args.artifact:
            from ctpn_tpu_torch.utils.weights import load_params

            params = load_params(args.artifact, device=args.device)
        else:
            # random weights: pipeline/debug mode (no released ckpt available)
            from ctpn_tpu_torch.models.factory import init_params

            print("WARNING: no --artifact given; using randomly initialized weights")
            params = init_params(seed=0)
        predictor = CTPNPredictor(params, device=args.device)
        predictor.warmup()

    os.makedirs(args.output, exist_ok=True)
    paths = sorted(
        sum((glob.glob(osp.join(args.images, ext)) for ext in
             ("*.png", "*.jpg", "*.jpeg")), [])
    )
    timer = Stopwatch()
    for path in paths:
        im = load_image_bgr(path)
        with timer:
            if args.host_postprocess:
                recs = predictor.detect_image_host(im)
            else:
                recs = predictor.detect_image(im)
        stem = osp.splitext(osp.basename(path))[0]
        draw_and_save(
            im,
            recs,
            osp.join(args.output, osp.basename(path)),
            osp.join(args.output, f"res_{stem}.txt"),
        )
        print(f"Detection took {timer.last:.3f}s for {len(recs)} lines: {path}")


if __name__ == "__main__":
    main()
