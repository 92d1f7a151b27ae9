"""Training CLI (port of ``ctpn_tpu.cli.train_net``; reference
`ctpn/train_net.py:12-35`).

    ctpn-torch-train --cfg configs/text.yml \
        [--imdb voc_2007_trainval] [--weights data/pretrain/VGG_imagenet.npy] \
        [--max-iters N] [--restore] [--device cuda] [--set KEY VALUE ...]

Runs on the card unless ``--device cpu`` is given. Under ``torchrun`` with
more than one process it trains data parallel (``--no-dp`` turns that off).
"""

from __future__ import annotations

import argparse
import os.path as osp
import pprint

from ctpn_tpu_torch.config import (
    cfg,
    cfg_from_file,
    cfg_from_list,
    get_log_dir,
    get_output_dir,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a CTPN text detector")
    p.add_argument("--cfg", dest="cfg_file", default=None)
    p.add_argument("--imdb", dest="imdb_name", default="voc_2007_trainval")
    p.add_argument("--weights", dest="pretrained", default=None,
                   help="VGG_imagenet.npy pretrained weights")
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--restore", action="store_true")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--no-dp", action="store_true", help="disable data parallelism")
    p.add_argument("--device", default="cuda", help="device to train on (default cuda)")
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ctpn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.cfg_file:
        cfg_from_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    print("Using config:")
    pprint.pprint(cfg)

    from ctpn_tpu_torch.data.roidb import get_training_roidb
    from ctpn_tpu_torch.data.voc import get_imdb
    from ctpn_tpu_torch.training.solver import train_net

    imdb = get_imdb(args.imdb_name)
    print(f"Loaded dataset `{imdb.name}` for training")
    roidb = get_training_roidb(imdb)

    output_dir = get_output_dir(imdb.name)
    log_dir = get_log_dir(imdb.name)
    print(f"Output will be saved to `{output_dir}`")
    print(f"Logs will be saved to `{log_dir}`")

    pretrained = args.pretrained
    if pretrained is None:
        default = osp.join(cfg.ROOT_DIR, "data", "pretrain", "VGG_imagenet.npy")
        pretrained = default if osp.exists(default) else None

    train_net(
        roidb,
        output_dir,
        log_dir=log_dir,
        pretrained_model=pretrained,
        max_iters=args.max_iters or cfg.TRAIN.max_steps,
        restore=args.restore or bool(cfg.TRAIN.restore),
        batch_size=args.batch_size,
        data_parallel=not args.no_dp,
        device=device,
    )


if __name__ == "__main__":
    main()
