"""Data prep CLI (port of ``ctpn_tpu.cli.prepare_data``; reference
`lib/prepare_training_data/` scripts).

    ctpn-torch-prepare --images <raw image dir> --labels <gt_*.txt dir> \
        --out data/TEXTVOC [--link data/VOCdevkit2007]

Runs the strip splitter and the VOC converter end to end; symlink the
result as ``data/VOCdevkit2007`` (reference README.md:50-53) or pass
``--link``. Host code only: ``--device`` is accepted for a uniform command
line and not used.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

from ctpn_tpu_torch.data.prepare import split_labels, to_voc


def main(argv=None):
    p = argparse.ArgumentParser(description="Prepare CTPN training data")
    p.add_argument("--images", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--out", default="data/TEXTVOC")
    p.add_argument("--val-fraction", type=float, default=0.0)
    p.add_argument("--link", default=None,
                   help="also symlink <out> as this path (e.g. data/VOCdevkit2007)")
    p.add_argument("--device", default="cuda",
                   help="accepted for a uniform command line; preparation "
                        "runs on the host")
    args = p.parse_args(argv)

    work = osp.join(args.out, "_work")
    stems = split_labels(
        args.images, args.labels,
        osp.join(work, "re_image"), osp.join(work, "label_tmp"),
    )
    print(f"split {len(stems)} images into strips")
    to_voc(
        osp.join(work, "label_tmp"),
        osp.join(work, "re_image"),
        osp.join(args.out, "VOC2007"),
        val_fraction=args.val_fraction,
    )
    print(f"wrote VOC tree to {osp.join(args.out, 'VOC2007')}")
    if args.link:
        if osp.islink(args.link):
            os.unlink(args.link)
        os.symlink(osp.abspath(args.out), args.link)
        print(f"linked {args.link} -> {args.out}")


if __name__ == "__main__":
    main()
