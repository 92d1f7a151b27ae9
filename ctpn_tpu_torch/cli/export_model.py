"""Export CLI (port of ``ctpn_tpu.cli.export_model``; reference
`ctpn/generate_pb.py:13-41`).

Writes an inference artifact from random weights (seed 0), overlaid in
order by a source artifact (``.npz`` or orbax directory), a solver
checkpoint, ``VGG_imagenet.npy`` and a TF1 variable dump:

    ctpn-torch-export --artifact data/artifacts/ctpn_synth_f16.npz \
        --out artifact.npz                      # f16 weights .npz
    ctpn-torch-export --artifact ... --out artifact_dir   # orbax directory
    ctpn-torch-export --artifact ... --out frozen.npz --frozen \
        [--frozen-shapes 1x608x912,8x608x912] [--frozen-dp N] [--device cuda]
    ctpn-torch-export --ckpt <solver output dir> --out f.npz   # latest step

    --npy VGG_imagenet.npy           (backbone bootstrap)
    --tf-vars vars.npz               ({tf_var_name: array} dump of a TF ckpt)

``--ckpt`` reads the latest checkpoint under ``<dir>/checkpoints``: the
port's solver's (``training/checkpoint.py``), or the JAX package's solver's
(an orbax step ``<step>/default``, whose ``state.params`` it takes, as
``ctpn_tpu.cli.export_model --ckpt`` does). This is how a JAX training run
moves to the card. An ``--out`` that does not end in ``.npz`` is written as
an orbax artifact directory (``<out>/params``, float32), which both
packages' ``load_params`` read. ``--frozen`` exports the detect programs
for ``--device`` (the card by default); they run only on a device of that
type. ``--frozen-dp N`` exports them data-parallel over N devices (each
shape's batch split on dim 0; the loader needs N devices).
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_frozen_shapes(p: argparse.ArgumentParser, spec: str) -> list:
    """``NxHxW,...`` -> [(N, H, W), ...]; malformed entries are argparse
    errors (exit code 2) with a pointed message."""
    shapes = []
    for s in spec.split(","):
        try:
            dims = tuple(int(d) for d in s.split("x"))
        except ValueError:
            dims = ()
        if len(dims) != 3 or any(d <= 0 for d in dims):
            p.error(
                f"--frozen-shapes entry {s!r} must be NxHxW "
                "(three positive ints, e.g. 1x608x912)"
            )
        if dims[1] % 16 or dims[2] % 16:
            p.error(
                f"--frozen-shapes entry {s!r}: H and W must be "
                "multiples of the 16-px stride"
            )
        shapes.append(dims)
    return shapes


def main(argv=None):
    p = argparse.ArgumentParser(description="Export CTPN inference artifact")
    p.add_argument("--cfg", default=None)
    p.add_argument("--artifact", default=None,
                   help="source weights artifact (.npz or orbax directory) "
                        "to start from")
    p.add_argument("--ckpt", default=None,
                   help="solver output dir of either package (its latest "
                        "checkpoint)")
    p.add_argument("--npy", default=None, help="VGG_imagenet.npy to convert")
    p.add_argument("--tf-vars", default=None, help="npz of {tf_var_name: array}")
    p.add_argument("--out", required=True,
                   help="output .npz (f16 weights, or the frozen artifact), "
                        "or an orbax artifact directory")
    p.add_argument(
        "--frozen", action="store_true",
        help="write a self-contained frozen artifact (torch.export programs "
        "+ weights, the `generate_pb.py` ctpn.pb analogue) instead of a "
        "weights-only artifact",
    )
    p.add_argument(
        "--frozen-shapes", default=None,
        help="comma list of NxHxW program shapes to export into the frozen "
        "artifact, e.g. 1x608x912,8x608x912 (default: every cfg.TPU.BUCKETS "
        "shape at batch 1)",
    )
    p.add_argument(
        "--frozen-dp", type=int, default=None,
        help="export frozen programs data-parallel over this many devices "
        "(batch dim-0 sharded; every shape's batch must divide evenly)",
    )
    p.add_argument("--device", default="cuda",
                   help="device the frozen programs are exported for "
                        "(default cuda)")
    p.add_argument("--set", dest="set_cfg", nargs="*", default=None,
                   metavar="KEY VALUE", help="config overrides")
    args = p.parse_args(argv)

    shapes = (parse_frozen_shapes(p, args.frozen_shapes)
              if args.frozen and args.frozen_shapes else None)

    from ctpn_tpu_torch.config import cfg_from_file, cfg_from_list
    from ctpn_tpu_torch.models.factory import init_params
    from ctpn_tpu_torch.utils.weights import (
        convert_tf_vars,
        export_params,
        export_params_npz,
        load_pretrained_into,
    )

    if args.cfg:
        cfg_from_file(args.cfg)
    if args.set_cfg:
        cfg_from_list(args.set_cfg)

    params = init_params(seed=0)
    if args.artifact:
        params = load_pretrained_into(params, args.artifact, ignore_missing=False)
        print(f"loaded weights from {args.artifact}")
    if args.ckpt:
        from ctpn_tpu_torch.training import checkpoint
        from ctpn_tpu_torch.utils.weights import params_to_jax

        step = checkpoint.latest_step(args.ckpt)
        try:
            if step is not None and checkpoint.is_jax_step(args.ckpt, step):
                params = checkpoint.load_jax_params(args.ckpt, step)
            else:
                ckpt = checkpoint.load(args.ckpt)
                step, params = ckpt["step"], params_to_jax(ckpt["params"])
        except (FileNotFoundError, ValueError) as e:
            raise SystemExit(f"--ckpt {args.ckpt}: {e}") from e
        print(f"restored step {step} from {args.ckpt}")
    if args.npy:
        params = load_pretrained_into(params, args.npy)
        print(f"merged pretrained weights from {args.npy}")
    if args.tf_vars:
        tf_vars = dict(np.load(args.tf_vars, allow_pickle=True))
        params = convert_tf_vars(params, tf_vars)
        print(f"merged TF variables from {args.tf_vars}")

    if args.frozen:
        from ctpn_tpu_torch.inference.frozen import export_frozen

        out = export_frozen(params, args.out, shapes=shapes,
                            dp_devices=args.frozen_dp, device=args.device)
    elif args.out.endswith(".npz"):
        out = export_params_npz(params, args.out)
    else:
        out = export_params(params, args.out)
    print(f"wrote inference artifact to {out}")


if __name__ == "__main__":
    main()
