"""Convert reference TF1 weights into the port's inference artifact
(port of ``ctpn_tpu.cli.convert_reference``).

Reads both reference weight formats:

* TF1 training checkpoints (``VGGnet_fast_rcnn_iter_50000.ckpt``), through
  ``tf.train.load_checkpoint``;
* the frozen ``ctpn.pb`` GraphDef (`ctpn/generate_pb.py` output), whose
  weights are its Const nodes.

    ctpn-torch-convert --tf-ckpt checkpoints/VGGnet_fast_rcnn_iter_50000.ckpt --out ctpn.npz
    ctpn-torch-convert --pb data/ctpn.pb --out ctpn.npz
    ctpn-torch-convert --pb data/ctpn.pb --out ctpn_dir   # orbax directory

TensorFlow is imported only inside the two readers. The mapping (gate
order, HWIO layout) is ``utils/weights.py::convert_tf_vars``. The artifact
is written in float32, so the reference weights stay exact; ``load_params``
of either package reads it. An ``--out`` that does not end in ``.npz`` is
written as an orbax artifact directory (``<out>/params``, float32), what the
JAX converter writes.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np


def vars_from_tf_checkpoint(prefix: str) -> Dict[str, np.ndarray]:
    """``{variable name: array}`` of a TF1 checkpoint, optimizer slots left
    out."""
    import tensorflow as tf

    reader = tf.train.load_checkpoint(prefix)
    out = {}
    for name in reader.get_variable_to_shape_map():
        # strip optimizer slots (Adam moments etc.)
        if "/Adam" in name or "Momentum" in name or "RMSProp" in name:
            continue
        out[name] = reader.get_tensor(name)
    return out


def vars_from_frozen_pb(path: str) -> Dict[str, np.ndarray]:
    """``{node name: array}`` of the non-scalar Const nodes of a frozen
    GraphDef, a trailing ``/read`` dropped from the name."""
    import tensorflow as tf

    gd = tf.compat.v1.GraphDef()
    with open(path, "rb") as f:
        gd.ParseFromString(f.read())
    out = {}
    for node in gd.node:
        if node.op != "Const":
            continue
        try:
            arr = tf.make_ndarray(node.attr["value"].tensor)
        except Exception:  # a Const of a type numpy cannot hold: not a weight
            continue
        if arr.ndim >= 1 and arr.size > 1:
            name = node.name
            if name.endswith("/read"):
                name = name[: -len("/read")]
            out[name] = arr
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert reference TF1 weights")
    p.add_argument("--cfg", default=None)
    p.add_argument("--tf-ckpt", default=None, help="TF1 checkpoint prefix")
    p.add_argument("--pb", default=None, help="frozen ctpn.pb path")
    p.add_argument("--out", required=True,
                   help="output .npz artifact or orbax artifact directory")
    args = p.parse_args(argv)
    if not args.tf_ckpt and not args.pb:
        raise SystemExit("pass --tf-ckpt or --pb")

    from ctpn_tpu_torch.config import cfg_from_file
    from ctpn_tpu_torch.models.factory import get_network
    from ctpn_tpu_torch.utils.weights import (
        convert_tf_vars,
        export_params,
        export_params_npz,
        params_to_jax,
    )

    if args.cfg:
        cfg_from_file(args.cfg)
    tf_vars = (
        vars_from_tf_checkpoint(args.tf_ckpt)
        if args.tf_ckpt
        else vars_from_frozen_pb(args.pb)
    )
    print(f"read {len(tf_vars)} tensors")
    for k in sorted(tf_vars)[:20]:
        print("  ", k, tf_vars[k].shape)

    # the model only provides the parameter skeleton convert_tf_vars fills
    params = params_to_jax(get_network("VGGnet_test", "cpu").state_dict())
    params = convert_tf_vars(params, tf_vars)
    out = (export_params_npz(params, args.out, dtype=np.float32)
           if args.out.endswith(".npz") else export_params(params, args.out))
    print(f"wrote artifact to {out}")


if __name__ == "__main__":
    main()
