"""Write the orbax fixtures under ``tests/data/orbax/`` with the JAX package.

    python scripts/make_orbax_fixture.py [--out tests/data/orbax]

Two directories, each written by the JAX package's own orbax code, so that
the port's reader (``ctpn_tpu_torch/utils/orbax_io.py``) is held against
what JAX users have on disk, on machines without JAX:

* ``artifact/``: ``ctpn_tpu.utils.weights.export_params`` of a subset of
  the shipped artifact's leaves (``LEAVES``), widened to float32 as
  ``load_params`` widens them: an OCDBT store with zstd level-1 chunks.
  ``VGG16Trunk_0/conv2_1/kernel`` (295 KB) is one chunk of three zstd
  blocks; together the frames use Huffman literals and FSE-coded
  sequences;
* ``solver/``: a step of the JAX solver, ``checkpoints/5/default``, saved
  by ``ctpn_tpu.training.solver.SolverWrapper.snapshot``
  (``StandardSave({"state": TrainState})``) for a ``TrainState`` whose
  params are ``SOLVER_LEAVES`` of the shipped artifact.

It needs JAX, flax, optax and orbax; the port never imports it.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil
import sys

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
ARTIFACT = osp.join(REPO, "data", "artifacts", "ctpn_synth_f16.npz")
LEAVES = (
    "VGG16Trunk_0/conv1_1/bias",
    "VGG16Trunk_0/conv1_1/kernel",
    "VGG16Trunk_0/conv2_1/bias",
    "VGG16Trunk_0/conv2_1/kernel",
    "bilstm/input_proj/bias",
    "rpn_bbox_pred/bias",
    "rpn_bbox_pred/kernel",
    "rpn_cls_score/bias",
    "rpn_cls_score/kernel",
)
SOLVER_LEAVES = (
    "rpn_bbox_pred/bias",
    "rpn_bbox_pred/kernel",
    "rpn_cls_score/bias",
    "rpn_cls_score/kernel",
)
SOLVER_STEP = 5


def nested(flat):
    tree = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=osp.join(REPO, "tests", "data", "orbax"))
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    import numpy as np

    from ctpn_tpu.training.solver import SolverWrapper
    from ctpn_tpu.training.train_step import TrainState, make_optimizer
    from ctpn_tpu.utils.weights import export_params

    with np.load(ARTIFACT) as npz:
        flat = {k: npz[k].astype(np.float32) for k in npz.files}
    shutil.rmtree(args.out, ignore_errors=True)
    os.makedirs(args.out)

    export_params(nested({k: flat[k] for k in LEAVES}), osp.join(args.out, "artifact"))

    params = jax.tree_util.tree_map(
        jax.numpy.asarray, nested({k: flat[k] for k in SOLVER_LEAVES}))
    state = TrainState.create(apply_fn=None, params=params, tx=make_optimizer(),
                              rng=jax.random.PRNGKey(0)).replace(step=SOLVER_STEP)
    solver = SolverWrapper([], osp.join(args.out, "solver"), data_parallel=False,
                           batch_size=1)
    solver.snapshot(state)
    # the solver also made its metrics/log directory; keep only the checkpoint
    for name in os.listdir(osp.join(args.out, "solver")):
        if name != "checkpoints":
            path = osp.join(args.out, "solver", name)
            shutil.rmtree(path) if osp.isdir(path) else os.remove(path)
    total = sum(osp.getsize(osp.join(d, f))
                for d, _, fs in os.walk(args.out) for f in fs)
    print(f"wrote {args.out}: {total} bytes")


if __name__ == "__main__":
    main()
