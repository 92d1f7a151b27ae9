#!/usr/bin/env python3
"""Peak device memory and time of the PyTorch port's train step for three
rematerialisation layouts, at full VGG16 width on the 608x912 bucket in
bf16, batch 1 and 2 (one CUDA card):

* ``none``:   the plain step (``TPU.REMAT False``);
* ``whole``:  one ``torch.utils.checkpoint`` around the whole forward,
  the literal counterpart of the JAX package's ``jax.checkpoint`` on the
  model's ``apply``;
* ``blocks``: the port's ``TPU.REMAT True``, one checkpoint per VGG block
  (``models/vgg.py``), the head as in ``none``.

    python3 scripts/torch_remat_memory.py [--iters 10]

Prints one JSON line per (batch, layout): ms per step (host clock over
``--iters`` steps ended by a synchronize, after warm-up), the peak of
``torch.cuda.max_memory_allocated`` over one step, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.utils.checkpoint import checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


class WholeForwardCheckpoint(torch.nn.Module):
    """``module``'s forward under one checkpoint (``unwrap`` finds
    ``module``, so the train step sees the CTPN's parameters)."""

    def __init__(self, module: torch.nn.Module):
        super().__init__()
        self.module = module

    def forward(self, x, remat: bool = False):
        return checkpoint(self.module, x, use_reentrant=False)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_remat_memory: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ctpn_tpu_torch.config import cfg, reset_cfg
    from ctpn_tpu_torch.models.factory import init_params
    from ctpn_tpu_torch.training.train_step import Batch, build_train_step, create_train_state
    from ctpn_tpu_torch.utils.weights import params_from_jax

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    reset_cfg()
    cfg.TRAIN.SOLVER = "Adam"
    h, w = cs.TRAIN_BUCKET
    arrays = cs.train_arrays(12, 2, (h, w))
    state_dict = params_from_jax(init_params(cfg.RNG_SEED))
    for n in (1, 2):
        batch = Batch.from_numpy([a[:n] for a in arrays]).to(dev)
        for layout in ("none", "whole", "blocks"):
            cfg.TPU.REMAT = layout == "blocks"
            model = cs.fresh_train_model(dev, state_dict)
            if layout == "whole":
                model = WholeForwardCheckpoint(model)
            state = create_train_state(model)
            step = build_train_step(model, h // 16, w // 16)
            for _ in range(2):
                step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            step(state, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                m = step(state, batch)
            float(m["total_loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / args.iters * 1e3
            print(json.dumps({"batch": n, "layout": layout, "ms_per_step": ms,
                              "peak_mib": peak / 2**20, "card": card}), flush=True)
            del model, state, step, m
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
