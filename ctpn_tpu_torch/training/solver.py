"""The training loop: the reference SolverWrapper around the port's train step
(port of ``ctpn_tpu.training.solver``; reference `lib/fast_rcnn/train.py:12-227`).

* a checkpoint every ``SNAPSHOT_ITERS`` steps plus a final one, the newest
  100 kept (`train.py:27,177-182`), in the port's own format
  (``training/checkpoint.py``);
* restore of the latest step: parameters, solver state, step counter and
  the draw generator (`train.py:127-137`); the data order starts again from
  the seed, as in the JAX package;
* pretrained VGG bootstrap (`train.py:118-124`) through
  ``utils/weights.py::load_pretrained_into``;
* a log line every ``DISPLAY`` steps with the speed (`train.py:169-175`)
  and a line of ``metrics.jsonl`` beside it; with
  ``CTPN_TPU_TENSORBOARD=1``, rank 0 also writes six of its scalars as
  TensorBoard summaries (the reference's `train.py:83-88`) into the log
  directory;
* one captured step per shape bucket on the card, replayed
  (``training/graphs.py::TrainGraphs``; eager on the CPU): the loader's
  pinned batch is copied into the graph's static inputs;
* data parallel over ``torch.distributed`` when the process runs under
  ``torchrun`` with ``WORLD_SIZE > 1`` (``parallel/dp.py``); the global
  batch is ``max(IMS_PER_BATCH, world size)`` and each rank steps on its
  slice.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, List, Optional, Union

import torch
import torch.distributed as dist
import torch.nn as nn

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.data.minibatch import RoIDataLayer, assemble_batch
from ctpn_tpu_torch.data.pipeline import PrefetchLoader
from ctpn_tpu_torch.parallel.dp import (
    env_world_size,
    init_data_parallel,
    shard_batch,
    wrap_model,
)
from ctpn_tpu_torch.training import checkpoint
from ctpn_tpu_torch.training.graphs import TrainGraphs
from ctpn_tpu_torch.training.train_step import TrainState, create_train_state, unwrap
from ctpn_tpu_torch.utils.device import resolve_device
from ctpn_tpu_torch.utils.timer import Stopwatch


# the scalars the JAX solver writes to TensorBoard, at the logged steps
TB_SCALARS = ("total_loss", "model_loss", "rpn_cls_loss", "rpn_box_loss",
              "learning_rate", "grad_norm")


class SolverWrapper:
    def __init__(
        self,
        roidb: List[dict],
        output_dir: str,
        log_dir: Optional[str] = None,
        pretrained_model: Optional[str] = None,
        model: Optional[nn.Module] = None,
        batch_size: Optional[int] = None,
        data_parallel: bool = True,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.rank, self.world = 0, env_world_size() if data_parallel else 1
        if self.world > 1:
            if self.device.type == "cuda":
                self.device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
                torch.cuda.set_device(self.device)
            self.rank, self.world = init_data_parallel(self.device)
        self.roidb = roidb
        self.output_dir = osp.abspath(output_dir)
        self.log_dir = osp.abspath(log_dir) if log_dir else self.output_dir
        self.pretrained_model = pretrained_model
        if model is None:
            from ctpn_tpu_torch.models.factory import get_network, init_params
            from ctpn_tpu_torch.utils.weights import params_from_jax

            model = get_network("VGGnet_train", device=self.device)
            model.load_state_dict(params_from_jax(init_params(cfg.RNG_SEED)))
        self.model = model.train()
        self.batch_size = batch_size or max(cfg.TRAIN.IMS_PER_BATCH, self.world)
        os.makedirs(self.output_dir, exist_ok=True)
        os.makedirs(self.log_dir, exist_ok=True)
        self._metrics_path = osp.join(self.log_dir, "metrics.jsonl")
        self._tb = None  # the TensorBoard writer while train_model runs

    def _open_tensorboard(self):
        """A ``SummaryWriter`` on the log directory when
        ``CTPN_TPU_TENSORBOARD=1`` on rank 0, else None; a missing
        ``tensorboard`` package is one warning line (``metrics.jsonl``
        carries the same scalars)."""
        if os.environ.get("CTPN_TPU_TENSORBOARD") != "1" or self.rank != 0:
            return None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            print(f"warning: CTPN_TPU_TENSORBOARD=1 needs the tensorboard package "
                  f"({e}); writing metrics.jsonl only", flush=True)
            return None
        return SummaryWriter(self.log_dir)

    # -- checkpointing ----------------------------------------------------
    def snapshot(self, state: TrainState) -> None:
        """Save at ``state.step`` (reference ``SolverWrapper.snapshot``);
        rank 0 writes."""
        if self.rank != 0:
            return
        model = unwrap(state.model)
        checkpoint.save(self.output_dir, state.step, {
            "solver": state.opt.solver,
            "params": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "param_names": [n for n, _ in model.named_parameters()],
            "opt_state": {k: [t.cpu() for t in v] if isinstance(v, list) else v
                          for k, v in state.opt_state.items()},
            "gen": state.gen.get_state(),
        })

    def restore(self, state: TrainState) -> TrainState:
        """Load the latest checkpoint into ``state`` (unchanged if none),
        copying into the state's own tensors: a captured step holds them,
        and its next replay starts from the restored values. Data-parallel
        ranks meet at a barrier first: only rank 0 writes checkpoints."""
        if self.world > 1:
            dist.barrier()
        if checkpoint.latest_step(self.output_dir) is None:
            return state
        ckpt = checkpoint.load(self.output_dir)
        model = unwrap(state.model)
        if ckpt["solver"] != state.opt.solver:
            raise ValueError(f"checkpoint step {ckpt['step']} was written by the "
                             f"{ckpt['solver']} solver, not {state.opt.solver}")
        if ckpt["param_names"] != [n for n, _ in model.named_parameters()]:
            raise ValueError("checkpoint parameters do not match the model")
        model.load_state_dict(ckpt["params"])  # copies into the parameters
        with torch.no_grad():
            for k, v in ckpt["opt_state"].items():
                if isinstance(v, list):
                    for t, saved in zip(state.opt_state[k], v):
                        t.copy_(saved)
                else:
                    state.opt_state[k] = v
        state.step = int(ckpt["step"])
        state.gen.set_state(ckpt["gen"])
        return state

    # -- training ---------------------------------------------------------
    def train_model(
        self,
        max_iters: int,
        restore: bool = False,
        log_every: Optional[int] = None,
    ) -> Dict[str, float]:
        log_every = log_every or cfg.TRAIN.DISPLAY
        layer = RoIDataLayer(self.roidb, batch_size=self.batch_size)
        pin = self.device.type == "cuda"
        loader = PrefetchLoader(
            sample_fn=layer.next_entries,
            build_fn=lambda s: assemble_batch(*s, pin=pin),
            workers=4,
        )
        step_model = (wrap_model(self.model, self.device) if self.world > 1
                      else self.model)
        state = create_train_state(step_model)
        if self.pretrained_model:
            from ctpn_tpu_torch.utils.weights import (
                load_pretrained_into,
                params_from_jax,
                params_to_jax,
            )

            tree = load_pretrained_into(params_to_jax(self.model.state_dict()),
                                        self.pretrained_model)
            self.model.load_state_dict(params_from_jax(tree))
        if restore:
            state = self.restore(state)

        # one captured step per bucket (the feature extent depends on it)
        graphs = TrainGraphs(state, self.device, self.rank, self.world)
        self._tb = self._open_tensorboard()
        timer = Stopwatch()
        last: Dict[str, float] = {}
        start_iter = state.step
        try:
            for it in range(start_iter, max_iters):
                with timer:
                    batch = loader.get()
                    if self.world > 1:
                        batch = shard_batch(batch, self.rank, self.world)
                    metrics = graphs(batch)

                if (it + 1) % log_every == 0 or it == start_iter:
                    last = {k: float(v) for k, v in metrics.items()}
                    last.update(step=it + 1, sec_per_iter=timer.mean)
                    if self.rank == 0:
                        self._log(last, max_iters)
                if (it + 1) % cfg.TRAIN.SNAPSHOT_ITERS == 0:
                    self.snapshot(state)
            if max_iters > start_iter:
                self.snapshot(state)
        finally:
            loader.close()
            if self._tb is not None:
                self._tb.close()
                self._tb = None
        return last

    def _log(self, last: Dict[str, float], max_iters: int) -> None:
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(last) + "\n")
        if self._tb is not None:
            for k in TB_SCALARS:
                self._tb.add_scalar(k, last[k], global_step=last["step"])
        print(
            f"iter: {last['step']} / {max_iters}, "
            f"total loss: {last['total_loss']:.4f}, "
            f"model loss: {last['model_loss']:.4f}, "
            f"rpn_loss_cls: {last['rpn_cls_loss']:.4f}, "
            f"rpn_loss_box: {last['rpn_box_loss']:.4f}, "
            f"lr: {last['learning_rate']:.6f}, "
            f"speed: {last['sec_per_iter']:.3f}s / iter",
            flush=True,
        )


def train_net(
    roidb: List[dict],
    output_dir: str,
    log_dir: Optional[str] = None,
    pretrained_model: Optional[str] = None,
    max_iters: int = 40000,
    restore: bool = False,
    **kw,
) -> Dict[str, float]:
    """Reference `train_net` entry (`train.py:217-227`). A data-parallel
    run leaves its process group when it ends."""
    sw = SolverWrapper(
        roidb,
        output_dir,
        log_dir=log_dir,
        pretrained_model=pretrained_model,
        **kw,
    )
    try:
        print("Solving...")
        out = sw.train_model(max_iters, restore=restore)
        print("done solving")
    finally:
        if sw.world > 1 and dist.is_initialized():
            dist.barrier()  # rank 0 may still be writing the last checkpoint
            dist.destroy_process_group()
    return out
