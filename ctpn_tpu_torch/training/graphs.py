"""The train step as one captured program per shape: a CUDA graph, replayed.

The counterpart of the JAX package's ``jax.jit(step, donate_argnums=(0,))``
(``ctpn_tpu/training/solver.py``: one compiled step per bucket; under data
parallelism ``ctpn_tpu/parallel/dp.py`` compiles it with shardings and XLA
inserts the all-reduce). PyTorch issues the step one op at a time from
Python (about 3500 kernels at 608x912: the BiLSTM's 57 column steps each
way, forward and backward, and the per-tensor updates), so on the card the
host sets the pace. :class:`TrainGraphs` captures the step's device part
(``training/train_step.py``: anchor targets, forward, both losses and L2
decay, backward, the global-norm clip, the solver update in place, the
metrics, and under DDP the gradient and metric all-reduces) once per key
and replays it:

* the key is (device, per-rank batch, bucket, solver, ``TPU.REMAT``, world
  size); the wrapper is bound to one :class:`TrainState`, whose tensors
  the graph reads and writes in place (the counterpart of donation);
* each call runs the host part first: the anchor-target draws from the
  state's CPU generator (unless given), the update's scalars (learning
  rate, Adam's bias corrections) computed in numpy float32, and the
  bookkeeping (the step counter and Adam's count advance by one); the
  batch's seven arrays, the draws and the scalars are copied into the
  key's static inputs through pinned memory, ``non_blocking``;
* the first ``warmup_steps`` calls of the wrapper run the eager step on the
  wrapper's stream (real training steps, as the JAX package's first call
  compiles); the call that completes them captures the device part into
  the wrapper's memory pool. One warm-up for a plain model; 11 for a model
  under ``DistributedDataParallel``, at any world size (PyTorch's rule
  for DDP under capture: its reducer records timing events in its first
  ten iterations), whose wrapper is built on a side stream
  (``parallel/dp.py::wrap_model``);
* a later call of the key replays the graph and clones its metrics (the
  next replay writes the same memory), and adds the learning rate.

A capture executes nothing: the step a call takes is its warm-up or its
replay, and the host part runs once per call, before either. The device
part runs inside ``train_step.reproducible``, so the warm-up and the
capture choose only kernels that give the same result from the same
inputs: a replay equals the eager step from the same state bit for bit.
Launches of the hand-written kernels are recorded at capture and added per
replay (``ops/_launches.py``); the training path launches none. A capture
or replay that fails raises: no call falls back to the eager step. On the
CPU the wrapper runs the eager step. ``backend`` replaces the CUDA graph
machinery (the tests inject a fake one).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.inference.graphs import CapturedPrograms
from ctpn_tpu_torch.training.train_step import (
    Batch,
    TrainState,
    TrainStep,
    build_train_step,
    unwrap,
)

# eager DDP iterations before a capture (``torch.cuda.make_graphed_callables``)
DDP_WARMUP_STEPS = 11


class TrainGraphs(CapturedPrograms):
    """``graphs(batch, draws=None) -> metrics``: one step of ``state`` on
    the host ``batch`` (CPU tensors, pinned for an asynchronous upload),
    captured per key on ``device`` and replayed (see the module's
    docstring); eager on the CPU. ``rank``/``world`` place this process in
    a data-parallel group (the draws are the global batch's, sliced)."""

    def __init__(self, state: TrainState, device: torch.device, rank: int = 0,
                 world: int = 1, backend: Optional[Any] = None):
        super().__init__(device, backend)
        self.state = state
        self.rank, self.world = rank, world
        ddp = unwrap(state.model) is not state.model
        self.warmup_steps = DDP_WARMUP_STEPS if ddp else 1
        self.eager_steps = 0  # steps this wrapper ran without a graph
        self.steps: Dict[tuple, TrainStep] = {}

    def step_fn(self, bh: int, bw: int) -> TrainStep:
        """The bucket's :class:`TrainStep` (built at its first use)."""
        key = (bh, bw, bool(cfg.TPU.REMAT))
        if key not in self.steps:
            self.steps[key] = build_train_step(self.state.model, bh // 16, bw // 16,
                                               self.rank, self.world)
        return self.steps[key]

    def key(self, batch: Batch) -> tuple:
        return (self.device, *batch.images.shape[:3], self.state.opt.solver,
                bool(cfg.TPU.REMAT), self.world)

    def __call__(self, batch: Batch, draws: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        if any(t.device.type != "cpu" for t in batch):
            raise ValueError("TrainGraphs takes a host batch (CPU tensors)")
        state = self.state
        step = self.step_fn(*batch.images.shape[1:3])
        if self.backend is None:  # the CPU: the eager step
            self.eager_steps += 1
            return step(state, batch, draws)
        with self._lock, self._guard():
            host = step.host_part(state, batch.images.shape[0], draws)
            key = self.key(batch)
            replay = key in self.graphs
            capture = self.eager_steps + 1 >= self.warmup_steps

            def program(*inputs):
                return step.device_part(state, Batch(*inputs[:7]), *inputs[7:])

            # the step reads what the caller's stream wrote (a restore)
            self.backend.follow_caller()
            vec = self._run(key, (*batch, host.draws, host.scalars), program,
                            capture=capture)
            if not replay:
                self.eager_steps += 1
            return step.metrics(self.backend.finish(vec), host.learning_rate)
