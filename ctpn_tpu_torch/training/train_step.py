"""Train state and the train step: anchor targets, forward, both losses, L2
decay, backward, global-norm clip and the solver update (port of
``ctpn_tpu.training.train_step``; reference `lib/fast_rcnn/train.py:79-182`).

The solvers are the port's own, written to give optax's updates (the JAX
package's ``make_optimizer``), not ``torch.optim``'s where the two differ:

* the clip is ``clip_by_global_norm(10)``: ``g`` if ``|g| < 10`` else
  ``g / |g| * 10`` (``clip_grad_norm_`` divides by ``|g| + 1e-6``);
* ``RMS`` is ``optax.rmsprop(lr, decay=0.9, eps=1.0)``: ``nu`` starts at 0
  and the update is ``g * rsqrt(nu + eps)``, eps inside the root
  (``torch.optim.RMSprop`` adds it outside, which at eps = 1 differs by
  orders of magnitude);
* ``Adam`` is ``optax.adam(lr)`` (eps 1e-8 outside the root, bias-corrected
  moments) and ``Momentum`` is ``optax.sgd(lr, momentum)`` (``t = g + mu*t``).

Each moment update is one multiply per term and one add, with no fused
multiply-add, in optax's order. The learning rate is the step-decay
schedule evaluated at the step before the update, in float32 like the JAX
package's; weight decay enters the loss, so it reaches every solver through
the gradient.

A step is split in two, so that the device part can be captured once as a
CUDA graph and replayed (``training/graphs.py``, the counterpart of the
JAX package's ``jax.jit(step, donate_argnums=(0,))``):

* the host part (:meth:`TrainStep.host_part`): the anchor-target draws
  from the state's CPU generator, the step's scalars ``[-lr, 1 -
  b1^count, 1 - b2^count]`` computed with numpy float32, bit-equal to
  optax's, and the bookkeeping (Adam's count and the step counter advance
  by one);
* the device part (:meth:`TrainStep.device_part`): anchor targets,
  forward, losses, backward, clip and update, reading the batch, the
  draws and the scalars as device tensors and no host value. It updates
  the parameters, the gradient buffers and the solver's moments in place
  (the counterpart of donation), and returns the metrics as one stacked
  tensor in the order of :data:`METRICS`.

The device part runs inside :func:`reproducible`: only kernels that give
the same result from the same inputs, so that a step is a function of its
state, batch and draws on the card as the JAX package's jitted step is on
its chip. Given the same batches, a resumed run retakes the steps it
resumes bit for bit; the data order is not in a checkpoint, in either
package (``RoIDataLayer`` reseeds its permutation from ``cfg.RNG_SEED``), so
on a dataset of more than one batch a resumed run sees other batches.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.utils.deterministic as det

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.ops.anchor_target import anchor_target_layer, num_anchors
from ctpn_tpu_torch.training.loss import ctpn_loss, decayed_parameters, weight_decay_loss
from ctpn_tpu_torch.utils.device import device_constant

# a cuBLAS workspace setting that PyTorch accepts as reproducible (32 MiB,
# PyTorch's own size on a Hopper card)
CUBLAS_WORKSPACE = ":4096:8"
MAX_GRAD_NORM = 10.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RMS_DECAY, RMS_EPS = 0.9, 1.0

# the loss's parts (averaged over data-parallel ranks), then the optimizer's
LOSS_METRICS = ("model_loss", "num_fg", "rpn_box_loss", "rpn_cls_loss", "total_loss")
METRICS = LOSS_METRICS + ("grad_norm", "update_norm")


@contextlib.contextmanager
def reproducible():
    """Kernels that give the same result from the same inputs inside this
    context: cuDNN's deterministic algorithms, chosen by its heuristics and
    not by timing (``cudnn.deterministic``, no ``benchmark``), and
    PyTorch's deterministic implementations (``use_deterministic_algorithms``:
    an op that has none raises). Memory that ``torch.empty`` hands out is
    not filled (nothing reads it before writing).

    ``CUBLAS_WORKSPACE_CONFIG`` is set to :data:`CUBLAS_WORKSPACE` if unset,
    since PyTorch's deterministic mode refuses cuBLAS without it. PyTorch
    reads that variable for the workspace size once, at the process's first
    cuBLAS call, and reads it again only for that check: set after cuBLAS
    is in use (detection ran first), it changes no workspace, and on a
    Hopper card its value is PyTorch's default size there anyway.

    The settings are process-wide, so they hold for any other thread while
    a step runs; they, the variable included, are restored on exit."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             det.fill_uninitialized_memory, os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    if saved[-1] is None:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        cudnn_det, bench, mode, warn_only, fill, workspace = saved
        torch.backends.cudnn.deterministic = cudnn_det
        torch.backends.cudnn.benchmark = bench
        torch.use_deterministic_algorithms(mode, warn_only=warn_only)
        det.fill_uninitialized_memory = fill
        if workspace is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


class Batch(NamedTuple):
    """One padded training batch, batch-major."""

    images: torch.Tensor  # (N, bh, bw, 3) uint8 BGR
    im_info: torch.Tensor  # (N, 3) float32
    gt_boxes: torch.Tensor  # (N, G, 4) float32
    gt_valid: torch.Tensor  # (N, G) bool
    gt_ishard: torch.Tensor  # (N, G) bool
    dontcare: torch.Tensor  # (N, D, 4) float32
    dontcare_valid: torch.Tensor  # (N, D) bool

    @classmethod
    def from_numpy(cls, arrays: Sequence[np.ndarray], pin: bool = False) -> "Batch":
        """Tensors sharing the arrays' memory; ``pin`` copies them into
        page-locked memory, so that the upload can be asynchronous."""
        ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        return cls(*(t.pin_memory() if pin else t for t in ts))

    def to(self, device, non_blocking: bool = False) -> "Batch":
        return Batch(*(t.to(device, non_blocking=non_blocking) for t in self))

    def rows(self, start: int, stop: int) -> "Batch":
        return Batch(*(t[start:stop] for t in self))


def make_lr_schedule(
    base_lr: Optional[float] = None,
    gamma: Optional[float] = None,
    stepsize: Optional[int] = None,
) -> Callable[[int], float]:
    """Step decay ``base * gamma^(step // stepsize)``, in float32."""
    base_lr = np.float32(cfg.TRAIN.LEARNING_RATE if base_lr is None else base_lr)
    gamma = np.float32(cfg.TRAIN.GAMMA if gamma is None else gamma)
    stepsize = int(cfg.TRAIN.STEPSIZE if stepsize is None else stepsize)

    def schedule(step: int) -> float:
        return float(base_lr * gamma ** np.float32(step // stepsize))

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


class Optimizer:
    """``optax.chain(clip_by_global_norm(10), solver(schedule))`` over a list
    of parameters, applied in place; the state is a dict of tensors (and
    Adam's ``count``, a Python int the host keeps)."""

    def __init__(self, solver: str, schedule: Callable[[int], float],
                 momentum: float = 0.9):
        if solver not in ("Adam", "RMS", "Momentum"):
            raise ValueError(f"unknown solver {solver}")
        self.solver = solver
        self.schedule = schedule
        self.momentum = momentum

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        if self.solver == "Adam":
            return {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.solver == "RMS":
            return {"nu": zeros()}
        return {"trace": zeros()}

    def scalars(self, state: Dict[str, Any], step: int) -> np.ndarray:
        """The update's host scalars at ``step`` (the count before it),
        float32: ``-lr`` and Adam's bias corrections ``1 - b^count`` for
        the count after the update (1 for the other solvers)."""
        neg_lr = -np.float32(self.schedule(step))
        bc1 = bc2 = np.float32(1)
        if self.solver == "Adam":
            count = np.float32(state["count"] + 1)
            bc1 = np.float32(1) - np.float32(ADAM_B1) ** count
            bc2 = np.float32(1) - np.float32(ADAM_B2) ** count
        return np.array([neg_lr, bc1, bc2], np.float32)

    def advance(self, state: Dict[str, Any]) -> None:
        """The host's share of an update: Adam's count."""
        if self.solver == "Adam":
            state["count"] += 1

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              state: Dict[str, Any], scalars: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update with the :meth:`scalars` tensor (on the parameters'
        device), writing the parameters and the moments in place; returns
        the raw gradients' global norm and the norm of the applied change."""
        neg_lr, bc1, bc2 = scalars[0], scalars[1], scalars[2]
        g_norm = global_norm(grads)
        clip = g_norm < MAX_GRAD_NORM
        grads = [torch.where(clip, g, (g / g_norm) * MAX_GRAD_NORM) for g in grads]
        updates = []
        if self.solver == "Adam":
            for g, mu, nu in zip(grads, state["mu"], state["nu"]):
                mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
                nu.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
                updates.append((mu / bc1) / ((nu / bc2).sqrt() + ADAM_EPS))
        elif self.solver == "RMS":
            for g, nu in zip(grads, state["nu"]):
                nu.copy_((1 - RMS_DECAY) * (g * g) + RMS_DECAY * nu)
                updates.append(torch.rsqrt(nu + RMS_EPS) * g)
        else:
            for g, trace in zip(grads, state["trace"]):
                trace.copy_(g + self.momentum * trace)
                updates.append(trace)
        deltas = []
        for p, u in zip(params, updates):
            new = p + neg_lr * u
            deltas.append(new - p)
            p.copy_(new)
        return g_norm, global_norm(deltas)


@dataclass
class TrainState:
    """What one training run carries from step to step. ``model`` may be
    wrapped in ``DistributedDataParallel``; ``gen`` (a CPU generator) makes
    the anchor-target draws, for the global batch on every rank. The
    tensors (parameters, their gradient buffers, the solver's moments) are
    updated in place and never replaced: a captured step holds them."""

    model: nn.Module
    opt: Optimizer
    opt_state: Dict[str, Any]
    step: int
    gen: torch.Generator


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor a step writes: parameters, gradient buffers (those that
    exist) and the solver's moments."""
    params = list(unwrap(state.model).parameters())
    grads = [p.grad for p in params if p.grad is not None]
    moments = [t for v in state.opt_state.values() if isinstance(v, list) for t in v]
    return params + grads + moments


def unwrap(model: nn.Module) -> nn.Module:
    """The ``CTPN`` inside a ``DistributedDataParallel`` wrapper."""
    return getattr(model, "module", model)


def make_optimizer(solver: Optional[str] = None) -> Optimizer:
    """Solver select + global-norm clip 10 (`train.py:95-109`)."""
    return Optimizer(solver or cfg.TRAIN.SOLVER, make_lr_schedule(),
                     momentum=cfg.TRAIN.MOMENTUM)


def create_train_state(model: nn.Module) -> TrainState:
    """A fresh state around ``model`` (its parameters as they are): the
    solver of ``cfg.TRAIN.SOLVER``, the draw generator seeded
    ``cfg.RNG_SEED``, and a zero gradient buffer for every parameter that
    has none."""
    opt = make_optimizer()
    params = list(unwrap(model).parameters())
    _grad_buffers(params)
    return TrainState(model=model, opt=opt, opt_state=opt.init(params),
                      step=0, gen=torch.Generator().manual_seed(cfg.RNG_SEED))


def _grad_buffers(params: Sequence[torch.Tensor]) -> None:
    """Static gradient buffers: each step zeroes them and its backward adds
    into them, so they are never replaced."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def target_kwargs() -> Dict[str, Any]:
    """``anchor_target_layer``'s settings from ``cfg.TRAIN``."""
    return dict(
        positive_overlap=cfg.TRAIN.RPN_POSITIVE_OVERLAP,
        negative_overlap=cfg.TRAIN.RPN_NEGATIVE_OVERLAP,
        fg_fraction=cfg.TRAIN.RPN_FG_FRACTION,
        rpn_batchsize=cfg.TRAIN.RPN_BATCHSIZE,
        dontcare_hi=cfg.TRAIN.DONTCARE_AREA_INTERSECTION_HI,
        inside_weights=tuple(cfg.TRAIN.RPN_BBOX_INSIDE_WEIGHTS),
        clobber_positives=cfg.TRAIN.RPN_CLOBBER_POSITIVES,
        preclude_hard=cfg.TRAIN.PRECLUDE_HARD_SAMPLES,
        ohem=bool(cfg.TRAIN.OHEM),
    )


class HostInputs(NamedTuple):
    """What a step's host part hands the device part: draws (2, B, K)
    float32 and scalars (3,) float32 on the CPU, and the learning rate the
    log reports."""

    draws: torch.Tensor
    scalars: torch.Tensor
    learning_rate: float


def to_device(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host tensor on ``dev``: on a card through pinned memory, without
    waiting for the card."""
    if dev.type == "cpu":
        return x
    return x.pin_memory().to(dev, non_blocking=True)


class TrainStep:
    """``step(state, batch, draws=None) -> metrics`` for one bucket; it
    updates ``state`` in place. ``batch`` is this rank's rows of the global
    batch, on the model's device; ``draws`` (2, B, K) overrides the
    generator's (tests feed the JAX package's draws this way). The metrics
    are 0-d tensors keyed by :data:`METRICS`, plus ``learning_rate``.

    Calling the step runs :meth:`host_part`, then :meth:`device_part`;
    ``training/graphs.py`` runs the same host part before a captured
    device part."""

    def __init__(self, model: nn.Module, feat_h: int, feat_w: int,
                 rank: int = 0, world: int = 1):
        self.model = model
        self.feat_h, self.feat_w = feat_h, feat_w
        self.rank, self.world = rank, world
        self.wd = float(cfg.TRAIN.WEIGHT_DECAY)
        self.at_kw = target_kwargs()
        self.ohem_bs = int(cfg.TRAIN.RPN_BATCHSIZE) if cfg.TRAIN.OHEM else None
        self.remat = bool(cfg.TPU.REMAT)
        self.pixel_means = tuple(float(v) for v in cfg.PIXEL_MEANS)
        inner = unwrap(model)
        self.params = list(inner.parameters())
        self.decay = decayed_parameters(inner)
        self.k = num_anchors(feat_h, feat_w)
        _grad_buffers(self.params)

    def host_part(self, state: TrainState, b: int,
                  draws: Optional[torch.Tensor] = None) -> HostInputs:
        """The draws for this rank's ``b`` rows (fg and bg draws for the
        global batch from ``state.gen``, unless given) and the scalars of
        the update at ``state.step``; then the host's bookkeeping of the
        step (Adam's count, the step counter), once per step taken."""
        if draws is None:
            draws = torch.rand((2, b * self.world, self.k), generator=state.gen)
            draws = draws[:, self.rank * b:(self.rank + 1) * b].contiguous()
        scalars = torch.from_numpy(state.opt.scalars(state.opt_state, state.step))
        host = HostInputs(draws, scalars, state.opt.schedule(state.step))
        state.opt.advance(state.opt_state)
        state.step += 1
        return host

    def device_part(self, state: TrainState, batch: Batch, draws: torch.Tensor,
                    scalars: torch.Tensor) -> torch.Tensor:
        """Anchor targets, forward, losses and L2 decay, backward, clip and
        the update, from device tensors only, inside :func:`reproducible`;
        returns the metrics stacked in the order of :data:`METRICS`."""
        with reproducible():
            return self._device_part(state, batch, draws, scalars)

    def _device_part(self, state: TrainState, batch: Batch, draws: torch.Tensor,
                     scalars: torch.Tensor) -> torch.Tensor:
        dev = batch.images.device
        with torch.no_grad():
            targets = anchor_target_layer(
                batch.gt_boxes, batch.gt_valid, batch.gt_ishard, batch.dontcare,
                batch.dontcare_valid, batch.im_info, draws[0], draws[1],
                self.feat_h, self.feat_w, **self.at_kw,
            )
        means = device_constant(("pixel_means", self.pixel_means), dev,
                                lambda: np.array(self.pixel_means, np.float32))
        # images arrive uint8 (wire format); normalise on the device
        x = batch.images.to(torch.float32) - means
        outs = self.model(x, remat=self.remat)
        model_loss, aux = ctpn_loss(outs.cls_score, outs.bbox_pred, targets,
                                    ohem_batchsize=self.ohem_bs)
        total = model_loss + weight_decay_loss(self.decay, self.wd)
        aux["total_loss"] = total
        del outs, targets
        grads = [p.grad for p in self.params]
        for g in grads:
            g.zero_()  # backward adds into the buffers: 0 + g is exact
        total.backward()
        losses = torch.stack([aux[key].detach() for key in LOSS_METRICS])
        if self.world > 1:  # each rank's losses cover its rows: average them
            import torch.distributed as dist

            dist.all_reduce(losses)
            losses = losses / self.world
        grad_norm, update_norm = state.opt.apply(self.params, grads, state.opt_state,
                                                 scalars)
        return torch.cat([losses, torch.stack([grad_norm, update_norm])])

    @staticmethod
    def metrics(vec: torch.Tensor, learning_rate: float) -> Dict[str, Any]:
        """The stacked metrics as a dict of 0-d tensors, plus the learning
        rate."""
        out: Dict[str, Any] = dict(zip(METRICS, vec.unbind()))
        out["learning_rate"] = learning_rate
        return out

    def __call__(self, state: TrainState, batch: Batch,
                 draws: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        dev = batch.images.device
        host = self.host_part(state, batch.images.shape[0], draws)
        vec = self.device_part(state, batch, to_device(host.draws, dev),
                               to_device(host.scalars, dev))
        return self.metrics(vec, host.learning_rate)


def build_train_step(model: nn.Module, feat_h: int, feat_w: int,
                     rank: int = 0, world: int = 1) -> TrainStep:
    """The :class:`TrainStep` of one bucket (feature extent ``feat_h`` x
    ``feat_w``), read from ``cfg`` now."""
    return TrainStep(model, feat_h, feat_w, rank, world)
