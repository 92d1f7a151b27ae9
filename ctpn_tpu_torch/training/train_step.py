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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.ops.anchor_target import anchor_target_layer, num_anchors
from ctpn_tpu_torch.training.loss import ctpn_loss, decayed_parameters, weight_decay_loss

MAX_GRAD_NORM = 10.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RMS_DECAY, RMS_EPS = 0.9, 1.0


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


def _f32(x: float) -> float:
    return float(np.float32(x))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


class Optimizer:
    """``optax.chain(clip_by_global_norm(10), solver(schedule))`` over a list
    of parameters, applied in place; the state is a dict of tensors."""

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

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              state: Dict[str, Any], step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update at ``step`` (the count before it); returns the raw
        gradients' global norm and the norm of the applied change."""
        g_norm = global_norm(grads)
        clip = g_norm < MAX_GRAD_NORM
        grads = [torch.where(clip, g, (g / g_norm) * MAX_GRAD_NORM) for g in grads]
        neg_lr = -_f32(self.schedule(step))
        if self.solver == "Adam":
            state["count"] += 1
            count = np.float32(state["count"])
            bc1 = _f32(np.float32(1) - np.float32(ADAM_B1) ** count)
            bc2 = _f32(np.float32(1) - np.float32(ADAM_B2) ** count)
            updates = []
            for i, g in enumerate(grads):
                mu = (1 - ADAM_B1) * g + ADAM_B1 * state["mu"][i]
                nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state["nu"][i]
                state["mu"][i], state["nu"][i] = mu, nu
                updates.append((mu / bc1) / ((nu / bc2).sqrt() + ADAM_EPS))
        elif self.solver == "RMS":
            updates = []
            for i, g in enumerate(grads):
                nu = (1 - RMS_DECAY) * (g * g) + RMS_DECAY * state["nu"][i]
                state["nu"][i] = nu
                updates.append(torch.rsqrt(nu + RMS_EPS) * g)
        else:
            updates = []
            for i, g in enumerate(grads):
                state["trace"][i] = g + self.momentum * state["trace"][i]
                updates.append(state["trace"][i])
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
    the anchor-target draws, for the global batch on every rank."""

    model: nn.Module
    opt: Optimizer
    opt_state: Dict[str, Any]
    step: int
    gen: torch.Generator


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
    ``cfg.RNG_SEED``."""
    opt = make_optimizer()
    return TrainState(model=model, opt=opt,
                      opt_state=opt.init(list(unwrap(model).parameters())),
                      step=0, gen=torch.Generator().manual_seed(cfg.RNG_SEED))


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


def build_train_step(model: nn.Module, feat_h: int, feat_w: int,
                     rank: int = 0, world: int = 1):
    """``step(state, batch, draws=None) -> metrics`` for one bucket; it
    updates ``state`` in place. ``batch`` is this rank's rows of the global
    batch; ``draws`` (2, B, K) overrides the generator's (tests feed the JAX
    package's draws this way)."""
    wd = float(cfg.TRAIN.WEIGHT_DECAY)
    at_kw = target_kwargs()
    ohem_bs = int(cfg.TRAIN.RPN_BATCHSIZE) if cfg.TRAIN.OHEM else None
    remat = bool(cfg.TPU.REMAT)
    pixel_means = torch.tensor(cfg.PIXEL_MEANS, dtype=torch.float32)
    inner = unwrap(model)
    params = list(inner.parameters())
    decay = decayed_parameters(inner)
    k = num_anchors(feat_h, feat_w)

    def step(state: TrainState, batch: Batch,
             draws: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        dev = batch.images.device
        b = batch.images.shape[0]
        if draws is None:  # fg and bg draws for the global batch, on the CPU
            draws = torch.rand((2, b * world, k), generator=state.gen)
            draws = draws[:, rank * b:(rank + 1) * b]
        draws = draws.to(dev)
        with torch.no_grad():
            targets = anchor_target_layer(
                batch.gt_boxes, batch.gt_valid, batch.gt_ishard, batch.dontcare,
                batch.dontcare_valid, batch.im_info, draws[0], draws[1],
                feat_h, feat_w, **at_kw,
            )
        # images arrive uint8 (wire format); normalise on the device
        x = batch.images.to(torch.float32) - pixel_means.to(dev)
        outs = model(x, remat=remat)
        model_loss, aux = ctpn_loss(outs.cls_score, outs.bbox_pred, targets,
                                    ohem_batchsize=ohem_bs)
        total = model_loss + weight_decay_loss(decay, wd)
        aux["total_loss"] = total
        del outs, targets
        for p in params:
            p.grad = None
        total.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        metrics = {key: v.detach() for key, v in aux.items()}
        if world > 1:  # each rank's losses cover its rows: average them
            import torch.distributed as dist

            vec = torch.stack([metrics[key] for key in sorted(metrics)])
            dist.all_reduce(vec)
            metrics = dict(zip(sorted(metrics), vec / world))
        grad_norm, update_norm = state.opt.apply(params, grads, state.opt_state,
                                                 state.step)
        metrics.update(grad_norm=grad_norm, update_norm=update_norm,
                       learning_rate=state.opt.schedule(state.step))
        state.step += 1
        return metrics

    return step
