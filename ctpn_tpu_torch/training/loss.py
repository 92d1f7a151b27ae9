"""CTPN training losses (port of ``ctpn_tpu.training.loss``; reference
``Network.build_loss``, `lib/networks/network.py:376-409`).

* classification: softmax cross-entropy over the (bg, fg) logits of every
  anchor with label != -1, mean over those anchors;
* box: smooth-L1 with sigma^2 = 9 (`network.py:367-372`) of
  ``inside_w * (pred - target)``, row-summed, weighted by ``outside_w``,
  summed and divided by (num_fg + 1);
* both averaged over the images of the batch;
* total: model loss + ``wd * 0.5 * sum(w^2)`` over the parameters that are
  ``kernel`` leaves in the JAX layout, except the LSTM's input and
  recurrent weights (TF ``l2_loss`` semantics; tf.contrib.rnn cells were
  never regularised). Biases never decay.

Every reduction is mask-based, batched on the leading axis.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn as nn

from ctpn_tpu_torch.ops.anchor_target import AnchorTargets
from ctpn_tpu_torch.utils.weights import jax_key

# JAX parameter-path fragments that never decay (the LSTM cell weights)
_NO_DECAY = ("input_proj", "w_h_fw", "w_h_bw")


def smooth_l1(x: torch.Tensor, sigma2: float = 9.0) -> torch.Tensor:
    """Elementwise smooth-L1 with the reference's sigma^2 parameterisation."""
    ax = x.abs()
    return torch.where(ax < 1.0 / sigma2, 0.5 * sigma2 * x * x, ax - 0.5 / sigma2)


def ctpn_loss(
    cls_score: torch.Tensor,  # (B, H, W, A*2) logits
    bbox_pred: torch.Tensor,  # (B, H, W, A*4)
    targets: AnchorTargets,  # (B, H, W, ...)
    sigma2: float = 9.0,
    ohem_batchsize: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Model loss (cls + box) averaged over images, and its parts.

    ``ohem_batchsize``: online hard example mining. The anchor-target layer
    left every negative labelled 0; :func:`ohem_keep` keeps the
    (ohem_batchsize - num_fg) negatives of highest cross-entropy.
    """
    b = cls_score.shape[0]
    logits = cls_score.reshape(b, -1, 2)
    lbl = targets.labels.reshape(b, -1)
    keep = lbl != -1
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, 2, lbl.clamp(min=0).long()[:, :, None])[:, :, 0]
    is_fg = lbl == 1
    if ohem_batchsize is not None:
        keep = ohem_keep(ce.detach(), lbl, ohem_batchsize)
    n_keep = keep.to(torch.float32).sum(dim=1).clamp(min=1.0)
    cls_l = torch.where(keep, ce, 0.0).sum(dim=1) / n_keep

    pred4 = bbox_pred.reshape(b, -1, 4)
    tgt4 = targets.bbox_targets.reshape(b, -1, 4)
    biw4 = targets.bbox_inside_weights.reshape(b, -1, 4)
    bow4 = targets.bbox_outside_weights.reshape(b, -1, 4)
    per_row = (bow4 * smooth_l1(biw4 * (pred4 - tgt4), sigma2)).sum(dim=2)
    n_fg = is_fg.to(torch.float32).sum(dim=1)
    box_l = torch.where(keep, per_row, 0.0).sum(dim=1) / (n_fg + 1.0)

    cls_loss = cls_l.mean()
    box_loss = box_l.mean()
    model_loss = cls_loss + box_loss
    aux = {
        "rpn_cls_loss": cls_loss,
        "rpn_box_loss": box_loss,
        "model_loss": model_loss,
        "num_fg": n_fg.mean(),
    }
    return model_loss, aux


def ohem_keep(ce: torch.Tensor, lbl: torch.Tensor, batchsize: int) -> torch.Tensor:
    """(B, K) mask of the anchors OHEM keeps: every fg, and the
    (batchsize - num_fg) negatives of highest ``ce``, ranked by a stable
    double argsort of ``-ce`` (equal losses keep the lower index first)."""
    is_fg, is_bg = lbl == 1, lbl == 0
    neg_ce = torch.where(is_bg, ce, -torch.inf)
    rank = torch.argsort(torch.argsort(-neg_ce, dim=1, stable=True), dim=1, stable=True)
    n_fg = is_fg.sum(dim=1, keepdim=True)
    return is_fg | (is_bg & (rank < batchsize - n_fg))


def decayed(name: str) -> bool:
    """Whether the parameter ``name`` (a ``CTPN`` state-dict key) decays:
    its JAX path names a ``kernel`` outside the LSTM cell."""
    path = jax_key(name)
    return "kernel" in path and not any(frag in path for frag in _NO_DECAY)


def decayed_parameters(model: nn.Module) -> List[torch.Tensor]:
    return [p for name, p in model.named_parameters() if decayed(name)]


def weight_decay_loss(params: Iterable[torch.Tensor], wd: float) -> torch.Tensor:
    """TF-style L2: ``wd * 0.5 * sum(w^2)`` over ``params`` (pass
    :func:`decayed_parameters`)."""
    return wd * sum(0.5 * p.float().square().sum() for p in params)
