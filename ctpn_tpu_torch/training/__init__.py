"""Training: anchor-target losses, the train step and its solvers, the
solver loop and its checkpoints."""

from ctpn_tpu_torch.training.loss import ctpn_loss, smooth_l1  # noqa: F401
