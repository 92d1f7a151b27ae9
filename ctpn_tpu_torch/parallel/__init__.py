"""Data-parallel training over ``torch.distributed``."""

from ctpn_tpu_torch.parallel.dp import shard_batch, wrap_model  # noqa: F401
