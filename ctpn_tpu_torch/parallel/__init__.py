"""Data parallelism: DDP training over ``torch.distributed`` and
batch-sharded detection over a list of devices."""

from ctpn_tpu_torch.parallel.dp import (  # noqa: F401
    replicate_model,
    shard_batch,
    shard_detect_fn,
    wrap_model,
)
from ctpn_tpu_torch.parallel.mesh import data_devices, split_batch  # noqa: F401
