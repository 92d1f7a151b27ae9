"""Data-parallel training with ``torch.distributed`` (port of
``ctpn_tpu.parallel.dp`` and the part of ``parallel/mesh.py`` it needs).

The JAX package replicates the state over a device mesh and shards the
batch on dim 0, and XLA inserts the gradient all-reduce. Here each rank is
a process (started by ``torchrun``, which sets ``RANK``, ``WORLD_SIZE`` and
``MASTER_ADDR``/``MASTER_PORT``), the model is wrapped in
``DistributedDataParallel``, which averages the gradients, and each rank
takes its dim-0 slice of the global batch. The train step makes the
anchor-target draws for the global batch from a generator every rank
seeds alike and slices them the same way, so N ranks give the update of
one process on the whole batch.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from ctpn_tpu_torch.training.train_step import Batch


def env_world_size() -> int:
    """The world size ``torchrun`` gave this process (1 outside it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_data_parallel(device: torch.device) -> Tuple[int, int]:
    """Join the process group ``torchrun`` describes (NCCL on CUDA, gloo on
    the CPU); returns (rank, world size). A CUDA rank uses the card of its
    ``LOCAL_RANK``."""
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return dist.get_rank(), dist.get_world_size()


def wrap_model(model: nn.Module, device: torch.device) -> nn.Module:
    """``model`` under ``DistributedDataParallel`` (gradients averaged)."""
    from torch.nn.parallel import DistributedDataParallel

    ids = [device.index] if device.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=ids)


def shard_batch(batch: Batch, rank: int, world: int) -> Batch:
    """This rank's dim-0 slice of the global batch."""
    n = batch.images.shape[0]
    if n % world:
        raise ValueError(f"global batch {n} does not split over {world} ranks")
    per = n // world
    return batch.rows(rank * per, (rank + 1) * per)
