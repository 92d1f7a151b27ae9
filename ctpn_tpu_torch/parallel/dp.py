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

Detection (``shard_detect_fn``, the counterpart of the JAX
``shard_detect_fn``) needs no collective: the weights are replicated once
per device, one worker thread per replica stages its dim-0 slice of the
batch in pinned host memory and replays that replica's captured detect
program (``inference/graphs.py``) on its own stream, and the outputs are
gathered on the first device in batch order. No step waits for a card, so
the replicas run at once.
"""

from __future__ import annotations

import copy
import os
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ctpn_tpu_torch.inference.graphs import DetectGraphs
from ctpn_tpu_torch.ops.proposal import Proposals
from ctpn_tpu_torch.parallel.mesh import as_devices, data_devices, split_batch
from ctpn_tpu_torch.postprocess.connector import TextLines
from ctpn_tpu_torch.utils.device import full_f32_matmul

if TYPE_CHECKING:  # the frozen loader imports this module: no training code
    from ctpn_tpu_torch.training.train_step import Batch


def env_world_size() -> int:
    """The world size ``torchrun`` gave this process (1 outside it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_data_parallel(device: torch.device) -> Tuple[int, int]:
    """Join the process group ``torchrun`` describes (NCCL on CUDA, gloo on
    the CPU); returns (rank, world size). A CUDA rank binds the group to
    ``device``, the card of its ``LOCAL_RANK``."""
    if not dist.is_initialized():
        if device.type == "cuda":
            dist.init_process_group("nccl", device_id=device)
        else:
            dist.init_process_group("gloo")
    return dist.get_rank(), dist.get_world_size()


def wrap_model(model: nn.Module, device: torch.device) -> nn.Module:
    """``model`` under ``DistributedDataParallel`` (gradients averaged). On
    a card the wrapper is built on a side stream, as PyTorch requires of a
    DDP model whose backward is captured in a CUDA graph
    (``training/graphs.py``)."""
    from torch.nn.parallel import DistributedDataParallel

    if device.type != "cuda":
        return DistributedDataParallel(model)
    caller = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        ddp = DistributedDataParallel(model, device_ids=[device.index])
    caller.wait_stream(side)
    return ddp


def shard_batch(batch: Batch, rank: int, world: int) -> Batch:
    """This rank's dim-0 slice of the global batch."""
    n = batch.images.shape[0]
    if n % world:
        raise ValueError(f"global batch {n} does not split over {world} ranks")
    per = n // world
    return batch.rows(rank * per, (rank + 1) * per)


# ------------------------------------------------------------- detection


def replicate_model(model: nn.Module,
                    devices: Sequence[Union[str, torch.device]]) -> Dict[torch.device, nn.Module]:
    """``{device: copy of model on it}``, one copy of the weights per
    distinct device (replicas named twice on one device share it: the
    detect program does not mutate the model)."""
    out: Dict[torch.device, nn.Module] = {}
    for dev in as_devices(devices):
        if dev not in out:
            out[dev] = copy.deepcopy(model).to(dev).eval()
    return out


def shard_detect_fn(
    make_detect: Callable[[torch.device], Callable],
    devices: Sequence[Union[str, torch.device]] = None,
) -> Callable[[np.ndarray, np.ndarray], Tuple[Proposals, TextLines]]:
    """Batch-sharded detection over ``devices`` (default: every visible
    card, ``mesh.data_devices()``).

    ``make_detect(device)`` returns ``detect(images, im_info) ->
    (Proposals, TextLines)`` for tensors on ``device`` (for instance
    ``pipeline.build_detect_fn`` of that device's replica from
    :func:`replicate_model`); it is called once per entry of ``devices``.
    The returned ``fn(images, im_info)`` takes the global host batch
    ((N, H, W, 3) uint8 and (N, 3), N divisible by the device count), runs
    replica k on the k-th dim-0 slice and returns the outputs gathered on
    ``devices[0]`` in batch order. ``fn.close()`` stops its threads.

    Each replica is a :class:`~ctpn_tpu_torch.inference.graphs.DetectGraphs`
    of its own (``fn.replicas``): on a card its own stream and graph memory
    pool (two replicas on one card share neither), its slice staged in
    pinned memory, its graph replayed; on the CPU the eager program. The
    gather copies are ordered on the streams, with no host wait. Replica k
    always runs in the same worker thread of its own: cuDNN keeps its
    chosen execution plans per thread, so a new thread per call would
    choose them again on every call. TF32 matmuls are off from before the
    workers start until after they join (``utils/device.py::full_f32_matmul``,
    whose flag is global to the process), so every replica runs its
    BiLSTM's matmuls in the same precision whichever thread is inside.
    """
    devices = as_devices(data_devices() if devices is None else devices)
    replicas = [DetectGraphs(make_detect(dev), dev) for dev in devices]
    workers = [ThreadPoolExecutor(1, thread_name_prefix=f"replica{k}")
               for k in range(len(devices))]

    def detect(images, im_info) -> Tuple[Proposals, TextLines]:
        n = len(devices)
        xs, infos = split_batch(images, n), split_batch(im_info, n)
        with full_f32_matmul():
            futures = [workers[k].submit(replicas[k], xs[k], infos[k]) for k in range(n)]
            outs = [f.result() for f in futures]
        home = devices[0]
        props = Proposals(*(torch.cat([o[0][i].to(home, non_blocking=True) for o in outs])
                            for i in range(len(Proposals._fields))))
        lines = TextLines(*(torch.cat([o[1][i].to(home, non_blocking=True) for o in outs])
                            for i in range(len(TextLines._fields))))
        return props, lines

    def close() -> None:
        for w in workers:
            w.shutdown()

    detect.devices = devices
    detect.replicas = replicas
    detect.close = close
    return detect
