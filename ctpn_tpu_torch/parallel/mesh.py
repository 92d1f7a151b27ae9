"""The devices of a data-parallel run and the batch's split over them (port
of ``ctpn_tpu.parallel.mesh``).

The JAX package builds a 1-D mesh over the local devices and lets XLA
shard dim 0 of the batch over it. Here the devices are a plain list of
``torch.device`` and the batch is cut into one dim-0 slice per entry, in
order; ``parallel/dp.py`` runs one replica per entry.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ctpn_tpu_torch.utils.device import resolve_device


def data_devices(n: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda") -> List[torch.device]:
    """The first ``n`` visible cards (all of them when ``n`` is None).

    Without CUDA it raises, as ``utils/device.py::resolve_device`` does, and
    asking for more cards than are visible raises ``RuntimeError``: no
    path fills a short list with the CPU. ``device="cpu"`` returns ``n``
    replicas on the CPU (``n`` is then required); several replicas on one
    device are allowed anywhere a device list is taken, and the tests run
    that way.
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        if n is None:
            raise ValueError("data_devices(device='cpu') needs the replica count n")
        return [dev] * n
    if dev.type != "cuda":
        raise ValueError(f"data_devices: unsupported device type {dev.type!r}")
    visible = torch.cuda.device_count()
    n = visible if n is None else n
    if n > visible:
        raise RuntimeError(f"dp_devices={n} but only {visible} devices visible")
    return [torch.device("cuda", i) for i in range(n)]


def as_devices(devices: Sequence[Union[str, torch.device]]) -> List[torch.device]:
    """``devices`` as ``torch.device``s, a bare ``"cuda"`` read as card 0."""
    out = []
    for d in devices:
        d = torch.device(d)
        out.append(torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d)
    return out


def split_batch(x: Union[np.ndarray, torch.Tensor], n: int) -> list:
    """The ``n`` equal dim-0 slices of ``x``, in order."""
    total = int(x.shape[0])
    if total % n:
        raise ValueError(f"batch {total} not divisible by dp_devices={n}")
    per = total // n
    return [x[k * per:(k + 1) * per] for k in range(n)]
