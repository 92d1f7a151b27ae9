"""Device selection for the port's entry points, and host constants kept on
the device."""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable, Tuple, Union

import numpy as np
import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Asking for CUDA on a machine without it raises: the entry points never
    drop to the CPU quietly.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU"
        )
    return dev


_constants: Dict[Tuple[Hashable, torch.device], torch.Tensor] = {}
_constants_lock = threading.Lock()


def device_constant(key: Hashable, device: torch.device,
                    make: Callable[[], np.ndarray]) -> torch.Tensor:
    """The host array ``make()`` as a tensor on ``device``, uploaded once
    per (``key``, device) and kept for the life of the process.

    The detect program reads a few host constants (the pixel means, the
    anchor grid of a feature shape). Uploaded on every call, each would be
    a copy from pageable host memory, which waits for the card to drain (a
    host sync) and which a CUDA graph capture refuses. ``key`` must name
    everything ``make`` depends on. While ``torch.export`` traces (or
    anything compiles) nothing is cached: the tracer's tensors are not
    real, and the exported program keeps the constant as its own, made on
    ``device`` (a constant made on the host would be copied to the card
    on every run).
    """
    if torch.compiler.is_compiling():
        return torch.tensor(np.array(make()), device=device)
    with _constants_lock:
        t = _constants.get((key, device))
        if t is None:
            t = torch.from_numpy(np.array(make())).to(device)
            _constants[(key, device)] = t
        return t
