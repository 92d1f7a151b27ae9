"""Device selection for the port's entry points, host constants kept on
the device, and the process's float32 matmul precision."""

from __future__ import annotations

import contextlib
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


# ``allow_tf32`` is one flag for the whole process: the contexts of all
# threads count their depth here, so a thread leaving its context does not
# switch TF32 back on under another thread that is still inside one
_f32_lock = threading.Lock()
_f32_depth = 0
_f32_saved = False


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matmuls in full precision on the card (no TF32) while any
    thread is inside this context; the flag is restored when the last one
    leaves."""
    global _f32_depth, _f32_saved
    with _f32_lock:
        if _f32_depth == 0:
            _f32_saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _f32_depth += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_depth -= 1
            if _f32_depth == 0:
                torch.backends.cuda.matmul.allow_tf32 = _f32_saved
