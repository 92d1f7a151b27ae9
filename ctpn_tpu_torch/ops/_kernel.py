"""The seam of the hand-written kernels: entry points, launches, op
registration and the registry of counted kernels.

A kernel module keeps what is its own (the input checks, the plain
version, the outputs it allocates, the arguments of its entry point and
the fake's shapes) and hands the rest to this module:

* :class:`Entry` is a C entry point ``ctpn_<name>`` of
  ``ops/csrc/<source>``: built (``_build``), loaded and declared once per
  process, at its first launch. Calling it launches the kernel on a
  device's current stream, raises ``RuntimeError`` naming the kernel on a
  non-zero CUDA error, and counts the launch on the wrapper that
  :meth:`Entry.counts` named (``_launches``: a launch made during a CUDA
  graph capture goes to the capture's recording, and each replay adds it).
* :func:`op` defines an op ``ctpn_torch::...`` in this module's one
  ``torch.library.Library``: the CPU kernel is the plain version, the CUDA
  kernel launches the hand-written kernel or raises, and the fake gives the
  shapes that ``torch.export`` traces with.
* :func:`registry` is every counted kernel by the name the certificates
  print (``nms_fused``, ``conv_epilogue``, ...). It imports the kernel
  modules, listed in :data:`MODULES` and nowhere else, so that it is
  whole, and so that every op is registered (a loaded ``torch.export``
  program resolves its kernel nodes through the registrations).
"""

from __future__ import annotations

import ctypes
import importlib
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ctpn_tpu_torch.ops import _build, _launches

# argument types of the entry points; every entry takes the stream last
PTR, INT, FLOAT, DOUBLE = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double

# the modules of the counted kernels; importing one registers its kernels
MODULES = ("nms_fused", "nms_bitmask", "nms_resolve", "stem_fused", "conv_epilogue",
           "chain_walk", "successors", "lanms", "quad_nms", "ccl", "craft_boxes",
           "resize_concat", "deform_conv", "db_boxes", "residual_epilogue")

_LIB = torch.library.Library("ctpn_torch", "FRAGMENT")
_REGISTRY: Dict[str, "Entry"] = {}


class Entry:
    """The C entry point ``ctpn_<name>`` of ``ops/csrc/<source>`` (``name``
    by default), taking ``argtypes`` and then the stream and returning a
    CUDA error code."""

    def __init__(self, name: str, argtypes: Sequence, source: Optional[str] = None):
        self.name = name
        self.source = source or name
        self.argtypes = [*argtypes, PTR]
        self.wrapper: Optional[Callable] = None
        self._fn = None

    def counts(self, wrapper: Callable) -> Callable:
        """Count this kernel's launches on ``wrapper`` (its ``LAUNCHES`` and
        ``LAUNCHES_BY_DEVICE``, set to zero here) and list it in the
        registry; returns ``wrapper`` itself (a decorator)."""
        _launches.init(wrapper)
        self.wrapper = wrapper
        _REGISTRY[self.name] = self
        return wrapper

    def _function(self):
        if self._fn is None:
            fn = getattr(_build.load(self.source), f"ctpn_{self.name}")
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream: a tensor passes as its data
        pointer, None as a null pointer. Raises ``RuntimeError`` on a
        non-zero return, and counts nothing then."""
        fn = self._function()
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err}")
        if self.wrapper is not None:
            _launches.count(self.wrapper, device)


def op(schema: str, cpu: Callable, cuda: Callable, fake: Optional[Callable] = None) -> None:
    """Define ``ctpn_torch::<schema>``, one node in an exported program: CPU
    tensors run ``cpu``, CUDA tensors ``cuda``, and ``fake`` gives the
    shapes under ``torch.export``."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    if fake is not None:
        torch.library.register_fake(f"ctpn_torch::{name}", fake, lib=_LIB)


def registry() -> Dict[str, Entry]:
    """Every counted kernel's :class:`Entry` by name, each kernel module
    imported."""
    for module in MODULES:
        importlib.import_module(f"ctpn_tpu_torch.ops.{module}")
    return dict(_REGISTRY)


def wrappers() -> Dict[str, Callable]:
    """Every counted kernel's wrapper by name: its ``LAUNCHES`` counts the
    kernel's launches."""
    return {name: entry.wrapper for name, entry in registry().items()}


def sources() -> List[str]:
    """The sources under ``ops/csrc/`` of the counted kernels: the list to
    build them all at once (``_build.build``)."""
    return sorted({entry.source for entry in registry().values()})
