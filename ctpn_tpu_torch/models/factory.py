"""Network factory (port of ``ctpn_tpu.models.factory``): string dispatch
kept for reference API parity, configured from the global cfg."""

from __future__ import annotations

from typing import Union

import torch

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.utils.device import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def get_network(name: str, device: Union[str, torch.device] = "cuda") -> CTPN:
    """A randomly initialised ``CTPN`` on ``device``, in eval mode.

    ``TPU.FUSED_STEM`` on the test network raises until the stem kernel is
    ported. ``TPU.PACKED_STEM`` needs nothing: the packed block equals the
    stock convs, which run either way.
    """
    if name not in ("VGGnet_train", "VGGnet_test", "ctpn"):
        raise KeyError(f"Unknown network: {name}")
    dev = resolve_device(device)
    if DTYPES.get(cfg.TPU.PARAM_DTYPE) is not torch.float32:
        raise ValueError(f"TPU.PARAM_DTYPE must be float32, got {cfg.TPU.PARAM_DTYPE}")
    model = CTPN(
        dtype=DTYPES[cfg.TPU.COMPUTE_DTYPE],
        fused_stem=bool(cfg.TPU.FUSED_STEM) and name == "VGGnet_test",
    )
    return model.to(dev).eval()
