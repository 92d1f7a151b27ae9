"""Network factory (port of ``ctpn_tpu.models.factory``): string dispatch
kept for reference API parity, configured from the global cfg."""

from __future__ import annotations

from typing import Union

import torch

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.models.craft import CRAFT
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.models.dbnet import DBNet
from ctpn_tpu_torch.models.east import EAST
from ctpn_tpu_torch.utils.device import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


EAST_NAMES = ("EAST_VGG16",)
CRAFT_NAMES = ("CRAFT_VGG16_BN",)
DB_NAMES = ("DB_RESNET50_DCN",)


def get_network(name: str, device: Union[str, torch.device] = "cuda") -> torch.nn.Module:
    """A randomly initialised ``CTPN``, ``EAST`` for ``EAST_VGG16``
    (``models/east.py``), ``CRAFT`` for ``CRAFT_VGG16_BN``
    (``models/craft.py``) or ``DBNet`` for ``DB_RESNET50_DCN``
    (``models/dbnet.py``), on ``device``, in eval mode.

    ``TPU.FUSED_STEM`` routes block 1 of the test network (inference only)
    through the fused stem kernel. ``TPU.PACKED_STEM`` needs nothing: the packed block equals the
    stock convs, which run either way. The test network runs its stride-16
    convs one image at a time (``CTPN``'s ``per_image_tail``), so that a
    served image's records do not depend on its slot in the padded batch.
    """
    if name not in ("VGGnet_train", "VGGnet_test", "ctpn") + EAST_NAMES + CRAFT_NAMES + DB_NAMES:
        raise KeyError(f"Unknown network: {name}")
    dev = resolve_device(device)
    if DTYPES.get(cfg.TPU.PARAM_DTYPE) is not torch.float32:
        raise ValueError(f"TPU.PARAM_DTYPE must be float32, got {cfg.TPU.PARAM_DTYPE}")
    if name in EAST_NAMES:
        # block 5 and the merge branch one image at a time (models/east.py)
        east = EAST(dtype=DTYPES[cfg.TPU.COMPUTE_DTYPE], per_image_tail=True)
        return east.to(dev).eval()
    if name in CRAFT_NAMES:
        # block 5 one image at a time (models/craft.py)
        craft = CRAFT(dtype=DTYPES[cfg.TPU.COMPUTE_DTYPE], per_image_tail=True)
        return craft.to(dev).eval()
    if name in DB_NAMES:
        # stage 2's offset convs one image at a time (models/resnet.py)
        db = DBNet(dtype=DTYPES[cfg.TPU.COMPUTE_DTYPE])
        return db.to(dev).eval()
    model = CTPN(
        dtype=DTYPES[cfg.TPU.COMPUTE_DTYPE],
        fused_stem=bool(cfg.TPU.FUSED_STEM) and name == "VGGnet_test",
        per_image_tail=name == "VGGnet_test",
    )
    return model.to(dev).eval()


def init_params(seed: int = 0) -> dict:
    """Random weights of ``VGGnet_test`` as a JAX-layout parameter tree
    (nested numpy), drawn on the CPU from a ``torch.Generator`` seeded
    ``seed``, so every device gets the same weights: kernels by PyTorch's
    default ``kaiming_uniform_(a=sqrt(5))``, the recurrent weights
    orthogonal, biases zero (flax's default)."""
    import math

    import torch.nn as nn

    from ctpn_tpu_torch.utils.weights import params_to_jax

    with torch.device("meta"):  # no draw from the global generator
        model = CTPN(dtype=DTYPES[cfg.TPU.COMPUTE_DTYPE])
    model = model.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("w_h_fw", "w_h_bw")):
                nn.init.orthogonal_(p, generator=gen)
            elif p.ndim > 1:
                nn.init.kaiming_uniform_(p, a=math.sqrt(5), generator=gen)
            else:
                p.zero_()
    return params_to_jax(model.state_dict())
