"""Weight IO: the shipped ``.npz`` artifact and the JAX parameter layout.

The artifact (``data/artifacts/ctpn_synth_f16.npz``) stores the JAX model's
parameter tree as flat ``a/b/c`` keys in float16, in flax layouts: conv
kernels HWIO, Dense kernels ``(in, out)``. :func:`params_from_jax` carries
such a tree into this package's ``state_dict``: conv HWIO -> OIHW, Dense
``(in, out)`` -> ``Linear``-style ``(out, in)``. The BiLSTM keeps its fused
input projection as one ``(8*hidden, C)`` weight (forward gates are rows
``[0, 4*hidden)``, backward ``[4*hidden, 8*hidden)``) and its recurrent
weights ``w_h_fw``/``w_h_bw`` in the ``h @ w_h`` layout ``(hidden, 4*hidden)``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch

from ctpn_tpu_torch.utils.device import resolve_device

_TRUNK_SCOPE = "VGG16Trunk_0"

ArrayLike = Union[np.ndarray, torch.Tensor]


def load_params(
    artifact: str, device: Union[str, torch.device] = "cuda"
) -> Dict[str, torch.Tensor]:
    """Load an ``.npz`` artifact: flat ``a/b/c`` keys -> float32 tensors on
    ``device`` (float16 storage widens to float32, as the JAX loader does)."""
    dev = resolve_device(device)
    if not artifact.endswith(".npz"):
        raise ValueError(f"expected an .npz artifact, got {artifact}")
    with np.load(artifact) as flat:
        return {
            k: torch.from_numpy(flat[k].astype(np.float32)).to(dev)
            for k in flat.files
        }


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _as_tensor(v: ArrayLike) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32))


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX parameter tree -> this package's ``CTPN`` ``state_dict``.

    ``params`` is either the flat ``a/b/c`` dict of :func:`load_params` or
    the nested flax tree (``model.init(...)["params"]``); leaves may be
    numpy arrays, tensors or anything ``np.asarray`` accepts.
    """
    state: Dict[str, torch.Tensor] = {}
    for key, value in _flatten(params):
        path = key.split("/")
        if path[0] == _TRUNK_SCOPE:
            path[0] = "trunk"
        t = _as_tensor(value)
        if path[-1] == "kernel":
            path[-1] = "weight"
            if t.ndim == 4:  # conv HWIO -> OIHW
                t = t.permute(3, 2, 0, 1)
            elif t.ndim == 2:  # Dense (in, out) -> Linear (out, in)
                t = t.t()
            else:
                raise ValueError(f"unexpected kernel rank {t.ndim} at {key}")
        state[".".join(path)] = t.contiguous()
    return state
