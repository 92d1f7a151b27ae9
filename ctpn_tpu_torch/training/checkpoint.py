"""The port's training checkpoints: one ``torch.save`` of a plain dict per
step, at ``<solver output>/checkpoints/<step>/state.pt``.

The JAX package writes orbax directories at the same place
(``<step>/default``, tree ``{"state": TrainState}``). The port keeps its own
format and does not resume from a JAX step, as the JAX solver resumes only
from its own: optax's optimizer state is not carried over.
:func:`load_jax_params` reads a JAX step's parameters (through
``utils/orbax_io.py``), which is what ``ctpn-torch-export --ckpt`` exports.
A checkpoint holds the step, the solver's name and state, the model's
``state_dict`` (float32, on the CPU) and the anchor-target draw generator's
state.
"""

from __future__ import annotations

import os
import os.path as osp
import shutil
from typing import Any, Dict, Optional

import torch

FORMAT = "ctpn-torch-ckpt-v1"
STATE_FILE = "state.pt"
KEEP = 100  # newest steps kept (the reference's max_to_keep)
JAX_ITEM = "default"  # orbax CheckpointManager's directory of a StandardSave


def checkpoint_root(output_dir: str) -> str:
    return osp.join(output_dir, "checkpoints")


def saved_steps(output_dir: str) -> list:
    """The steps with a directory under ``checkpoints/``, ascending."""
    root = checkpoint_root(output_dir)
    if not osp.isdir(root):
        return []
    return sorted(int(d) for d in os.listdir(root)
                  if d.isdigit() and osp.isdir(osp.join(root, d)))


def latest_step(output_dir: str) -> Optional[int]:
    steps = saved_steps(output_dir)
    return steps[-1] if steps else None


def save(output_dir: str, step: int, payload: Dict[str, Any]) -> str:
    """Write ``payload`` as step ``step`` (through a temporary file, so a
    reader never sees half a checkpoint) and drop all but the newest
    ``KEEP`` steps."""
    step_dir = osp.join(checkpoint_root(output_dir), str(step))
    os.makedirs(step_dir, exist_ok=True)
    path = osp.join(step_dir, STATE_FILE)
    torch.save({"format": FORMAT, "step": step, **payload}, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in saved_steps(output_dir)[:-KEEP]:
        shutil.rmtree(osp.join(checkpoint_root(output_dir), str(old)))
    return path


def load(output_dir: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The checkpoint of ``step`` (default the latest) under ``output_dir``,
    tensors on the CPU."""
    step = latest_step(output_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {checkpoint_root(output_dir)}")
    step_dir = osp.join(checkpoint_root(output_dir), str(step))
    path = osp.join(step_dir, STATE_FILE)
    if not osp.exists(path) and is_jax_step(output_dir, step):
        raise ValueError(
            f"{step_dir} is an orbax checkpoint of the JAX package's solver: "
            "the port resumes only from its own checkpoints, as the JAX solver "
            "does. Carry the parameters over with `ctpn-torch-export --ckpt "
            f"{output_dir} --out w.npz` and pass w.npz as pretrained weights"
        )
    if not osp.exists(path):
        raise ValueError(f"{step_dir} holds no {STATE_FILE}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if ckpt.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} checkpoint")
    return ckpt


def is_jax_step(output_dir: str, step: int) -> bool:
    """True if step ``step`` under ``output_dir`` was saved by the JAX
    package's solver (an orbax ``StandardSave`` item)."""
    return osp.isfile(osp.join(checkpoint_root(output_dir), str(step), JAX_ITEM,
                               "_METADATA"))


def load_jax_params(output_dir: str, step: int) -> Dict[str, Any]:
    """The parameter tree (``state.params``, nested dicts of numpy arrays) of
    the JAX solver's step ``step`` under ``output_dir``."""
    from ctpn_tpu_torch.utils.orbax_io import read_tree

    return read_tree(osp.join(checkpoint_root(output_dir), str(step), JAX_ITEM),
                     select=("state", "params"))
