"""Weight IO: the shipped ``.npz`` artifact and the JAX parameter layout.

The artifact (``data/artifacts/ctpn_synth_f16.npz``) stores the JAX model's
parameter tree as flat ``a/b/c`` keys in float16, in flax layouts: conv
kernels HWIO, Dense kernels ``(in, out)``. :func:`params_from_jax` carries
such a tree into this package's ``state_dict``: conv HWIO -> OIHW, Dense
``(in, out)`` -> ``Linear``-style ``(out, in)``. The BiLSTM keeps its fused
input projection as one ``(8*hidden, C)`` weight (forward gates are rows
``[0, 4*hidden)``, backward ``[4*hidden, 8*hidden)``) and its recurrent
weights ``w_h_fw``/``w_h_bw`` in the ``h @ w_h`` layout ``(hidden, 4*hidden)``.
:func:`params_to_jax` is the inverse.

An ``.npz`` may name another artifact beside it whose trunk it shares
(``__trunk__``, with ``__trunk_sha256__``): :func:`read_artifact` reads
that artifact's ``VGG16Trunk_0`` leaves in, checked against the digest.
EAST's artifact stores its merge branch and heads so, on CTPN's trunk, and
CRAFT's its slice5, decoder and ``conv_cls``, its large kernels as int8
with a scale per output channel (:func:`quantized`, :func:`dequantized`),
which keeps its 8.3 M parameters to a few MB.

CRAFT's published weights come as a clovaai/CRAFT-pytorch state dict
(``basenet.slice1.0.weight``, ..., ``upconv1.conv.1.running_var``,
``conv_cls.8.bias``; a ``module.`` prefix from ``DataParallel`` is
stripped as its ``copyStateDict`` does): :func:`craft_params_from_clovaai`
folds each batch norm into its conv and gives the port's parameter tree.
DBNet's come as a MhLiao/DB state dict (``backbone.layer2.0.conv2_offset.weight``,
``decoder.binarize.4.running_var``, ...): :func:`db_params_from_mhliao`
does the same for them.

The pretrained-format converters are NumPy copies of the JAX package's
(``ctpn_tpu/utils/weights.py``), on the JAX-layout tree as nested dicts of
numpy arrays, so that ``--npy`` and ``--tf-vars`` give the same tree in
both packages: :func:`load_pretrained_into` (``VGG_imagenet.npy`` or an
``.npz`` artifact) and :func:`convert_tf_vars` (a ``{tf_name: array}``
dump of the reference's TF1 checkpoint). :func:`export_params_npz` writes
the shipped f16 ``.npz`` format that both packages' ``load_params`` read.

Orbax directories, the JAX package's default artifact (``<dir>/params``),
are read and written through ``utils/orbax_io.py``: :func:`load_params` and
:func:`load_pretrained_into` take one wherever they take an ``.npz``, and
:func:`export_params` writes one that the JAX package's ``load_params``
reads.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ctpn_tpu_torch.utils.device import resolve_device

_TRUNK_SCOPE = "VGG16Trunk_0"

ArrayLike = Union[np.ndarray, torch.Tensor]


def read_artifact(artifact: str) -> Dict[str, np.ndarray]:
    """The leaves of an ``.npz`` artifact or an orbax artifact directory (its
    ``params`` tree), as flat ``a/b/c`` keys -> float32 numpy arrays."""
    if osp.isdir(artifact):
        from ctpn_tpu_torch.utils.orbax_io import read_tree

        return {k: np.asarray(v, np.float32)
                for k, v in _flatten(read_tree(osp.join(artifact, "params")))}
    if not artifact.endswith(".npz"):
        raise ValueError(
            f"expected an .npz artifact or an orbax artifact directory, got {artifact}")
    with np.load(artifact) as flat:
        out = {k: flat[k] for k in flat.files if k not in _TRUNK_REF}
        ref = {k: str(flat[k]) for k in _TRUNK_REF if k in flat.files}
    out = dequantized(out)
    if ref:
        out.update(_trunk_of(artifact, ref["__trunk__"], ref.get("__trunk_sha256__")))
    return out


# a leaf stored as int8 has its float32 scale per output channel (its last
# axis) beside it under this suffix (CRAFT's artifact, ``cli/train_craft_synth.py``)
SCALE_SUFFIX = "__scale"


def dequantized(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``flat``'s leaves as float32: an int8 leaf times its ``__scale``
    (float32 product), the others widened."""
    out = {}
    for k, v in flat.items():
        if k.endswith(SCALE_SUFFIX):
            continue
        if v.dtype == np.int8:
            v = v.astype(np.float32) * flat[k + SCALE_SUFFIX].astype(np.float32)
        out[k] = np.asarray(v, np.float32)
    return out


def quantized(flat: Mapping[str, np.ndarray], least: int = 1 << 16) -> Dict[str, np.ndarray]:
    """Leaves of at least ``least`` elements as int8 with a float32 scale
    per output channel (the last axis: HWIO and Dense kernels), the largest
    magnitude to 127; the others float16. :func:`dequantized` reads it."""
    out = {}
    for k, v in flat.items():
        v = np.asarray(v, np.float32)
        if v.size < least:
            out[k] = v.astype(np.float16)
            continue
        axes = tuple(range(v.ndim - 1))
        scale = np.maximum(np.abs(v).max(axis=axes), 1e-12).astype(np.float32) / 127
        out[k] = np.clip(np.rint(v / scale), -127, 127).astype(np.int8)
        out[k + SCALE_SUFFIX] = scale
    return out


# an artifact that shares another's trunk (EAST's, ``cli/train_east_synth.py``)
# names that artifact, beside it, and its sha256
_TRUNK_REF = ("__trunk__", "__trunk_sha256__")


def _trunk_of(artifact: str, name: str, sha256: Optional[str]) -> Dict[str, np.ndarray]:
    """The ``VGG16Trunk_0`` leaves of the artifact ``name`` in the directory
    of ``artifact``, checked against ``sha256``."""
    import hashlib

    path = osp.join(osp.dirname(osp.abspath(artifact)), name)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if sha256 is not None and digest != sha256:
        raise ValueError(f"{path}: sha256 {digest} is not the {sha256} that {artifact} names")
    return {k: v for k, v in read_artifact(path).items()
            if k.split("/")[0] == _TRUNK_SCOPE}


def load_params(
    artifact: str, device: Union[str, torch.device] = "cuda"
) -> Dict[str, torch.Tensor]:
    """Load an ``.npz`` artifact or an orbax artifact directory (``<artifact>/
    params``, as the JAX package's ``load_params``): flat ``a/b/c`` keys ->
    float32 tensors on ``device`` (float16 and bfloat16 storage widen to
    float32, as the JAX loader does for ``.npz``)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in read_artifact(artifact).items()}


def export_params(params: Mapping[str, Any], out_dir: str) -> str:
    """Orbax artifact directory (counterpart of the JAX package's
    ``export_params``): ``params`` (a JAX-layout tree, nested or flat ``a/b/c``,
    of numpy arrays or tensors, kept in their dtype) is written to
    ``<out_dir>/params``, which ``load_params`` of either package reads."""
    from ctpn_tpu_torch.utils.orbax_io import write_tree

    tree: Dict[str, Any] = {}
    for key, value in _flatten(params):
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    os.makedirs(out_dir, exist_ok=True)
    write_tree(tree, osp.join(out_dir, "params"))
    return osp.abspath(out_dir)


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


# CRAFT's convs: the port's name, clovaai's conv and its batch norm (None:
# none). Trunk convs sit under ``VGG16Trunk_0``; ``cls_out`` is a Dense.
CRAFT_CLOVAAI = (
    ("conv1_1", "basenet.slice1.0", "basenet.slice1.1"),
    ("conv1_2", "basenet.slice1.3", "basenet.slice1.4"),
    ("conv2_1", "basenet.slice1.7", "basenet.slice1.8"),
    ("conv2_2", "basenet.slice1.10", "basenet.slice1.11"),
    ("conv3_1", "basenet.slice2.14", "basenet.slice2.15"),
    ("conv3_2", "basenet.slice2.17", "basenet.slice2.18"),
    ("conv3_3", "basenet.slice3.20", "basenet.slice3.21"),
    ("conv4_1", "basenet.slice3.24", "basenet.slice3.25"),
    ("conv4_2", "basenet.slice3.27", "basenet.slice3.28"),
    ("conv4_3", "basenet.slice4.30", "basenet.slice4.31"),
    ("conv5_1", "basenet.slice4.34", "basenet.slice4.35"),
    ("conv5_2", "basenet.slice4.37", "basenet.slice4.38"),
    ("fc6", "basenet.slice5.1", None),
    ("fc7", "basenet.slice5.2", None),
    *((f"up{k}_1x1", f"upconv{k}.conv.0", f"upconv{k}.conv.1") for k in range(1, 5)),
    *((f"up{k}_3x3", f"upconv{k}.conv.3", f"upconv{k}.conv.4") for k in range(1, 5)),
    ("cls1", "conv_cls.0", None),
    ("cls2", "conv_cls.2", None),
    ("cls3", "conv_cls.4", None),
    ("cls4", "conv_cls.6", None),
    ("cls_out", "conv_cls.8", None),
)
BN_EPS = 1e-5  # torch.nn.BatchNorm2d's default, clovaai's


def craft_params_from_clovaai(state: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A clovaai/CRAFT-pytorch state dict -> the port's CRAFT parameters
    (flat ``a/b/c`` keys, float32, the layout of :func:`load_params`),
    each batch norm folded into its conv in float64: ``w * g / sqrt(var +
    eps)`` and ``(b - mean) * g / sqrt(var + eps) + beta``."""
    flat = {(k[len("module."):] if k.startswith("module.") else k):
            np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v,
                       np.float64) for k, v in state.items()}
    out: Dict[str, np.ndarray] = {}
    for name, conv, bn in CRAFT_CLOVAAI:
        w, b = flat[f"{conv}.weight"], flat[f"{conv}.bias"]
        if bn is not None:
            scale = flat[f"{bn}.weight"] / np.sqrt(flat[f"{bn}.running_var"] + BN_EPS)
            w = w * scale[:, None, None, None]
            b = (b - flat[f"{bn}.running_mean"]) * scale + flat[f"{bn}.bias"]
        key = f"{_TRUNK_SCOPE}/{name}" if name.startswith("conv") else name
        kernel = w[:, :, 0, 0].T if name == "cls_out" else w.transpose(2, 3, 1, 0)
        out[f"{key}/kernel"] = np.ascontiguousarray(kernel, np.float32)
        out[f"{key}/bias"] = b.astype(np.float32)
    return out


def db_mhliao_convs(blocks=None, dcn=None):
    """(port name, MhLiao conv, MhLiao batch norm or None, transposed) of
    each of DBNet's convs in MhLiao/DB's state dict (``SegDetectorModel``:
    the backbone and the decoder), for stages of ``blocks`` bottlenecks,
    deformable where ``dcn`` says (by default the published (3, 4, 6, 3)
    and stages 2-4)."""
    from ctpn_tpu_torch.models.resnet import STAGE_WITH_DCN, STAGES

    blocks = blocks or tuple(n for n, _ in STAGES)
    dcn = dcn or STAGE_WITH_DCN
    out = [("backbone/conv1", "backbone.conv1", "backbone.bn1", False)]
    for s, (n, d) in enumerate(zip(blocks, dcn), start=1):
        for b in range(n):
            at = f"layer{s}/{b}"
            mh = f"backbone.layer{s}.{b}"
            out += [(f"backbone/{at}/conv1", f"{mh}.conv1", f"{mh}.bn1", False),
                    (f"backbone/{at}/conv2", f"{mh}.conv2", f"{mh}.bn2", False),
                    (f"backbone/{at}/conv3", f"{mh}.conv3", f"{mh}.bn3", False)]
            if d:
                out.append((f"backbone/{at}/conv2_offset", f"{mh}.conv2_offset", None, False))
            if b == 0:
                out.append((f"backbone/{at}/downsample", f"{mh}.downsample.0",
                            f"{mh}.downsample.1", False))
    for k in (2, 3, 4, 5):
        out += [(f"decoder/in{k}", f"decoder.in{k}", None, False),
                (f"decoder/out{k}", f"decoder.out{k}" + ("" if k == 2 else ".0"), None, False)]
    return out + [("decoder/bin_conv", "decoder.binarize.0", "decoder.binarize.1", False),
                  ("decoder/bin_up1", "decoder.binarize.3", "decoder.binarize.4", True),
                  ("decoder/bin_up2", "decoder.binarize.6", None, True)]


def _strip_prefixes(key: str) -> str:
    while key.startswith(("model.", "module.")):
        key = key.split(".", 1)[1]
    return key


def db_params_from_mhliao(state: Mapping[str, Any], blocks=None,
                          dcn=None) -> Dict[str, np.ndarray]:
    """A MhLiao/DB state dict -> the port's DBNet parameters (flat ``a/b/c``
    keys, float32, the layout of :func:`load_params`): ``model.`` and
    ``module.`` prefixes stripped, each batch norm folded into its conv in
    float64 (``w * g / sqrt(var + eps)``, ``(b - mean) * g / sqrt(var +
    eps) + beta``; a conv without a bias has 0), the offset convs
    (``conv2_offset``) read with their biases, the threshold branch and
    ResNet's classifier left out. Conv kernels are stored HWIO; a transposed
    conv's (in, out, kh, kw) weight is stored as (kh, kw, out, in), so that
    :func:`params_from_jax` gives it back."""
    flat = {_strip_prefixes(k): np.asarray(
        v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v, np.float64)
        for k, v in state.items()}
    out: Dict[str, np.ndarray] = {}
    for name, conv, bn, transposed in db_mhliao_convs(blocks, dcn):
        w = flat[f"{conv}.weight"]
        b = flat.get(f"{conv}.bias")
        if bn is not None:
            scale = flat[f"{bn}.weight"] / np.sqrt(flat[f"{bn}.running_var"] + BN_EPS)
            w = w * (scale[None, :, None, None] if transposed else scale[:, None, None, None])
            b = (0.0 if b is None else b) - flat[f"{bn}.running_mean"]
            b = b * scale + flat[f"{bn}.bias"]
        out[f"{name}/kernel"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0), np.float32)
        if b is not None:
            out[f"{name}/bias"] = np.asarray(b, np.float32)
    return out


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


def jax_key(name: str) -> str:
    """The JAX parameter path (``a/b/c``) of this package's ``CTPN``
    state-dict key: ``trunk`` -> ``VGG16Trunk_0``, ``weight`` -> ``kernel``."""
    path = name.split(".")
    if path[0] == "trunk":
        path[0] = _TRUNK_SCOPE
    if path[-1] == "weight":
        path[-1] = "kernel"
    return "/".join(path)


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """This package's ``CTPN`` ``state_dict`` -> the JAX parameter tree, a
    nested dict of float32 numpy arrays (the inverse of
    :func:`params_from_jax`): conv OIHW -> HWIO, ``Linear`` ``(out, in)``
    -> Dense ``(in, out)``, ``trunk`` -> ``VGG16Trunk_0``."""
    tree: Dict[str, Any] = {}
    for name, t in state_dict.items():
        path = jax_key(name).split("/")
        a = t.detach().to(torch.float32).cpu().numpy()
        if path[-1] == "kernel":
            if a.ndim == 4:  # OIHW -> HWIO
                a = a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:  # Linear (out, in) -> Dense (in, out)
                a = a.T
            else:
                raise ValueError(f"unexpected weight rank {a.ndim} at {name}")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return tree


def export_params_npz(params: Mapping[str, Any], out_file: str,
                      dtype=np.float16) -> str:
    """Single-file compressed artifact (half precision by default), flat
    ``a/b/c`` keys: the format of ``data/artifacts/ctpn_synth_f16.npz``,
    read by :func:`load_params` and by the JAX package's ``load_params``.
    ``params`` is a JAX-layout tree, nested or flat."""
    flat = {
        k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v)).astype(dtype)
        for k, v in _flatten(params)
    }
    bad = [k for k, v in flat.items()
           if v.size and not np.all(np.isfinite(v.astype(np.float32)))]
    if bad:
        raise ValueError(
            f"non-finite values after {np.dtype(dtype).name} cast "
            f"(overflow past the format's range?) in: {bad[:5]}"
        )
    np.savez_compressed(out_file, **flat)
    return osp.abspath(out_file)


def _tree_copy(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Nested-dict copy of a JAX-layout tree with numpy leaves."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        out[k] = _tree_copy(v) if isinstance(v, Mapping) else np.array(v)
    return out


def _set_in(params: Dict, path, value) -> bool:
    """Set params[path...] = value if the leaf exists and shapes match."""
    node = params
    for p in path[:-1]:
        if p not in node:
            return False
        node = node[p]
    leaf = path[-1]
    if leaf not in node:
        return False
    if tuple(node[leaf].shape) != tuple(value.shape):
        raise ValueError(
            f"shape mismatch for {'/'.join(path)}: "
            f"{node[leaf].shape} vs {value.shape}"
        )
    node[leaf] = np.asarray(value, dtype=node[leaf].dtype)
    return True


def _trunk_scope(params: Mapping[str, Any]) -> Optional[str]:
    for k in params:
        if k.startswith("VGG16Trunk"):
            return k
    return None


def load_pretrained_into(params: Mapping[str, Any], npy_path: str,
                         ignore_missing: bool = True) -> Dict[str, Any]:
    """Assign ``VGG_imagenet.npy``-style weights into the nested JAX-layout
    tree; returns a new tree.

    The .npy holds ``{layer: {"weights": w, "biases": b}}`` with HWIO conv
    kernels. Layers that do not exist in the model (fc6/fc7/fc8 classifier
    heads) are skipped, mirroring ``ignore_missing=True``. An ``.npz``
    artifact or an orbax artifact directory is also accepted: its leaves
    share the tree's paths, so the overlay is exact.
    """
    if osp.isdir(npy_path) or npy_path.endswith(".npz"):
        target = _tree_copy(params)
        applied = 0
        for key, value in read_artifact(npy_path).items():
            if _set_in(target, tuple(key.split("/")), value):
                applied += 1
            elif not ignore_missing:
                raise KeyError(f"artifact leaf {key} not found in model")
        if applied == 0:
            raise ValueError(
                f"artifact {npy_path} applied zero leaves to the model tree "
                "(structure mismatch?)"
            )
        return target
    params = _tree_copy(params)
    data = np.load(npy_path, allow_pickle=True, encoding="latin1").item()
    trunk = _trunk_scope(params)
    loaded = []
    for layer, vars_ in data.items():
        w = vars_.get("weights")
        b = vars_.get("biases")
        targets = []
        if trunk and layer in params.get(trunk, {}):
            targets = [(trunk, layer)]
        elif layer in params:
            targets = [(layer,)]
        if not targets:
            if not ignore_missing:
                raise KeyError(f"layer {layer} not found in model")
            continue
        scope = targets[0]
        if w is not None and w.ndim in (2, 4):
            _set_in(params, (*scope, "kernel"), w)
        if b is not None:
            _set_in(params, (*scope, "bias"), b)
        loaded.append(layer)
    if not loaded and not ignore_missing:
        raise ValueError("no layers loaded")
    return params


def convert_tf_vars(params: Mapping[str, Any], tf_vars: Mapping[str, np.ndarray],
                    hidden: int = 128) -> Dict[str, Any]:
    """Map reference TF1 CTPN variables onto the nested JAX-layout tree;
    returns a new tree.

    Expected names (as found in the reference graph/checkpoint):
      ``conv*_*/weights|biases``, ``rpn_conv/3x3/weights|biases``,
      ``lstm_o/bidirectional_rnn/fw/lstm_cell/kernel|bias`` (and ``bw``),
      ``lstm_o/weights|biases`` (the 256->512 projection),
      ``rpn_bbox_pred/weights|biases``, ``rpn_cls_score/weights|biases``.
    """
    params = _tree_copy(params)
    trunk = _trunk_scope(params)

    def get(name):
        return tf_vars.get(name)

    for layer in list(params.get(trunk, {})):
        w, b = get(f"{layer}/weights"), get(f"{layer}/biases")
        if w is not None:
            _set_in(params, (trunk, layer, "kernel"), w)
        if b is not None:
            _set_in(params, (trunk, layer, "bias"), b)

    w = get("rpn_conv/3x3/weights")
    b = get("rpn_conv/3x3/biases")
    if w is not None:
        _set_in(params, ("rpn_conv", "kernel"), w)
    if b is not None:
        _set_in(params, ("rpn_conv", "bias"), b)

    fw_k = get("lstm_o/bidirectional_rnn/fw/lstm_cell/kernel")
    bw_k = get("lstm_o/bidirectional_rnn/bw/lstm_cell/kernel")
    fw_b = get("lstm_o/bidirectional_rnn/fw/lstm_cell/bias")
    bw_b = get("lstm_o/bidirectional_rnn/bw/lstm_cell/bias")
    if fw_k is not None and bw_k is not None:
        c = fw_k.shape[0] - hidden
        in_proj = np.concatenate([fw_k[:c], bw_k[:c]], axis=1)  # (C, 8H)
        _set_in(params, ("bilstm", "input_proj", "kernel"), in_proj)
        _set_in(
            params, ("bilstm", "input_proj", "bias"),
            np.concatenate([fw_b, bw_b]),
        )
        _set_in(params, ("bilstm", "w_h_fw"), fw_k[c:])
        _set_in(params, ("bilstm", "w_h_bw"), bw_k[c:])

    w, b = get("lstm_o/weights"), get("lstm_o/biases")
    if w is not None:
        _set_in(params, ("bilstm", "out_proj", "kernel"), w)
    if b is not None:
        _set_in(params, ("bilstm", "out_proj", "bias"), b)

    for head in ("rpn_bbox_pred", "rpn_cls_score"):
        w, b = get(f"{head}/weights"), get(f"{head}/biases")
        if w is not None:
            _set_in(params, (head, "kernel"), w)
        if b is not None:
            _set_in(params, (head, "bias"), b)
    return params
