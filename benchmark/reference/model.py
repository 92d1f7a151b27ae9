"""The CTPN network in plain PyTorch, float32: the benchmark's reference.

VGG16 conv1-conv5 (3x3 SAME convs with ReLU, 2x2/2 max-pools after blocks
1-4), ``rpn_conv`` 3x3 with ReLU, a bidirectional LSTM along each row of
the stride-16 feature map (TF1 ``LSTMCell`` gates i, g, f, o with forget
bias 1.0, 128 per direction), a 256 -> 512 projection, and the two heads:
20 (bg, fg) scores and 40 deltas per cell (arXiv:1609.03605 section 3;
eragonruan/text-detection-ctpn ``lib/networks/VGGnet_test.py``). The
widths come from the configuration file, the weights from the ``.npz``
that the configuration names (flax layouts: conv kernels HWIO, dense
kernels (in, out)).

``quant`` is the precision of the layers that the program runs in its
compute type (the convs, the LSTM's input and output projections):
``None`` computes them in float32; ``"fp8"`` rounds their inputs and
weights to float8 e4m3 with one scale per tensor before a float32
product, the control one step below bfloat16. The recurrence and the
heads are float32 either way, as in the program.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3 value


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a per-tensor scale, as float32."""
    scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Heads(NamedTuple):
    cls_prob: torch.Tensor  # (N, H, W, A) foreground probability
    bbox_pred: torch.Tensor  # (N, H, W, A*4) deltas


def load_weights(path: str, device) -> Dict[str, torch.Tensor]:
    """The ``.npz`` leaves as float32 tensors on ``device``, in PyTorch
    layouts: conv OIHW, dense (out, in); the recurrent weights as stored,
    (hidden, 4*hidden), used as ``h @ w``."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            t = torch.from_numpy(z[key].astype(np.float32))
            if key.endswith("kernel") and t.ndim == 4:
                t = t.permute(3, 2, 0, 1)
            elif key.endswith("kernel") and t.ndim == 2:
                t = t.t()
            out[key] = t.contiguous().to(device)
    return out


class ReferenceCTPN:
    """``forward(images, im_pixels_means)``: (N, H, W, 3) uint8 BGR padded
    images -> :class:`Heads`."""

    def __init__(self, weights: Dict[str, torch.Tensor], model_cfg: dict,
                 pixel_means, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown precision {quant!r}")
        self.w = weights
        self.cfg = model_cfg
        self.quant = quant
        self.means = torch.tensor(pixel_means, dtype=torch.float32)

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x) if self.quant == "fp8" else x

    def _conv(self, x, name):
        w, b = self.w[f"{name}/kernel"], self.w[f"{name}/bias"]
        return F.relu(F.conv2d(self._q(x), self._q(w), b, padding=1))

    def _dense(self, x, name, quant=True):
        w, b = self.w[f"{name}/kernel"], self.w[f"{name}/bias"]
        if quant:
            x, w = self._q(x), self._q(w)
        return x @ w.t() + b

    def forward(self, images: torch.Tensor) -> Heads:
        x = images.float() - self.means.to(images.device)
        x = x.permute(0, 3, 1, 2).contiguous()
        stages = self.cfg["vgg_stages"]
        for block, reps, _ in stages:
            for rep in range(1, reps + 1):
                x = self._conv(x, f"VGG16Trunk_0/conv{block}_{rep}")
            if block < len(stages):
                x = F.max_pool2d(x, 2, 2)
        x = self._conv(x, "rpn_conv").permute(0, 2, 3, 1)  # (N, H, W, C)
        n, h, w, c = x.shape
        hid = self.cfg["lstm_hidden"]
        proj = self._dense(x.reshape(n * h, w, c), "bilstm/input_proj")
        outs = []
        for d, name in enumerate(("bilstm/w_h_fw", "bilstm/w_h_bw")):
            gates_in = proj[..., 4 * hid * d:4 * hid * (d + 1)]
            if d == 1:
                gates_in = gates_in.flip(1)
            w_h = self.w[name]
            hs = proj.new_zeros((n * h, hid))
            cs = proj.new_zeros((n * h, hid))
            ys = []
            for t in range(w):
                g_all = gates_in[:, t] + hs @ w_h
                i, g, f, o = g_all.split(hid, dim=-1)
                cs = torch.sigmoid(f + 1.0) * cs + torch.sigmoid(i) * torch.tanh(g)
                hs = torch.sigmoid(o) * torch.tanh(cs)
                ys.append(hs)
            y = torch.stack(ys, dim=1)
            outs.append(y.flip(1) if d == 1 else y)
        lstm = self._dense(torch.cat(outs, dim=-1), "bilstm/out_proj")
        bbox = self._dense(lstm, "rpn_bbox_pred", quant=False)
        score = self._dense(lstm, "rpn_cls_score", quant=False)
        a = self.cfg["num_anchors"]
        prob = torch.softmax(score.reshape(n * h, w, a, 2), -1)[..., 1]
        return Heads(cls_prob=prob.reshape(n, h, w, a),
                     bbox_pred=bbox.reshape(n, h, w, a * 4))
