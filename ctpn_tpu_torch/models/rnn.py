"""BiLSTM row encoder over the feature-map width axis (port of
``ctpn_tpu.models.rnn``).

Rows of the (N, H, W, C) feature map fold into the batch axis and a
bidirectional LSTM runs along W, followed by a 2*hidden -> d_out
projection. The input projections of both directions and all steps are one
matmul before the recurrence, in the compute dtype; the recurrence runs in
float32 whatever the compute dtype. Both directions step together, as one
batched matmul per step; the backward direction runs on the flipped time
axis. Gate order and forget bias follow TF1's ``LSTMCell`` (i, g, f, o;
forget_bias 1.0), as in the JAX package.

The recurrence is a plain Python loop over W (57 steps at the 912-wide
bucket): the JAX package leaves its scan to XLA, not to a Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BiLSTM(nn.Module):
    """(N, H, W, C) -> (N, H, W, d_out) float32; recurrence along W.

    ``input_proj.weight`` is (8*hidden, C): forward gates in rows
    [0, 4*hidden), backward in [4*hidden, 8*hidden). ``w_h_fw``/``w_h_bw``
    are (hidden, 4*hidden), used as ``h @ w_h``.
    """

    def __init__(self, in_channels: int, hidden: int = 128, d_out: int = 512):
        super().__init__()
        self.hidden = hidden
        self.input_proj = nn.Linear(in_channels, 8 * hidden)
        self.w_h_fw = nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.w_h_bw = nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.out_proj = nn.Linear(2 * hidden, d_out)
        nn.init.orthogonal_(self.w_h_fw)
        nn.init.orthogonal_(self.w_h_bw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        hid = self.hidden
        dtype = x.dtype
        xf = x.reshape(n * h, w, c)
        proj = F.linear(
            xf,
            self.input_proj.weight.to(dtype),
            self.input_proj.bias.to(dtype),
        ).float()
        # (2, B, T, 4*hid): forward gates, and backward gates time-reversed
        xs = torch.stack([proj[..., : 4 * hid], proj[..., 4 * hid:].flip(1)])
        w_h = torch.stack([self.w_h_fw, self.w_h_bw]).float()  # (2, hid, 4hid)
        hs = xs.new_zeros((2, n * h, hid))
        cs = xs.new_zeros((2, n * h, hid))
        outs = []
        for t in range(w):
            gates = xs[:, :, t] + torch.bmm(hs, w_h)
            i, g, f, o = gates.split(hid, dim=-1)
            cs = torch.sigmoid(f + 1.0) * cs + torch.sigmoid(i) * torch.tanh(g)
            hs = torch.sigmoid(o) * torch.tanh(cs)
            outs.append(hs)
        ys = torch.stack(outs, dim=2)  # (2, B, T, hid)
        cat = torch.cat([ys[0], ys[1].flip(1)], dim=-1)  # (B, T, 2*hid)
        out = F.linear(
            cat.to(dtype),
            self.out_proj.weight.to(dtype),
            self.out_proj.bias.to(dtype),
        )
        return out.float().reshape(n, h, w, -1)
