"""Peephole ConvLSTM (NHWC), the counterpart of
``recurrent_flows_tpu.nn.convlstm``."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.fused import convlstm_gates
from .layers import Conv2d


class ConvLSTMCell(nn.Module):
    """One peephole ConvLSTM step: a fused 3x3 gate conv over [x | h] with
    gate order (i, f, o, g), peepholes ``Wci``/``Wcf``/``Wco`` of shape
    [1, H, W, hidden] (zero at init), and the ``convlstm_gates`` kernel."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 spatial: tuple, kernel: int = 3, *, device=None,
                 generator=None):
        super().__init__()
        hc = hidden_channels
        cin = in_channels + hc
        fan_in, fan_out = cin * kernel * kernel, 4 * hc * kernel * kernel
        self.gates = Conv2d(cin, 4 * hc, kernel,
                            kernel_std=math.sqrt(2.0 / (fan_in + fan_out)),
                            bias_uniform=True, device=device,
                            generator=generator)
        shape = (1, spatial[0], spatial[1], hc)
        self.Wci = nn.Parameter(torch.zeros(shape, device=device))
        self.Wcf = nn.Parameter(torch.zeros(shape, device=device))
        self.Wco = nn.Parameter(torch.zeros(shape, device=device))

    def forward(self, x, h, c):
        gates = self.gates(torch.cat([x, h], -1)).contiguous()
        return convlstm_gates(gates, c.contiguous(), self.Wci, self.Wcf,
                              self.Wco)


def conv_lstm_scan(cell, xs, h0, c0, reverse: bool = False):
    """Unroll ``cell`` over time-major ``xs`` [T, ...] in a Python loop.
    Returns (hs [T, B, H, W, hidden], h_T, c_T); with ``reverse`` it runs
    from the last step and ``hs`` stays in time order."""
    h, c = h0, c0
    hs = [None] * xs.shape[0]
    order = range(xs.shape[0] - 1, -1, -1) if reverse else range(xs.shape[0])
    for t in order:
        h, c = cell(xs[t], h, c)
        hs[t] = h
    return torch.stack(hs), h, c
