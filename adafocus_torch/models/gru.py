"""GRU cell with torch.nn.GRU gate math (counterpart of adafocus_tpu/models/gru.py).

Gate order is [r, z, n], stacked along the output dim, and the parameters
carry ``torch.nn.GRUCell``'s names and shapes (``weight_ih`` (3H, in),
``weight_hh`` (3H, H), ``bias_ih``, ``bias_hh``). ``scan_time`` hoists the
input projection over all T steps into one matmul; only the (B, H) x (H, 3H)
recurrence runs step by step, as a Python loop over T.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F


def _gates(gi: torch.Tensor, h: torch.Tensor, gh: torch.Tensor) -> torch.Tensor:
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


class GRUCell(nn.Module):
    def __init__(self, in_features: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        h3 = 3 * hidden_size
        self.weight_ih = nn.Parameter(torch.empty(h3, in_features))
        self.weight_hh = nn.Parameter(torch.empty(h3, hidden_size))
        self.bias_ih = nn.Parameter(torch.empty(h3))
        self.bias_hh = nn.Parameter(torch.empty(h3))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Uniform in +-1/sqrt(H) for every parameter, as torch and the JAX
        package initialise a GRU."""
        k = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-k, k, generator=generator)

    def input_proj(self, x: torch.Tensor) -> torch.Tensor:
        """Input half of the gates over any leading dims: (..., in) -> (..., 3H)."""
        return F.linear(x, self.weight_ih, self.bias_ih)

    def step_from_proj(self, h: torch.Tensor, gi: torch.Tensor) -> torch.Tensor:
        """One recurrence step given a precomputed input projection."""
        return _gates(gi, h, F.linear(h, self.weight_hh, self.bias_hh))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.step_from_proj(h, self.input_proj(x))

    def scan_time(self, h0: torch.Tensor, xs_tb: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xs_tb (T, B, in) -> (final hidden (B, H), hiddens (T, B, H))."""
        gi_all = self.input_proj(xs_tb)
        h, hs = h0, []
        for gi in gi_all.unbind(0):
            h = self.step_from_proj(h, gi)
            hs.append(h)
        return h, torch.stack(hs)

    def initial_state(self, batch: int, dtype: torch.dtype) -> torch.Tensor:
        """Zeros (B, H) in ``dtype``, the compute dtype (the inputs', which
        under autocast is not the parameters')."""
        return torch.zeros(batch, self.hidden_size, dtype=dtype,
                           device=self.weight_hh.device)
