"""Shared conv/norm building blocks (counterpart of adafocus_tpu/models/layers.py).

Modules take NCHW tensors; on the GPU they are kept in
``torch.channels_last`` memory, the layout cuDNN's bf16 convolutions
prefer and the one the JAX package computes in.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn


class ConvBNAct(nn.Module):
    """Conv2d (no bias) + BatchNorm (eps 1e-5, momentum 0.1) + optional
    activation. Padding is ``(k - 1) // 2`` on both sides."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        groups: int = 1,
        act: Optional[Callable[[torch.Tensor], torch.Tensor]] = nn.functional.relu6,
    ):
        super().__init__()
        self.conv = nn.Conv2d(
            in_channels, out_channels, kernel_size, stride=stride,
            padding=(kernel_size - 1) // 2, groups=groups, bias=False,
        )
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C)."""
    return x.mean(dim=(2, 3))


def make_divisible(v: float, divisor: int = 8, min_value: Optional[int] = None) -> int:
    """Channel rounding used by MobileNetV2."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v
