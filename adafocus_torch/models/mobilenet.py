"""MobileNetV2 glancer backbone (counterpart of adafocus_tpu/models/mobilenet.py).

Same inverted-residual configuration and submodule names as the JAX
package (``stem``, ``block_{i}_{j}/{expand,dw,project}``, ``head_conv``,
``classifier``), so a flax tree maps onto the state dict key by key. With
``n_frames > 0`` every residual block shifts its branch input across time
(``models/tsm.py``), the TSM glancer of the sth-sth family; the skip
connection adds the unshifted input. ``remat`` recomputes each block in the
backward (``layers.remat_block``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from adafocus_torch.models.layers import (
    ConvBNAct, global_avg_pool, make_divisible, remat_block,
)
from adafocus_torch.models.tsm import temporal_shift_nchw

# (expand_ratio t, channels c, num_blocks n, stride s)
_INVERTED_RESIDUAL_CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class InvertedResidual(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 expand_ratio: int, n_frames: int = 0):
        super().__init__()
        hidden = int(round(in_channels * expand_ratio))
        self.use_res = stride == 1 and in_channels == out_channels
        self.n_frames = n_frames
        self.expand = (
            ConvBNAct(in_channels, hidden, kernel_size=1)
            if expand_ratio != 1 else None
        )
        self.dw = ConvBNAct(hidden, hidden, kernel_size=3, stride=stride,
                            groups=hidden)
        self.project = ConvBNAct(hidden, out_channels, kernel_size=1, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.use_res and self.n_frames > 0:
            h = temporal_shift_nchw(h, self.n_frames)
        h = h if self.expand is None else self.expand(h)
        h = self.project(self.dw(h))
        return x + h if self.use_res else h


class MobileNetV2(nn.Module):
    """``features`` returns (pre-pool map, pooled vector); ``classify`` is
    the stage-0 pretraining head, with dropout 0.2 in train mode (and the
    sth-sth family's per-frame global logits). ``n_frames > 0``: the TSM
    variant, T = ``n_frames`` consecutive frames a clip along the batch."""

    def __init__(self, num_classes: int = 1000, n_frames: int = 0, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.feature_dim = make_divisible(1280)
        in_c = make_divisible(32)
        self.stem = ConvBNAct(3, in_c, kernel_size=3, stride=2)
        self.block_names = []
        for i, (t, c, n, s) in enumerate(_INVERTED_RESIDUAL_CFG):
            out_c = make_divisible(c)
            for j in range(n):
                name = f"block_{i}_{j}"
                self.add_module(
                    name, InvertedResidual(in_c, out_c, s if j == 0 else 1, t, n_frames)
                )
                self.block_names.append(name)
                in_c = out_c
        self.head_conv = ConvBNAct(in_c, self.feature_dim, kernel_size=1)
        self.dropout_rate = 0.2
        self.classifier = nn.Linear(self.feature_dim, num_classes)

    def backbone(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for name in self.block_names:
            block = getattr(self, name)
            x = remat_block(block, x) if self.remat else block(x)
        return self.head_conv(x)

    def features(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, 3, H, W) -> (map (N, 1280, h, w), pooled (N, 1280))."""
        fmap = self.backbone(x)
        return fmap, global_avg_pool(fmap)

    def classify(self, pooled: torch.Tensor, keep: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """(N, 1280) -> (N, classes). In train mode, dropout as flax applies
        it (``where(keep, x / 0.8, 0)``): ``keep`` is the boolean mask of
        kept units, drawn from torch's default generator when None."""
        if self.training:
            if keep is None:
                keep = torch.rand(pooled.shape, device=pooled.device) < 1.0 - self.dropout_rate
            pooled = torch.where(keep, pooled / (1.0 - self.dropout_rate), 0.0)
        return self.classifier(pooled)
