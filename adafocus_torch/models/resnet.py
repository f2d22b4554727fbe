"""ResNet focuser backbones (counterpart of adafocus_tpu/models/resnet.py).

``resnet50`` is the focuser of every model family; ``resnet18``,
``resnet34``, ``resnet101``, ``resnet152`` and ``wide_resnet101`` are the
JAX package's other constructors, the architectures whose torchvision
weights ``utils/torch_weights.py`` converts. Submodule names follow the
JAX package (``stem``, ``layer{S}_{J}/{conv1,conv2[,conv3],down}``,
``fc``). The stride sits on a bottleneck's ``conv2``, the 3x3, and on a
basic block's ``conv1``; the stem's max-pool is 3/2/1. With ``n_frames >
0`` every block shifts its branch input across time (``models/tsm.py``),
the 'blockres' TSM of the sth-sth focuser; ``down`` and the identity read
the unshifted input, and the stem and the max-pool do not shift.

``partial_bn`` (TSM's partial BatchNorm, the JAX package's
``ResNet.partial_bn``): in train mode only the stem's BatchNorm uses batch
statistics; every block's runs on its running statistics, which stay as
they are. ``remat`` recomputes each block in the backward
(``layers.remat_block``), the JAX package's per-block ``nn.remat``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from adafocus_torch.models.layers import ConvBNAct, global_avg_pool, remat_block
from adafocus_torch.models.tsm import temporal_shift_nchw


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 downsample: bool = False, n_frames: int = 0):
        super().__init__()
        self.n_frames = n_frames
        self.conv1 = ConvBNAct(in_channels, features, 3, stride, act=F.relu)
        self.conv2 = ConvBNAct(features, features, 3, act=None)
        self.down = (
            ConvBNAct(in_channels, features, 1, stride, act=None) if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.n_frames > 0:
            h = temporal_shift_nchw(h, self.n_frames)
        h = self.conv2(self.conv1(h))
        if self.down is not None:
            x = self.down(x)
        return F.relu(x + h)


class Bottleneck(nn.Module):
    """``inner_mult``: the wide variants' factor on the inner 1x1 and 3x3
    convs (torchvision's ``width_per_group=128`` is 2); the block's output
    stays ``features * 4``."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 downsample: bool = False, n_frames: int = 0, inner_mult: int = 1):
        super().__init__()
        out = features * self.expansion
        inner = features * inner_mult
        self.n_frames = n_frames
        self.conv1 = ConvBNAct(in_channels, inner, 1, act=F.relu)
        self.conv2 = ConvBNAct(inner, inner, 3, stride, act=F.relu)
        self.conv3 = ConvBNAct(inner, out, 1, act=None)
        self.down = (
            ConvBNAct(in_channels, out, 1, stride, act=None) if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.n_frames > 0:
            h = temporal_shift_nchw(h, self.n_frames)
        h = self.conv3(self.conv2(self.conv1(h)))
        if self.down is not None:
            x = self.down(x)
        return F.relu(x + h)


class ResNet(nn.Module):
    """A ResNet of ``block`` (``BasicBlock`` or ``Bottleneck``) with
    ``stage_sizes`` blocks in its four stages; ``inner_mult`` widens a
    bottleneck's inner convs (the wide variants). ``forward`` is the
    stage-0 pretraining head (``features``, then ``fc``); inference reads
    only ``features``. ``n_frames > 0``: the TSM variant, T = ``n_frames``
    consecutive frames a clip along the batch. ``partial_bn`` and
    ``remat``: see the module's docstring."""

    def __init__(self, block: type = Bottleneck, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 inner_mult: int = 1, num_classes: int = 1000, n_frames: int = 0,
                 partial_bn: bool = False, remat: bool = False):
        super().__init__()
        self.partial_bn = partial_bn
        self.remat = remat
        self.feature_dim = 512 * block.expansion
        wide = {"inner_mult": inner_mult} if block is Bottleneck else {}
        self.stem = ConvBNAct(3, 64, kernel_size=7, stride=2, act=F.relu)
        self.block_names = []
        in_c = 64
        for stage, n_blocks in enumerate(stage_sizes):
            features = 64 * 2**stage
            for j in range(n_blocks):
                stride = 2 if (stage > 0 and j == 0) else 1
                out_c = features * block.expansion
                downsample = j == 0 and (stride != 1 or in_c != out_c)
                name = f"layer{stage + 1}_{j}"
                self.add_module(name, block(in_c, features, stride, downsample, n_frames,
                                            **wide))
                self.block_names.append(name)
                in_c = out_c
        self.fc = nn.Linear(in_c, num_classes)

    def train(self, mode: bool = True) -> "ResNet":
        super().train(mode)
        if self.partial_bn:
            for name in self.block_names:
                getattr(self, name).eval()
        return self

    def backbone(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(self.stem(x), kernel_size=3, stride=2, padding=1)
        for name in self.block_names:
            block = getattr(self, name)
            x = remat_block(block, x) if self.remat else block(x)
        return x

    def features(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, 3, H, W) -> (map (N, C, h, w), pooled (N, C)), C =
        ``feature_dim`` (2048 for the bottleneck variants, 512 for the basic
        ones)."""
        fmap = self.backbone(x)
        return fmap, global_avg_pool(fmap)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) -> logits (N, classes)."""
        return self.fc(self.features(x)[1])


# the constructors take ResNet's arguments after inner_mult: (num_classes,
# n_frames, partial_bn, remat), by position or by name


def resnet18(*args, **kw) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), 1, *args, **kw)


def resnet34(*args, **kw) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), 1, *args, **kw)


def resnet50(*args, **kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), 1, *args, **kw)


def resnet101(*args, **kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), 1, *args, **kw)


def resnet152(*args, **kw) -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3), 1, *args, **kw)


def wide_resnet101(*args, **kw) -> ResNet:
    """torchvision's ``wide_resnet101_2``: the inner bottleneck convs twice
    as wide, the block outputs unchanged."""
    return ResNet(Bottleneck, (3, 4, 23, 3), 2, *args, **kw)
