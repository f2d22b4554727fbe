"""Shared conv/norm building blocks (counterpart of adafocus_tpu/models/layers.py).

Modules take NCHW tensors; on the GPU they are kept in
``torch.channels_last`` memory, the layout cuDNN's bf16 convolutions
prefer and the one the JAX package computes in.

BatchNorm in train mode follows flax's ``nn.BatchNorm`` (momentum 0.9,
statistics in float32), not torch's: the running variance takes the
*biased* batch variance. ``stats_frozen`` runs train-mode BatchNorm on batch
statistics without writing the running ones (flax's mutable apply whose
update is discarded); ``remat_block`` recomputes a block in the backward
with the same guard, so that its running statistics move once a step.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

# flax's BatchNorm momentum: running = MOMENTUM * running + (1 - MOMENTUM) * batch
MOMENTUM = 0.9


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5) whose train-mode running statistics
    follow flax: ``running = 0.9 * running + 0.1 * batch`` for the mean and
    for the *biased* variance, both in float32 whatever the input's dtype.
    Torch would take the unbiased variance, n / (n - 1) times larger (4/3 at
    n = 4 values a channel). Eval mode and the state-dict keys are
    ``nn.BatchNorm2d``'s. With ``update_stats`` False (``stats_frozen``)
    train mode leaves the running statistics as they are."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # momentum 1 into fresh float32 buffers leaves exactly this batch's
        # mean and unbiased variance there
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        if not self.update_stats:
            return y
        n = x.numel() // x.shape[1]
        with torch.no_grad():    # (batch_norm's backward reads mean and var)
            for running, batch in ((self.running_mean, mean),
                                   (self.running_var, var * ((n - 1) / n))):
                running.copy_(running * MOMENTUM + batch * (1.0 - MOMENTUM))
        return y


@contextlib.contextmanager
def stats_frozen(module: nn.Module) -> Iterator[None]:
    """Within the context, no ``BatchNorm2d`` of ``module`` writes its
    running statistics; train mode still normalises with batch statistics."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    before = [m.update_stats for m in bns]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m, flag in zip(bns, before):
            m.update_stats = flag


@contextlib.contextmanager
def training(module: nn.Module, mode: bool = True) -> Iterator[nn.Module]:
    """``module`` in train mode (``mode``) within the context; its former
    mode after."""
    before = module.training
    module.train(mode)
    try:
        yield module
    finally:
        module.train(before)


def remat_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` whose activations are recomputed in the backward instead
    of kept (``torch.utils.checkpoint``, non-reentrant), flax's ``nn.remat``
    of one block. The recomputation runs under ``stats_frozen``: a
    train-mode BatchNorm normalises with the same batch statistics again and
    does not advance its running ones a second time. Without autograd it is
    ``block(x)``."""
    if not torch.is_grad_enabled():
        return block(x)
    return checkpoint(block, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), stats_frozen(block)))


class ConvBNAct(nn.Module):
    """Conv2d (no bias) + BatchNorm (``BatchNorm2d``) + optional activation.
    Padding is ``(k - 1) // 2`` on both sides."""

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
        self.bn = BatchNorm2d(out_channels)
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
