"""Fused deployment forward of the backbones (counterpart of
adafocus_tpu/models/fused_inference.py).

The modules (models/mobilenet.py, models/resnet.py) hold the parameters;
this module re-runs their inference forward with each residual block as ONE
CUDA kernel (ops/fused_blocks.py), so the blocks' hidden activations never
reach device memory. BatchNorm is folded into the convs at every call, as
the JAX package folds inside its traced function.

The stem, the max-pool and the head stay library ops (``F.conv2d``,
``F.max_pool2d``), as they stay XLA ops in the JAX package.

The temporal-shift (TSM) backbones, ``n_frames > 0``, split each shifted
block: the shift (``models/tsm.py``), then the kernel with
``use_res=False`` on the shifted input, then the residual outside the
kernel from the unshifted input. MobileNetV2 shifts its residual blocks
only and adds ``h + branch``; ResNet-50 shifts every bottleneck and adds
the ``down`` unit (a library conv with BatchNorm folded in) or the
identity, then the ReLU.

**Routing: ``fused='on'`` only.** ``'auto'`` and ``'off'`` keep the
library-conv path, as in the JAX package (``fused_enabled``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.nn import functional as F

from adafocus_torch.models.tsm import temporal_shift
from adafocus_torch.ops.fused_blocks import (
    fold_bn,
    fold_bottleneck,
    fold_inv_residual,
    fused_bottleneck,
    fused_inverted_residual,
)


def fused_enabled(fused: str = "auto") -> bool:
    """'on' | 'off' | 'auto': only 'on' takes the fused path; 'auto'
    resolves to the library-conv path, as it does in the JAX package."""
    return fused == "on"


def _conv_bn(x: torch.Tensor, unit, dtype: torch.dtype) -> torch.Tensor:
    """A ``ConvBNAct`` as a library conv with BatchNorm folded in:
    (N, H, W, C) -> (N, H', W', C'). The conv's output is in ``dtype``; the
    bias and the activation are applied in float32, then cast back."""
    weight, bias = fold_bn(unit, dtype)
    conv = unit.conv
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), weight, stride=conv.stride,
                 padding=conv.padding, groups=conv.groups)
    y = y.float() + bias.reshape(1, -1, 1, 1)
    if unit.act is not None:
        y = unit.act(y)
    return y.to(dtype).permute(0, 2, 3, 1).contiguous()


def mobilenet_features_fused(glancer, x: torch.Tensor, n_frames: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``MobileNetV2.features`` on the fused path: x (N, H, W, 3) in the
    compute dtype -> (feature map (N, h, w, 1280), pooled (N, 1280)).
    ``n_frames > 0``: the TSM glancer, T = ``n_frames`` frames a clip."""
    dtype = x.dtype
    h = _conv_bn(x, glancer.stem, dtype)
    for name in glancer.block_names:
        block = getattr(glancer, name)
        folded = fold_inv_residual(block, dtype)
        stride = block.dw.conv.stride[0]
        if block.use_res and n_frames > 0:
            shifted = temporal_shift(h, n_frames)
            h = h + fused_inverted_residual(shifted, folded, stride=stride, use_res=False)
        else:
            h = fused_inverted_residual(h, folded, stride=stride, use_res=block.use_res)
    fmap = _conv_bn(h, glancer.head_conv, dtype)
    return fmap, fmap.mean(dim=(1, 2))


def resnet_features_fused(focuser, x: torch.Tensor, n_frames: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ResNet.features`` on the fused path: stem, 3/2/1 max-pool, then one
    kernel per bottleneck. x (N, H, W, 3) -> (map (N, h, w, 2048), pooled).
    ``n_frames > 0``: the TSM focuser, T = ``n_frames`` frames a clip."""
    dtype = x.dtype
    h = _conv_bn(x, focuser.stem, dtype)
    h = F.max_pool2d(h.permute(0, 3, 1, 2), kernel_size=3, stride=2, padding=1)
    h = h.permute(0, 2, 3, 1).contiguous()
    for name in focuser.block_names:
        block = getattr(focuser, name)
        folded = fold_bottleneck(block, dtype)
        stride = block.conv2.conv.stride[0]
        if n_frames == 0:
            h = fused_bottleneck(h, folded, stride=stride, use_res=True)
            continue
        branch = fused_bottleneck(temporal_shift(h, n_frames), folded,
                                  stride=stride, use_res=False)
        if block.down is not None:
            res = _conv_bn(h, block.down, dtype)
        else:
            res = h[:, ::stride, ::stride, :]
        # a bf16 add sums in float32 and rounds once, and the ReLU commutes
        # with that rounding: JAX's relu(f32 + f32).astype(bf16), in two
        # passes over bf16 memory instead of five over float32
        h = (branch + res).relu_()
    return h, h.mean(dim=(1, 2))


def fused_glance(model, frames_small: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``GFV.glance`` on the fused path: (B, T, g, g, 3) -> map
    (B, T, gh, gw, 1280), pooled (B, T, 1280)."""
    cfg = model.cfg
    b, t = frames_small.shape[:2]
    flat = frames_small.reshape((b * t,) + frames_small.shape[2:])
    fmap, pooled = mobilenet_features_fused(model.glancer, flat.to(cfg.dtype),
                                            n_frames=cfg.num_frames if cfg.tsm else 0)
    return fmap.reshape((b, t) + fmap.shape[1:]), pooled.reshape(b, t, -1)


def fused_glance_logits(model, frames_small: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sth-sth glance on the fused path: (B, T, g, g, 3) -> (map
    (B, T, gh, gw, 1280), per-frame glancer logits (B, T, classes)); the
    head's dropout is the identity at inference."""
    fmap, pooled = fused_glance(model, frames_small)
    return fmap, model.glancer.classifier(pooled)


def fused_focus(model, patches: torch.Tensor) -> torch.Tensor:
    """``GFV.focus`` on the fused path: (N, P, P, 3) -> (N, 2048)."""
    cfg = model.cfg
    return resnet_features_fused(model.focuser, patches.to(cfg.dtype),
                                 n_frames=cfg.t_focuser if cfg.tsm else 0)[1]
