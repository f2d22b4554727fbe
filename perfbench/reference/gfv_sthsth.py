"""Plain reference of AdaFocus-TSM, the Something-Something model (``family:
gfv_sthsth``): the greedy deployment forward.

A TSM MobileNetV2 over the Tg glance frames gives maps and, through its
linear head, per-frame global logits; the policy sees each video division's
maps stacked along channels (frame-major) and emits one sigmoid (y, x) mean
a division; every focuser frame of a division is cropped at its division's
served action; a TSM ResNet-50 over the Tf patches and a linear head give
per-frame local logits; the output is the mean of the local logits plus the
mean of the global ones (sum consensus).
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference.nets import (
    crop, linear, mobilenet_v2, nchw, policy_outputs, resnet50, wide,
)
from perfbench.reference.precision import identity

CHUNK = 8


@torch.no_grad()
def serve(W, cfg: dict, frames, small, actions, q=identity) -> Dict[str, torch.Tensor]:
    """The forward at the served division ``actions`` (B, D, 2): the
    policy's means (B, D, 2) and the consensus logits (B, classes)."""
    policy, logits = [], []
    tg, tf, d = cfg["num_frames"], cfg["num_frames_focuser"], cfg["video_div"]
    for i in range(0, frames.shape[0], CHUNK):
        f, s, a = wide(frames[i:i + CHUNK]), wide(small[i:i + CHUNK]), actions[i:i + CHUNK]
        b = f.shape[0]
        fmap, pooled = mobilenet_v2(W, nchw(s.reshape((b * tg,) + s.shape[2:])), tg, q)
        global_logits = linear(pooled, W, "glancer.classifier", q).reshape(b, tg, -1)
        c, h, w = fmap.shape[1:]
        maps = fmap.reshape(b, d, (tg // d) * c, h, w)
        policy.append(policy_outputs(W, cfg, maps, q))
        per_frame = a.float().repeat_interleave(tf // d, dim=1).reshape(-1, 2)
        patches = crop(f.reshape((b * tf,) + f.shape[2:]), per_frame, cfg["patch_size"])
        feats = resnet50(W, nchw(patches), tf, q=q).reshape(b, tf, -1)
        local = linear(feats, W, "classifier.fc", q)
        logits.append(local.mean(dim=1) + global_logits.mean(dim=1))
    return {"policy": torch.cat(policy), "logits": torch.cat(logits)}
