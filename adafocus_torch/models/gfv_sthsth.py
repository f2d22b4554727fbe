"""The Something-Something family's deployment forward (counterpart of
adafocus_tpu/models/gfv_sthsth.py).

A TSM MobileNetV2 glancer gives per-frame feature maps and *logits* over
Tg downsampled frames; the policy takes one continuous action per video
division, seeing the division's maps channel-stacked
(``GFV.policy_rollout_div``); every focuser frame of a division is cropped
at its division's action, all B*Tf patches in one extraction launch; a TSM
ResNet-50 focuser and a dropout + FC head give per-frame local logits; the
prediction is the average consensus of the local logits plus, with
``cfg.with_glancer``, that of the glancer's (``sum_consensus``).

As in the JAX package, the focuser runs once over all Tf patches, where the
original model re-ran it over the patches accumulated at every division.
Frames are the port's unpadded (B, Tf, S, S, 3); the JAX package's lane
padding is its TPU kernel's layout and is not carried over.

Training composes the same phases (train/stages_sthsth.py):
``forward_random_sthsth`` is stage 1's forward, and
``divisional_confidences`` gives stage 2's per-division rewards.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.nn import functional as F

from adafocus_torch.models.classifiers import avg_consensus
from adafocus_torch.models.fused_inference import (
    fused_enabled, fused_focus, fused_glance_logits,
)
from adafocus_torch.models.gfv import GFV, Device, _on_model_device, extract_for_frames
from adafocus_torch.ops.patch import random_patch_actions
from adafocus_torch.utils.profiling import span


def actions_per_frame(actions_div: torch.Tensor, t_focuser: int) -> torch.Tensor:
    """(B, D, 2) division actions -> (B, Tf, 2): every focuser frame of a
    division gets its division's crop."""
    return actions_div.repeat_interleave(t_focuser // actions_div.shape[1], dim=1)


def sum_consensus(global_logits: Optional[torch.Tensor], local_logits: torch.Tensor,
                  with_glancer: bool = True) -> torch.Tensor:
    """consensus(local (B, Tf, C)) [+ consensus(global (B, Tg, C))] -> (B, C)."""
    total = avg_consensus(local_logits)
    if with_glancer and global_logits is not None:
        total = total + avg_consensus(global_logits)
    return total


def glance_logits(model: GFV, frames_small: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TSM glance: (B, Tg, g, g, 3) -> (maps (B, Tg, gh, gw, 1280),
    per-frame glancer logits (B, Tg, classes)), eval mode."""
    fmap, pooled = model.glance(frames_small)
    return fmap, model.glancer.classify(pooled)


def local_frame_logits(model: GFV, patches: torch.Tensor, b: int, train: bool = False,
                       keep: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """patches (B*Tf, P, P, 3) -> per-frame local logits (B, Tf, classes):
    focuser features, then the dropout + FC head, both in train mode when
    ``train`` (the dropout's mask ``keep`` or drawn from ``generator``)."""
    feats = model.focus(patches, train)
    return model.classify_frame_logits(feats.reshape(b, -1, feats.shape[-1]), train, keep,
                                       generator)


def glance_division_rollout(model: GFV, frames_small: torch.Tensor, mode: str = "greedy",
                            generator: Optional[torch.Generator] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Phases 1 + 2: (maps, global logits, the per-division rollout dict)."""
    fmap, global_logits = glance_logits(model, frames_small)
    return fmap, global_logits, model.policy_rollout_div(fmap, mode, generator)


def _check_frames(model: GFV, frames: torch.Tensor, frames_small: torch.Tensor) -> None:
    cfg = model.cfg
    if not cfg.sthsth:
        raise ValueError("the sth-sth forward needs classifier='consensus'")
    if frames.shape[1] != cfg.t_focuser or frames_small.shape[1] != cfg.num_frames:
        raise ValueError(
            f"frames (B, {frames.shape[1]}, ...) and frames_small (B, "
            f"{frames_small.shape[1]}, ...): the configuration has {cfg.t_focuser} "
            f"focuser and {cfg.num_frames} glancer frames")


def _focus_and_consensus(model: GFV, frames: torch.Tensor, global_logits: torch.Tensor,
                         actions_div: torch.Tensor, fused: bool = False) -> torch.Tensor:
    """Phases 3-5: one extraction at the divisions' actions, focus (on the
    fused path when ``fused``), the local head and the sum consensus."""
    cfg = model.cfg
    b, tf = frames.shape[:2]
    patches = extract_for_frames(frames, actions_per_frame(actions_div, tf),
                                 cfg.image_size, cfg.patch_size)
    with span("focus"):
        feats = fused_focus(model, patches) if fused else model.focus(patches)
    with span("classify"):
        local = model.classify_frame_logits(feats.reshape(b, tf, -1))
        return sum_consensus(global_logits, local, cfg.with_glancer)


@torch.inference_mode()
def inference_sthsth(model: GFV, frames: torch.Tensor, frames_small: torch.Tensor,
                     device: Device = None, fused: str = "auto") -> torch.Tensor:
    """Deployment forward of the sth-sth family with the greedy policy.

    frames: (B, Tf, S, S, 3) full-resolution focuser frames, unpadded.
    frames_small: (B, Tg, g, g, 3) glancer frames.
    fused: backbone path, as in ``models.gfv.inference``: 'on' runs every
    residual block of both TSM backbones as one hand-written kernel in its
    temporal-shift split; 'auto' and 'off' run the library convs.
    Runs on ``device`` (the GPU unless ``device="cpu"``), where the model
    must already be. Returns the summed consensus logits (B, classes).
    The call is the span ``serve``, its phases ``glance`` (with the
    glancer's logits), ``policy``, ``focus`` and ``classify`` (the local
    head and the consensus).
    """
    with span("serve"):
        frames, frames_small = _on_model_device(model, device, frames, frames_small)
        _check_frames(model, frames, frames_small)
        use_fused = fused_enabled(fused)
        with model.autocast():
            with span("glance"):
                fmap, global_logits = (fused_glance_logits(model, frames_small) if use_fused
                                       else glance_logits(model, frames_small))
            with span("policy"):
                roll = model.policy_rollout_div(fmap)
            return _focus_and_consensus(model, frames, global_logits, roll["actions"],
                                        use_fused)


@torch.inference_mode()
def inference_sthsth_with_actions(model: GFV, frames: torch.Tensor,
                                  frames_small: torch.Tensor, actions_div: torch.Tensor,
                                  device: Device = None) -> torch.Tensor:
    """Deployment forward with externally supplied per-division actions
    (B, D, 2) in [0, 1]^2; the policy is bypassed. Returns (B, classes)
    like ``inference_sthsth``."""
    with span("serve"):
        frames, frames_small, actions_div = _on_model_device(
            model, device, frames, frames_small, actions_div)
        _check_frames(model, frames, frames_small)
        with model.autocast():
            with span("glance"):
                _, global_logits = glance_logits(model, frames_small)
            return _focus_and_consensus(model, frames, global_logits, actions_div)


def forward_random_sthsth(model: GFV, frames: torch.Tensor, frames_small: torch.Tensor,
                          generator: Optional[torch.Generator], train: bool = True,
                          actions: Optional[torch.Tensor] = None,
                          keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The stage-1 forward on random patches: the frozen TSM glance (eval
    mode, no autograd), one uniform random patch a focuser frame, the
    focuser and the head in train mode when ``train`` (the focuser's
    running statistics advance), the sum consensus. Draws from
    ``generator`` (on the model's device), in this order, the actions
    (B, Tf, 2) and the head's dropout mask (B, Tf, 2048); ``actions`` and
    ``keep`` replace them. Records autograd as the caller's grad mode says;
    runs under ``model.autocast()``. Returns (B, classes)."""
    cfg = model.cfg
    b, tf = frames.shape[:2]
    if actions is None:
        actions = random_patch_actions((b, tf), generator, model.device)
    with model.autocast():
        with torch.no_grad():
            _, global_logits = glance_logits(model, frames_small)
        patches = extract_for_frames(frames, actions, cfg.image_size, cfg.patch_size)
        local = local_frame_logits(model, patches, b, train, keep, generator)
        return sum_consensus(global_logits, local, cfg.with_glancer)


def divisional_confidences(local_logits: torch.Tensor, random_logits: torch.Tensor,
                           global_logits: Optional[torch.Tensor], labels: torch.Tensor,
                           video_div: int, with_glancer: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-division confidences of the label, stage 2's rewards.

    After division d the policy's logits are the mean of the per-frame
    local logits of divisions <= d (plus the glancer's consensus), and the
    baseline's swap division d's frames for those of random patches: the
    original model's accumulate-and-rerun, computed incrementally.
    local_logits / random_logits (B, Tf, C) from the policy's / random
    patches, global_logits (B, Tg, C). Returns (policy's, baseline's)
    softmax probability of the label, (B, D) float32."""
    b, tf, c = local_logits.shape
    f = tf // video_div
    blocks_pol = local_logits.reshape(b, video_div, f, c).sum(dim=2)
    blocks_rnd = random_logits.reshape(b, video_div, f, c).sum(dim=2)
    cum_pol = blocks_pol.cumsum(dim=1)
    denom = (torch.arange(1, video_div + 1, device=cum_pol.device) * f).reshape(1, -1, 1)
    total_pol = cum_pol / denom
    total_base = (cum_pol - blocks_pol + blocks_rnd) / denom
    if with_glancer and global_logits is not None:
        g = avg_consensus(global_logits)[:, None, :]
        total_pol = total_pol + g
        total_base = total_base + g

    def conf(logits):
        probs = F.softmax(logits.float(), dim=-1)
        return probs.gather(-1, labels.long().reshape(b, 1, 1).expand(b, video_div, 1))[..., 0]

    return conf(total_pol), conf(total_base)
