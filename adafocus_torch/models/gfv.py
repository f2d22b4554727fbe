"""GFV, the Glance-Focus model (counterpart of adafocus_tpu/models/gfv.py).

The deployment forward runs in five phases, batched over B*T:

  1. glance:     MobileNetV2 over the downsampled frames;
  2. policy:     1x1-conv state encoder, GRU over T, greedy argmax;
  3. extraction: one batched crop of B*T patches (the CUDA kernel);
  4. focus:      ResNet-50 over the patches;
  5. classify:   concat [pooled 1280 | local 2048] -> GRU -> per-step FC.

With ``inference(..., fused="on")`` phases 1 and 4 run each residual block
of the backbones as one CUDA kernel (models/fused_inference.py).

The public functions keep the JAX package's layouts: frames are
channels-last (B, T, S, S, 3), feature maps (B, T, gh, gw, C). Inside, the
backbones take NCHW views of channels-last memory, which is free.

Parameters live in ``cfg.dtype`` except BatchNorm's, which stay float32
(the usual mixed-precision arrangement; the JAX package also normalises in
float32 and keeps every parameter float32). Patch actions are float32 in
every configuration.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from adafocus_torch import default_device
from adafocus_torch.models.classifiers import RecurrentClassifier
from adafocus_torch.models.fused_inference import fused_enabled, fused_focus, fused_glance
from adafocus_torch.models.gru import GRUCell
from adafocus_torch.models.mobilenet import MobileNetV2
from adafocus_torch.models.policy import ActorCritic, sample_rollout
from adafocus_torch.models.resnet import resnet50
from adafocus_torch.ops.patch import extract_patches, patch_offsets

Device = Optional[Union[str, torch.device]]


@dataclasses.dataclass(frozen=True)
class GFVConfig:
    """Static model configuration, the fields of the JAX ``GFVConfig`` that
    the ActivityNet deployment forward reads. Fields of the other families
    exist so that setting them fails loudly until they are ported."""

    num_classes: int = 200
    num_frames: int = 16
    image_size: int = 224
    glance_size: int = 224
    patch_size: int = 96
    action_dim: int = 49
    hidden_dim: int = 1024        # classifier GRU hidden
    policy_hidden: int = 1024
    policy_channels: int = 32     # state-encoder 1x1-conv width
    dtype: torch.dtype = torch.bfloat16  # compute and parameter dtype
    # not ported yet: each must keep its default
    classifier: str = "gru"
    continuous_policy: bool = False
    policy_conv: bool = True
    policy_bn: bool = False
    tsm: bool = False
    video_div: int = 1
    frame_budget: int = 0

    def __post_init__(self):
        unported = {
            "classifier": self.classifier != "gru",
            "continuous_policy": self.continuous_policy,
            "policy_conv": not self.policy_conv,
            "policy_bn": self.policy_bn,
            "tsm": self.tsm,
            "video_div": self.video_div > 1,
            "frame_budget": self.frame_budget > 0,
        }
        for name, is_set in unported.items():
            if is_set:
                raise NotImplementedError(
                    f"GFVConfig.{name}={getattr(self, name)!r} is not ported yet"
                )

    @property
    def glance_dim(self) -> int:
        return 1280

    @property
    def focus_dim(self) -> int:
        return 2048

    @property
    def fused_dim(self) -> int:
        return self.glance_dim + self.focus_dim

    @property
    def glance_map_size(self) -> int:
        """Side of the glancer's feature map: five stride-2 stages, each
        ``ceil(s / 2)`` with padding (k - 1) // 2."""
        s = self.glance_size
        for _ in range(5):
            s = math.ceil(s / 2)
        return s


def flagship(tiny: bool = False) -> GFVConfig:
    """The ActivityNet flagship (T=16, 224^2 frames and glance, 96^2 patches,
    49 anchors, 200 classes, bf16), or the tiny float32 test configuration;
    the same sizes as ``__graft_entry__.py``'s."""
    if tiny:
        return GFVConfig(
            num_classes=10, num_frames=2, image_size=24, glance_size=16,
            patch_size=16, action_dim=4, hidden_dim=16, policy_hidden=16,
            dtype=torch.float32,
        )
    return GFVConfig(
        num_classes=200, num_frames=16, image_size=224, glance_size=224,
        patch_size=96, action_dim=49, dtype=torch.bfloat16,
    )


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Truncated normal (2 std) of variance 1 / fan_in, flax's default."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w.copy_(torch.nn.init.trunc_normal_(
        torch.empty_like(w), std=std, a=-2 * std, b=2 * std, generator=generator))


class GFV(nn.Module):
    """Parameter container with one method per phase. Compose the phases
    with the functions below (``inference``, ``inference_with_actions``).

    Weights are initialised on the CPU from ``generator`` (seed 0 when
    None), flax's initialisers in kind, then moved to ``device`` and
    ``cfg.dtype``. The model is built in eval mode.
    """

    def __init__(self, cfg: GFVConfig, device: Device = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = default_device(device)
        self.cfg = cfg
        self.glancer = MobileNetV2(num_classes=cfg.num_classes)
        self.focuser = resnet50(num_classes=cfg.num_classes)
        g = cfg.glance_map_size
        self.policy = ActorCritic(
            cfg.glance_dim, (g, g), action_dim=cfg.action_dim,
            hidden_dim=cfg.policy_hidden, encoder_channels=cfg.policy_channels,
        )
        self.classifier = RecurrentClassifier(
            cfg.fused_dim, cfg.num_classes, hidden_dim=cfg.hidden_dim
        )
        self.reset_parameters(generator)
        self.eval()
        self.to(device=dev, dtype=cfg.dtype, memory_format=torch.channels_last)
        # BatchNorm back to float32; its fresh 1/0/0/1 values are exact in
        # any float dtype, so the round trip loses nothing
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.float()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, GRUCell):
                m.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.classifier.fc.weight.device

    # ---- phase 1: glance -------------------------------------------------

    def glance(self, frames_small: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, g, g, 3) -> map (B, T, gh, gw, 1280), pooled (B, T, 1280)."""
        b, t = frames_small.shape[:2]
        x = frames_small.reshape((b * t,) + frames_small.shape[2:])
        fmap, pooled = self.glancer.features(x.to(self.cfg.dtype).permute(0, 3, 1, 2))
        fmap = fmap.permute(0, 2, 3, 1)
        return fmap.reshape((b, t) + fmap.shape[1:]), pooled.reshape(b, t, -1)

    # ---- phase 2: policy -------------------------------------------------

    def policy_rollout(self, fmap: torch.Tensor, mode: str = "greedy"
                       ) -> Dict[str, torch.Tensor]:
        """fmap (B, T, gh, gw, C) -> actions (B, T, 2) float32 in [0, 1]^2,
        action_idx, logprob and value (B, T)."""
        _, actor_out, value = self.policy.rollout_states(fmap.transpose(0, 1))
        actions, idx, logprob = sample_rollout(actor_out, mode, self.cfg.action_dim)
        return {
            "actions": actions.transpose(0, 1),
            "action_idx": idx.transpose(0, 1),
            "logprob": logprob.transpose(0, 1),
            "value": value.transpose(0, 1).float(),
        }

    # ---- phase 3: focus + classify ---------------------------------------

    def focus(self, patches: torch.Tensor) -> torch.Tensor:
        """(N, P, P, 3) -> (N, 2048) pooled focuser features."""
        x = patches.to(self.cfg.dtype).permute(0, 3, 1, 2)
        return self.focuser.features(x)[1]

    def classify_seq(self, fused: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> per-step logits (B, T, classes)."""
        return self.classifier(fused)


# ---------------------------------------------------------------------------
# Composition functions (the model's public forward surfaces).
# ---------------------------------------------------------------------------


def glance_policy_actions(model: GFV, frames_small: torch.Tensor,
                          mode: str = "greedy"):
    """Phases 1 + 2: (fmap, pooled, rollout dict)."""
    fmap, pooled = model.glance(frames_small)
    return fmap, pooled, model.policy_rollout(fmap, mode)


def extract_for_frames(frames: torch.Tensor, actions: torch.Tensor,
                       image_size: int, patch_size: int) -> torch.Tensor:
    """(B, T, S, S, C) frames + (B, T, 2) actions -> (B*T, P, P, C)."""
    b, t = frames.shape[:2]
    offs = patch_offsets(actions.reshape(b * t, 2), image_size, patch_size)
    return extract_patches(frames.reshape((b * t,) + frames.shape[2:]), offs,
                           patch_size)


def fuse_and_classify(model: GFV, pooled: torch.Tensor, local: torch.Tensor
                      ) -> torch.Tensor:
    """concat([pooled 1280 | local 2048]) -> GRU classifier."""
    fused = torch.cat([pooled, local], dim=-1).to(model.cfg.dtype)
    return model.classify_seq(fused)


def _on_model_device(model: GFV, device: Device, *arrays):
    dev = default_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, asked to run on {dev}")
    return [torch.as_tensor(a, device=dev).contiguous() for a in arrays]


def _focus_and_classify(model: GFV, frames: torch.Tensor, pooled: torch.Tensor,
                        actions: torch.Tensor, fused: bool = False) -> torch.Tensor:
    """Phases 3-5: extraction at ``actions``, focus (on the fused path when
    ``fused``), fuse and classify."""
    cfg = model.cfg
    b, t = pooled.shape[:2]
    patches = extract_for_frames(frames, actions, cfg.image_size, cfg.patch_size)
    local = fused_focus(model, patches) if fused else model.focus(patches)
    return fuse_and_classify(model, pooled, local.reshape(b, t, -1))


@torch.inference_mode()
def inference(model: GFV, frames: torch.Tensor, frames_small: torch.Tensor,
              device: Device = None, fused: str = "auto") -> torch.Tensor:
    """Deployment forward with the greedy policy.

    frames: (B, T, S, S, 3) full-resolution frames, unpadded.
    frames_small: (B, T, g, g, 3) downsampled frames.
    fused: backbone path. 'on' runs every residual block of both backbones
    as one hand-written kernel (models/fused_inference.py); 'auto' and
    'off' run the library convs, as 'auto' does in the JAX package.
    Runs on ``device`` (the GPU unless ``device="cpu"``), where the model
    must already be. Returns per-step logits (B, T, classes); the last step
    is the prediction.
    """
    frames, frames_small = _on_model_device(model, device, frames, frames_small)
    use_fused = fused_enabled(fused)
    if use_fused:
        fmap, pooled = fused_glance(model, frames_small)
        roll = model.policy_rollout(fmap)
    else:
        _, pooled, roll = glance_policy_actions(model, frames_small)
    return _focus_and_classify(model, frames, pooled, roll["actions"], use_fused)


@torch.inference_mode()
def inference_with_actions(model: GFV, frames: torch.Tensor,
                           frames_small: torch.Tensor, actions: torch.Tensor,
                           device: Device = None) -> torch.Tensor:
    """Deployment forward with externally supplied (B, T, 2) patch actions in
    [0, 1]^2; the policy is bypassed. Returns per-step logits like
    ``inference``."""
    frames, frames_small, actions = _on_model_device(
        model, device, frames, frames_small, actions)
    _, pooled = model.glance(frames_small)
    return _focus_and_classify(model, frames, pooled, actions)
