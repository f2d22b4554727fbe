"""GFV, the Glance-Focus model (counterpart of adafocus_tpu/models/gfv.py).

The deployment forward runs in five phases, batched over B*T:

  1. glance:     MobileNetV2 over the downsampled frames;
  2. policy:     1x1-conv state encoder, GRU over T, greedy argmax;
  3. extraction: one batched crop of B*T patches (the CUDA kernel);
  4. focus:      ResNet-50 over the patches;
  5. classify:   concat [pooled 1280 | local 2048] -> GRU -> per-step FC.

With ``inference(..., fused="on")`` phases 1 and 4 run each residual block
of the backbones as one CUDA kernel (models/fused_inference.py). The
training steps (train/stages.py) compose the same phases: stages 0, 1 and 3
with ``train=True`` and ``forward_random``; stage 2 (PPO) with the sampled
rollout, ``classify_seq_with_hiddens`` and ``classifier_lookahead``.

The sth-sth family (``classifier="consensus"``, models/gfv_sthsth.py)
composes the same phases differently: temporal-shift backbones, 8 glance
and 12 focus frames, one continuous action per video division
(``policy_rollout_div``) and a per-frame head (``classify_frame_logits``)
under sum consensus.

AdaFocus+ (``frame_budget = K > 0``, models/gfv_plus.py) glances at all T
frames, selects K of them (``frame_scores`` and a top-K, or the
``select_rollout`` of a PPO-trained selector with ``plus_rl``) and runs the
policy, extraction and focus on those K only.

The public functions keep the JAX package's layouts: frames are
channels-last (B, T, S, S, 3), feature maps (B, T, gh, gw, C). Inside, the
backbones take NCHW views of channels-last memory, which is free.

A serving model keeps its parameters in ``cfg.dtype`` except BatchNorm's,
which stay float32. A training model (``param_dtype=torch.float32``) keeps
every parameter in float32 and computes in ``cfg.dtype`` under
``torch.autocast`` (``GFV.autocast``), as the JAX package keeps float32
parameters and computes in ``cfg.dtype``: a bf16 parameter would drop every
SGD update under about 2^-8 of its value. Patch actions are float32 in
every configuration.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from adafocus_torch import default_device
from adafocus_torch.models.classifiers import (
    ConsensusHead, LinearClassifier, RecurrentClassifier,
)
from adafocus_torch.models.fused_inference import fused_enabled, fused_focus, fused_glance
from adafocus_torch.models.gru import GRUCell
from adafocus_torch.models.mobilenet import MobileNetV2
from adafocus_torch.models.policy import ActorCritic, sample_rollout
from adafocus_torch.models.resnet import resnet50
from adafocus_torch.ops.patch import extract_patches_at, random_patch_actions
from adafocus_torch.utils.profiling import span

Device = Optional[Union[str, torch.device]]


@dataclasses.dataclass(frozen=True)
class GFVConfig:
    """Static model configuration, the fields of the JAX ``GFVConfig``."""

    num_classes: int = 200
    num_frames: int = 16          # T, the glancer's frames
    num_frames_focuser: int = 0   # sth-sth dual rate; 0 = num_frames
    image_size: int = 224
    glance_size: int = 224
    patch_size: int = 96
    action_dim: int = 49
    hidden_dim: int = 1024        # classifier GRU hidden
    policy_hidden: int = 1024
    policy_channels: int = 32     # state-encoder 1x1-conv width
    dtype: torch.dtype = torch.bfloat16  # compute and parameter dtype
    classifier: str = "gru"       # 'gru' | 'linear' (ActivityNet) | 'consensus' (sth-sth)
    continuous_policy: bool = False
    action_std: float = 0.25      # the continuous policy's Gaussian std (training)
    policy_conv: bool = True      # the state encoder's 1x1 conv; False: the MLP encoder
    policy_bn: bool = False       # BatchNorm after the encoder's 1x1 conv
    tsm: bool = False             # temporal-shift backbones
    video_div: int = 1            # sth-sth: one action per division
    with_glancer: bool = True     # sth-sth: add the glancer logits' consensus
    dropout: float = 0.5          # sth-sth local head's dropout
    partial_bn: bool = False      # TSM partial BatchNorm on the focuser (training)
    remat: bool = False           # per-block recomputation of both backbones
    frame_budget: int = 0         # AdaFocus+: the focuser sees K of the T frames
    selector_hidden: int = 256    # AdaFocus+ frame selector's GRU width
    plus_rl: bool = False         # AdaFocus+: the selector is a PPO agent
                                  # (SelectorActorCritic), not the ST top-K

    def __post_init__(self):
        if self.classifier not in ("gru", "linear", "consensus"):
            raise ValueError(f"unknown classifier {self.classifier!r}: "
                             "'gru', 'linear' or 'consensus'")

    @property
    def t_focuser(self) -> int:
        return self.num_frames_focuser or self.num_frames

    @property
    def sthsth(self) -> bool:
        """The sth-sth family: the consensus head over the division rollout."""
        return self.classifier == "consensus"

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
    ``param_dtype`` (``cfg.dtype`` when None: the serving model; float32 for
    training). The model is built in eval mode; each phase method sets its
    backbone's mode from its ``train`` argument.
    """

    def __init__(self, cfg: GFVConfig, device: Device = None,
                 generator: Optional[torch.Generator] = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dev = default_device(device)
        self.cfg = cfg
        self.param_dtype = cfg.dtype if param_dtype is None else param_dtype
        self.glancer = MobileNetV2(num_classes=cfg.num_classes,
                                   n_frames=cfg.num_frames if cfg.tsm else 0,
                                   remat=cfg.remat)
        self.focuser = resnet50(num_classes=cfg.num_classes,
                                n_frames=cfg.t_focuser if cfg.tsm else 0,
                                partial_bn=cfg.partial_bn, remat=cfg.remat)
        g = cfg.glance_map_size
        # the sth-sth policy sees a division's maps channel-stacked
        policy_in = cfg.glance_dim * (cfg.num_frames // cfg.video_div if cfg.sthsth else 1)
        self.policy = ActorCritic(
            policy_in, (g, g), action_dim=cfg.action_dim,
            hidden_dim=cfg.policy_hidden, encoder_channels=cfg.policy_channels,
            continuous=cfg.continuous_policy, encoder_bn=cfg.policy_bn,
            action_std=cfg.action_std, encoder_conv=cfg.policy_conv,
        )
        if cfg.sthsth:
            self.classifier = ConsensusHead(cfg.focus_dim, cfg.num_classes, cfg.dropout)
        elif cfg.classifier == "linear":
            self.classifier = LinearClassifier(cfg.fused_dim, cfg.num_classes)
        else:
            self.classifier = RecurrentClassifier(
                cfg.fused_dim, cfg.num_classes, hidden_dim=cfg.hidden_dim
            )
        if cfg.frame_budget > 0:   # the AdaFocus+ temporal selection head
            from adafocus_torch.models.gfv_plus import FrameSelector, SelectorActorCritic

            if cfg.frame_budget > cfg.num_frames:
                raise ValueError(f"frame_budget {cfg.frame_budget} > num_frames "
                                 f"{cfg.num_frames}")
            if cfg.plus_rl:
                self.selector_ac = SelectorActorCritic(cfg.glance_dim, cfg.selector_hidden)
            else:
                self.selector = FrameSelector(cfg.glance_dim, cfg.selector_hidden)
        self.reset_parameters(generator)
        self.eval()
        self.to(device=dev, dtype=self.param_dtype, memory_format=torch.channels_last)
        # BatchNorm in float32 at least; its fresh 1/0/0/1 values are exact
        # in any float dtype, so the round trip loses nothing
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.to(torch.promote_types(self.param_dtype, torch.float32))

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

    def autocast(self) -> torch.autocast:
        """The compute-dtype context: autocast to ``cfg.dtype`` when the
        parameters are in another dtype (a training model), a no-op for a
        serving model."""
        return torch.autocast(self.device.type, dtype=self.cfg.dtype,
                              enabled=self.param_dtype != self.cfg.dtype)

    # ---- phase 1: glance -------------------------------------------------

    def _glancer_features(self, frames_small: torch.Tensor, train: bool):
        _set_mode(self.glancer, train)
        b, t = frames_small.shape[:2]
        x = frames_small.reshape((b * t,) + frames_small.shape[2:])
        return self.glancer.features(x.to(self.cfg.dtype).permute(0, 3, 1, 2))

    def glance(self, frames_small: torch.Tensor, train: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, g, g, 3) -> map (B, T, gh, gw, 1280), pooled (B, T, 1280);
        the glancer in train mode when ``train``."""
        b, t = frames_small.shape[:2]
        fmap, pooled = self._glancer_features(frames_small, train)
        fmap = fmap.permute(0, 2, 3, 1)
        return fmap.reshape((b, t) + fmap.shape[1:]), pooled.reshape(b, t, -1)

    def glance_logits(self, frames_small: torch.Tensor, train: bool = False,
                      keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Stage-0 glancer head: (B, T, g, g, 3) -> logits (B, T, classes).
        ``keep`` is the dropout mask (B*T, 1280) in train mode
        (``MobileNetV2.classify``)."""
        b, t = frames_small.shape[:2]
        _, pooled = self._glancer_features(frames_small, train)
        return self.glancer.classify(pooled, keep).reshape(b, t, -1)

    # ---- phase 2: policy -------------------------------------------------

    def policy_rollout(self, fmap: torch.Tensor, mode: str = "greedy",
                       generator: Optional[torch.Generator] = None
                       ) -> Dict[str, torch.Tensor]:
        """fmap (B, T, gh, gw, C) -> actions (B, T, 2) float32 in [0, 1]^2,
        action_idx, logprob and value (B, T); mode 'greedy' or 'sample'
        (drawn from ``generator``). The policy runs in eval mode (its
        BatchNorm on running statistics)."""
        _set_mode(self.policy, False)
        _, actor_out, value = self.policy.rollout_states(fmap.transpose(0, 1))
        actions, idx, logprob = sample_rollout(actor_out, mode, self.cfg.action_dim,
                                               generator, self.cfg.continuous_policy,
                                               self.cfg.action_std)
        return {
            "actions": actions.transpose(0, 1).float(),
            "action_idx": idx.transpose(0, 1),
            "logprob": logprob.transpose(0, 1),
            "value": value.transpose(0, 1).float(),
        }

    def policy_rollout_div(self, fmap: torch.Tensor, mode: str = "greedy",
                           generator: Optional[torch.Generator] = None
                           ) -> Dict[str, torch.Tensor]:
        """The sth-sth rollout: one action per video division, the policy
        seeing the division's maps channel-stacked in the JAX package's order
        (frame-major, ``jnp.moveaxis(..., 2, 4)``). fmap (B, Tg, gh, gw, C)
        -> the dict of ``policy_rollout`` with time axis ``video_div``."""
        return self.policy_rollout(self.division_maps(fmap), mode, generator)

    def division_maps(self, fmap: torch.Tensor) -> torch.Tensor:
        """fmap (B, Tg, gh, gw, C) -> each division's maps channel-stacked,
        (B, video_div, gh, gw, (Tg / video_div) * C), the policy's input."""
        b, tg, gh, gw, c = fmap.shape
        d = self.cfg.video_div
        if tg % d:
            raise ValueError(f"num_frames {tg} not divisible by video_div {d}")
        stacked = fmap.reshape(b, d, tg // d, gh, gw, c).movedim(2, 4)
        return stacked.reshape(b, d, gh, gw, (tg // d) * c)

    def frame_scores(self, pooled: torch.Tensor) -> torch.Tensor:
        """AdaFocus+ selector: pooled glance features (B, T, 1280) -> frame
        scores (B, T) float32 at least."""
        return self.selector(pooled)

    def select_rollout(self, pooled: torch.Tensor, mode: str = "sample",
                       generator: Optional[torch.Generator] = None,
                       actions: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """AdaFocus+ joint-RL temporal policy (``plus_rl``): the K-slot
        sequential frame selection (``gfv_plus.SelectorActorCritic.rollout``)."""
        return self.selector_ac.rollout(pooled, self.cfg.frame_budget, mode, generator,
                                        actions)

    # ---- phase 3: focus + classify ---------------------------------------

    def focus(self, patches: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(N, P, P, 3) -> (N, 2048) pooled focuser features; the focuser in
        train mode when ``train``."""
        _set_mode(self.focuser, train)
        return self.focuser.features(patches.to(self.cfg.dtype).permute(0, 3, 1, 2))[1]

    def focus_logits(self, patches: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Stage-0 focuser head: (N, P, P, 3) -> logits (N, classes)."""
        _set_mode(self.focuser, train)
        return self.focuser(patches.to(self.cfg.dtype).permute(0, 3, 1, 2))

    def classify_frame_logits(self, features: torch.Tensor, train: bool = False,
                              keep: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None
                              ) -> torch.Tensor:
        """The sth-sth head: focuser features (B, T, 2048) -> per-frame local
        logits (B, T, classes); its dropout active when ``train``, its mask
        ``keep`` (B, T, 2048) or drawn from ``generator``
        (``ConsensusHead``)."""
        _set_mode(self.classifier, train)
        return self.classifier(features.to(self.cfg.dtype), keep, generator)

    def classify_seq(self, fused: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> per-step logits (B, T, classes)."""
        return self.classifier(fused)

    def classify_linear(self, fused: torch.Tensor) -> torch.Tensor:
        """The linear head: (B, T, D) -> consensus log-probabilities (B, classes)."""
        return self.classifier(fused)

    def classifier_step(self, hidden: torch.Tensor, feature: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One MDP step of the GRU head: (h, (B, D)) -> (h', logits)."""
        return self.classifier.step(hidden, feature)

    def classify_seq_with_hiddens(self, fused: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, D) -> (per-step logits (B, T, classes), hiddens (B, T, H))."""
        return self.classifier.forward_with_hiddens(fused)

    def classifier_lookahead(self, hidden: torch.Tensor, feature: torch.Tensor
                             ) -> torch.Tensor:
        """Logits of one GRU step from a trajectory's hidden, which is not
        advanced: (N, H), (N, D) -> (N, classes)."""
        return self.classifier.lookahead(hidden, feature)


def _set_mode(module: nn.Module, train: bool) -> None:
    if module.training != train:
        module.train(train)


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
    """(B, T, S, S, C) frames + (B, T, 2) actions -> (B*T, P, P, C).

    On the GPU one kernel launch computes the offsets (``patch_offsets``)
    and the patches. Differentiable with respect to ``frames``."""
    return extract_patches_at(frames, actions, image_size, patch_size)


def fuse_and_classify(model: GFV, pooled: torch.Tensor, local: torch.Tensor
                      ) -> torch.Tensor:
    """concat([pooled 1280 | local 2048]) -> the GRU classifier's per-step
    logits (B, T, classes), or the linear head's log-probabilities (B,
    classes)."""
    fused = torch.cat([pooled, local], dim=-1).to(model.cfg.dtype)
    if model.cfg.classifier == "linear":
        return model.classify_linear(fused)
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
    with span("focus"):
        local = fused_focus(model, patches) if fused else model.focus(patches)
    with span("classify"):
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
    must already be. Returns per-step logits (B, T, classes), the last step
    the prediction (the linear head: log-probabilities (B, classes)).
    The call is the span ``serve``, its phases ``glance``, ``policy``,
    ``focus`` and ``classify`` (``utils/profiling.py span``).
    """
    if model.cfg.sthsth:
        raise ValueError("a consensus-head (sth-sth) model serves through "
                         "models.gfv_sthsth.inference_sthsth")
    with span("serve"):
        frames, frames_small = _on_model_device(model, device, frames, frames_small)
        use_fused = fused_enabled(fused)
        with model.autocast():
            with span("glance"):
                fmap, pooled = (fused_glance(model, frames_small) if use_fused
                                else model.glance(frames_small))
            with span("policy"):
                roll = model.policy_rollout(fmap)
            return _focus_and_classify(model, frames, pooled, roll["actions"], use_fused)


@torch.inference_mode()
def inference_with_actions(model: GFV, frames: torch.Tensor,
                           frames_small: torch.Tensor, actions: torch.Tensor,
                           device: Device = None) -> torch.Tensor:
    """Deployment forward with externally supplied (B, T, 2) patch actions in
    [0, 1]^2; the policy is bypassed. Returns per-step logits like
    ``inference``."""
    with span("serve"):
        frames, frames_small, actions = _on_model_device(
            model, device, frames, frames_small, actions)
        with model.autocast():
            with span("glance"):
                _, pooled = model.glance(frames_small)
            return _focus_and_classify(model, frames, pooled, actions)


def forward_random(model: GFV, frames: torch.Tensor, frames_small: torch.Tensor,
                   generator: torch.Generator, train: bool = True,
                   actions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The stage-1 forward on random patches: glance, extraction at uniform
    random actions drawn from ``generator`` (on the model's device), focus
    and classify, both backbones in train mode when ``train`` (their
    running statistics advance). ``actions`` (B, T, 2) replaces the draw.
    Records autograd as the caller's grad mode says; runs under
    ``model.autocast()``. Returns per-step logits (B, T, classes) (the
    linear head: log-probabilities (B, classes))."""
    cfg = model.cfg
    b, t = frames_small.shape[:2]
    if actions is None:
        actions = random_patch_actions((b, t), generator, model.device)
    with model.autocast():
        _, pooled = model.glance(frames_small, train)
        patches = extract_for_frames(frames, actions, cfg.image_size, cfg.patch_size)
        local = model.focus(patches, train).reshape(b, t, -1)
        return fuse_and_classify(model, pooled, local)
