"""Supervised train steps and the eval step (counterpart of
adafocus_tpu/train/stages.py).

  stage 0  backbone pretraining: the GRU head's loss plus the glancer's CE
           on the downsampled frames and the focuser's CE on random patches;
  stage 1  random patches: glancer frozen, focuser and classifier train;
  stage 3  the frozen greedy policy's patches: only the classifier trains.

Stage 2 (PPO) is not ported yet. A frozen phase runs under
``torch.no_grad()`` with its backbone in eval mode, so its running
statistics stay as they are; its parameters are out of the optimizer
(train/optim.py). Where the JAX step returns a new state, a step here
updates the model and the optimizer in place, PyTorch's idiom.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch.nn import functional as F

from adafocus_torch.models.gfv import (
    GFV, GFVConfig, Device, extract_for_frames, fuse_and_classify, inference,
)
from adafocus_torch.ops.metrics import topk_accuracy
from adafocus_torch.ops.patch import random_patch_actions
from adafocus_torch.train.optim import OptimConfig, make_stage_optimizer

@dataclasses.dataclass
class TrainState:
    model: GFV
    optimizer: torch.optim.SGD
    scheduler: torch.optim.lr_scheduler.LambdaLR


def create_train_state(cfg: GFVConfig, stage: int, optim: OptimConfig = OptimConfig(),
                       device: Device = None,
                       generator: Optional[torch.Generator] = None) -> TrainState:
    """A training GFV (float32 parameters, compute in ``cfg.dtype``; weights
    from ``generator``) on ``device`` (the GPU unless ``device="cpu"``), and
    the optimizer and schedule of ``stage``."""
    model = GFV(cfg, device=device, generator=generator, param_dtype=torch.float32)
    return TrainState(model, *make_stage_optimizer(model, stage, optim))


def _ce_per_step(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over B*T of per-step logits (B, T, C), the label
    broadcast over time; log-softmax in float32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    b, t = logp.shape[:2]
    return -logp.gather(-1, labels.long().reshape(b, 1, 1).expand(b, t, 1)).mean()


def make_stage_train_step(model: GFV, stage: int, optimizer: torch.optim.Optimizer,
                          scheduler: torch.optim.lr_scheduler.LRScheduler) -> Callable:
    """Stage 0, 1 or 3. Returns ``step(batch, generator, actions=None,
    keep=None, mark=None) -> {"loss", "top1", "top5"}``.

    batch: ``frames`` (B, T, S, S, 3), ``frames_small`` (B, T, g, g, 3) and
    ``labels`` (B,), on the model's device. ``generator`` (on the model's
    device) draws the random actions of stages 0 and 1 and the stage-0
    dropout mask; ``actions`` (B, T, 2) and ``keep`` (B*T, 1280, bool)
    replace those draws. ``mark(phase)``, when given, is called as each
    phase has been enqueued, for timing: 'glance' (with the actions),
    'extract', 'focus', 'classify', 'heads' (stage 0's backbone heads),
    'backward', 'optimizer'. The metrics are 0-d tensors
    on the device: the loss and the top-1/top-5 accuracy of the last step's
    logits.
    """
    if stage not in (0, 1, 3):
        raise ValueError(f"stage {stage}: stages 0, 1 and 3 only (stage 2 is PPO)")
    if model.param_dtype not in (torch.float32, torch.float64):
        raise ValueError("a train step needs float32 parameters (create_train_state); "
                         f"this model's are {model.param_dtype}")
    cfg = model.cfg
    train_glancer = stage == 0
    train_focuser = stage in (0, 1)

    def step(batch: Dict[str, torch.Tensor], generator: torch.Generator,
             actions: Optional[torch.Tensor] = None, keep: Optional[torch.Tensor] = None,
             mark: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        frames, small, labels = batch["frames"], batch["frames_small"], batch["labels"]
        b, t = small.shape[:2]
        note = mark or (lambda phase: None)
        optimizer.zero_grad(set_to_none=True)
        with model.autocast():
            with torch.set_grad_enabled(train_glancer):
                fmap, pooled = model.glance(small, train_glancer)
            if actions is None and stage == 3:
                with torch.no_grad():
                    actions = model.policy_rollout(fmap)["actions"]
            elif actions is None:
                actions = random_patch_actions((b, t), generator, model.device)
            note("glance")
            patches = extract_for_frames(frames, actions, cfg.image_size, cfg.patch_size)
            note("extract")
            with torch.set_grad_enabled(train_focuser):
                local = model.focus(patches, train_focuser).reshape(b, t, -1)
            note("focus")
            logits = fuse_and_classify(model, pooled, local)
            loss = _ce_per_step(logits, labels)
            note("classify")
            if stage == 0:
                # As the JAX step does (stages.py:146-149, 193-205), the
                # stage-0 heads run each backbone a second time in train
                # mode, so every running statistic takes two momentum steps
                # a training step. Mirrored for parity, not fixed.
                if keep is None:
                    keep = torch.rand((b * t, cfg.glance_dim), generator=generator,
                                      device=model.device) < 1.0 - model.glancer.dropout_rate
                loss = loss + _ce_per_step(model.glance_logits(small, True, keep), labels)
                loss = loss + _ce_per_step(
                    model.focus_logits(patches, True).reshape(b, t, -1), labels)
                note("heads")
        loss.backward()
        note("backward")
        # optax updates every trainable leaf, one the loss does not reach
        # too (zero gradient: weight decay and momentum still move it)
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        optimizer.step()
        scheduler.step()
        note("optimizer")
        top1, top5 = topk_accuracy(logits[:, -1].detach(), labels)
        return {"loss": loss.detach(), "top1": top1, "top5": top5}

    return step


def make_eval_step(model: GFV) -> Callable:
    """The deployment eval: ``step(batch) -> (logits (B, T, classes),
    {"top1", "top5"})``, ``inference`` (greedy policy) and the top-k
    accuracy of the last step's logits; the host aggregates mAP over an
    epoch (ops/metrics.py)."""

    def step(batch: Dict[str, torch.Tensor]):
        logits = inference(model, batch["frames"], batch["frames_small"],
                           device=model.device)
        top1, top5 = topk_accuracy(logits[:, -1].float(), batch["labels"])
        return logits, {"top1": top1, "top5": top5}

    return step
