"""The sth-sth family's train and eval steps (counterpart of
adafocus_tpu/train/stages_sthsth.py).

  stage 1  random patches, one a focuser frame: the glancer frozen, the
           focuser and the consensus head train on the cross-entropy of the
           summed consensus logits;
  stage 2  PPO on the per-division policy, everything else frozen; the
           reward of division d is the label's confidence after it against
           that of random patches in its place (``divisional_confidences``);
  stage 3  the frozen greedy policy's patches: the focuser and the head
           train (the optimizer takes stage 1's freeze matrix,
           ``train.stages.optimizer_stage``).

Stage 0 has no step of this family, as in the JAX package: the recipe
warm-starts stage 1 from an ActivityNet stage-0 checkpoint, whose heads of
another class count keep their fresh weights (``train/checkpoint.py``).

As in train/stages.py, a step updates the model and its optimizer in place;
a frozen phase runs under ``torch.no_grad()`` with its module in eval mode.
Batches: ``frames`` (B, Tf, S, S, 3) focuser frames, unpadded,
``frames_small`` (B, Tg, g, g, 3) glancer frames, ``labels`` (B,). With
``replicas`` (``parallel/mesh.py``), as in train/stages.py, the batch is the
rank's shard and the gradients, running statistics, returns' moments and
metrics are averaged over the replicas; under partial BatchNorm the frozen
statistics are equal on every replica and average to themselves.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.nn import functional as F

from adafocus_torch.models.gfv import GFV, extract_for_frames
from adafocus_torch.models.gfv_sthsth import (
    actions_per_frame, divisional_confidences, glance_logits, inference_sthsth,
    local_frame_logits, sum_consensus,
)
from adafocus_torch.ops.metrics import topk_accuracy
from adafocus_torch.ops.patch import random_patch_actions
from adafocus_torch.parallel.mesh import Replicas, average_bn_stats_, average_metrics
from adafocus_torch.ppo.core import (
    PPOConfig, PPOState, compute_rewards, discounted_returns, ppo_update,
)
from adafocus_torch.train.stages import (
    _check_learner, _check_trainable, _rollout_time_major, _sgd_step,
)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of (B, C) logits, log-softmax in float32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def make_sthsth_train_step(model: GFV, stage: int, optimizer: torch.optim.Optimizer,
                           scheduler: torch.optim.lr_scheduler.LRScheduler,
                           replicas: Optional[Replicas] = None) -> Callable:
    """Stage 1 or 3. Returns ``step(batch, generator, actions=None,
    keep=None, mark=None) -> {"loss", "top1", "top5"}``.

    ``generator`` (on the model's device) draws, in this order, stage 1's
    random actions (B, Tf, 2) and the head's dropout mask (B, Tf, 2048);
    ``actions`` and ``keep`` replace them (stage 3's actions are the greedy
    policy's, one a division, unless given per frame). ``mark(phase)``,
    when given, is called as each phase has been enqueued: 'glance' (with
    the actions), 'extract', 'focus', 'classify', 'backward', 'optimizer'.
    The metrics are 0-d tensors on the device.
    """
    if stage not in (1, 3):
        raise ValueError(f"stage {stage}: the sth-sth family trains stages 1 and 3 here, "
                         "stage 2 by make_sthsth_stage2_step; it has no stage 0 (warm-start "
                         "stage 1 from an ActivityNet stage-0 checkpoint)")
    _check_trainable(model, sthsth=True)
    cfg = model.cfg

    def step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
             actions: Optional[torch.Tensor] = None, keep: Optional[torch.Tensor] = None,
             mark: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        frames, small, labels = batch["frames"], batch["frames_small"], batch["labels"]
        b, tf = frames.shape[:2]
        note = mark or (lambda phase: None)
        optimizer.zero_grad(set_to_none=True)
        with model.autocast():
            with torch.no_grad():
                fmap, global_logits = glance_logits(model, small)
                if actions is None and stage == 3:
                    actions = actions_per_frame(model.policy_rollout_div(fmap)["actions"], tf)
            del fmap
            if actions is None:
                actions = random_patch_actions((b, tf), generator, model.device)
            note("glance")
            patches = extract_for_frames(frames, actions, cfg.image_size, cfg.patch_size)
            note("extract")
            feats = model.focus(patches, True)
            note("focus")
            local = model.classify_frame_logits(feats.reshape(b, tf, -1), True, keep, generator)
            total = sum_consensus(global_logits, local, cfg.with_glancer)
            loss = _ce(total, labels)
            note("classify")
        loss.backward()
        note("backward")
        _sgd_step(optimizer, scheduler, replicas)
        average_bn_stats_(model, replicas)
        note("optimizer")
        top1, top5 = topk_accuracy(total.detach().float(), labels)
        return average_metrics({"loss": loss.detach(), "top1": top1, "top5": top5}, replicas)

    return step


def sthsth_stage2_episode(model: GFV, batch: Dict[str, torch.Tensor],
                          generator: Optional[torch.Generator], cfg: PPOConfig,
                          behavior: Optional[torch.Tensor] = None,
                          baseline_actions: Optional[torch.Tensor] = None,
                          note: Callable[[str], None] = lambda phase: None,
                          replicas: Optional[Replicas] = None) -> Dict[str, torch.Tensor]:
    """The sth-sth stage-2 episode, every phase frozen and under
    ``no_grad``: the TSM glance (maps and logits); the behavior rollout over
    the D divisions' stacked maps; one extraction of all B*Tf patches at the
    divisions' actions, the focuser and the head; for reward 'random' the
    same at uniform random division actions; the per-division rewards
    (``divisional_confidences``) and their normalised discounted returns.
    Draws, in this order, the behavior sample and the baseline actions
    (B, D, 2) from ``generator``; ``behavior`` (the grid indices (D, B), or
    a continuous policy's standard normal noise (D, B, 2)) and
    ``baseline_actions`` replace them. Returns PPO's memory (fmaps,
    actions, old_logprob, returns; time-major over divisions) and the
    rewards and confidences (B, D)."""
    mc = model.cfg
    frames, small, labels = batch["frames"], batch["frames_small"], batch["labels"]
    b, tf = frames.shape[:2]
    d = mc.video_div
    with torch.no_grad(), model.autocast():
        fmap, global_logits = glance_logits(model, small)
        fmaps_tb = model.division_maps(fmap).transpose(0, 1).contiguous()
        del fmap
        note("glance")
        roll = _rollout_time_major(model.policy, fmaps_tb, generator, mc.action_dim, behavior)
        note("rollout")
        patches = extract_for_frames(frames, actions_per_frame(roll["coords"].transpose(0, 1), tf),
                                     mc.image_size, mc.patch_size)
        note("extract")
        feats = model.focus(patches, False)
        del patches
        note("focus")
        local = model.classify_frame_logits(feats.reshape(b, tf, -1))
        note("classify")
        random_logits = local
        if cfg.reward_mode == "random":
            if baseline_actions is None:
                baseline_actions = random_patch_actions((b, d), generator, model.device)
            patches = extract_for_frames(frames, actions_per_frame(baseline_actions, tf),
                                         mc.image_size, mc.patch_size)
            random_logits = local_frame_logits(model, patches, b)
            del patches
            note("baseline")
        conf, base_conf = divisional_confidences(local, random_logits, global_logits, labels,
                                                 d, mc.with_glancer)
        if cfg.reward_mode == "random":
            rewards = conf - base_conf
        else:
            rewards = compute_rewards(conf, None, cfg.reward_mode)
        returns = discounted_returns(rewards.transpose(0, 1), cfg.gamma, replicas)
        note("returns")
    return {"fmaps": fmaps_tb, "actions": roll["store"], "old_logprob": roll["logprob"],
            "returns": returns, "rewards": rewards, "confidence": conf}


def make_sthsth_stage2_step(model: GFV, ppo: PPOState, replicas: Optional[Replicas] = None
                            ) -> Callable:
    """Stage 2, per-division PPO on the policy (discrete or continuous, with
    or without the BatchNorm encoder). Returns ``step(batch, generator,
    behavior=None, baseline_actions=None, mark=None) -> metrics``: the
    episode (``sthsth_stage2_episode``), then ``ppo_update`` trains
    ``model.policy`` in place and advances its encoder's running statistics
    once an epoch. ``mark(phase)``: 'glance', 'rollout', 'extract', 'focus',
    'classify', 'baseline' (reward 'random'), 'returns', 'update'. The
    metrics are 0-d tensors on the device: the PPO loss terms and mean
    ratio of the last epoch, and the mean reward and confidence. With
    ``replicas`` each replica carries its encoder's statistics through the
    epochs and they are averaged once, after the update."""
    _check_trainable(model, sthsth=True)
    _check_learner(model, ppo)

    def step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
             behavior: Optional[torch.Tensor] = None,
             baseline_actions: Optional[torch.Tensor] = None,
             mark: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        note = mark or (lambda phase: None)
        episode = sthsth_stage2_episode(model, batch, generator, ppo.cfg, behavior,
                                        baseline_actions, note, replicas)
        metrics = ppo_update(ppo, episode, model.autocast, replicas=replicas)
        average_bn_stats_(model.policy, replicas)
        note("update")
        metrics["reward_mean"] = episode["rewards"].mean()
        metrics["confidence"] = episode["confidence"].mean()
        return average_metrics(metrics, replicas)

    return step


def make_sthsth_eval_step(model: GFV) -> Callable:
    """The deployment eval: ``step(batch) -> (logits (B, classes), {"top1",
    "top5"})``, ``inference_sthsth`` (greedy policy, one batched focus, sum
    consensus)."""

    def step(batch: Dict[str, torch.Tensor]):
        total = inference_sthsth(model, batch["frames"], batch["frames_small"],
                                 device=model.device)
        top1, top5 = topk_accuracy(total.float(), batch["labels"])
        return total, {"top1": top1, "top5": top5}

    return step
