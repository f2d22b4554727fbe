"""Supervised train steps and the eval step (counterpart of
adafocus_tpu/train/stages.py).

  stage 0  backbone pretraining: the GRU head's loss plus the glancer's CE
           on the downsampled frames and the focuser's CE on random patches;
  stage 1  random patches: glancer frozen, focuser and classifier train;
  stage 2  PPO: everything frozen but the policy; the reward is the
           classifier's confidence in the label at the sampled patches
           against a one-step lookahead on random patches
           (``make_stage2_step``);
  stage 3  the frozen greedy policy's patches: only the classifier trains.

The sth-sth family (``classifier="consensus"``) has its own steps in
train/stages_sthsth.py, AdaFocus+ (``frame_budget > 0``) its stages 1, 3,
joint stage 2 and eval in train/stages_plus.py; the pieces both share live here
(``create_train_state``, ``_rollout_time_major``).

A frozen phase runs under ``torch.no_grad()`` with its backbone in eval
mode, so its running statistics stay as they are; its parameters are out of
the optimizer (train/optim.py). Where the JAX step returns a new state, a
step here updates the model and the optimizer in place, PyTorch's idiom.

Each step factory takes ``replicas`` (``parallel/mesh.py``) where the JAX
steps take ``axis_name``: the rank trains on its shard of the batch, and
the gradients, the running statistics (once, after the step), the returns'
moments and the metrics are averaged over the replicas.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from adafocus_torch.models.gfv import (
    GFV, GFVConfig, Device, extract_for_frames, fuse_and_classify, inference,
)
from adafocus_torch.models.layers import stats_frozen, training
from adafocus_torch.models.policy import discrete_logprobs, discrete_to_coords, sample_rollout
from adafocus_torch.ops.metrics import topk_accuracy
from adafocus_torch.ops.patch import random_patch_actions
from adafocus_torch.parallel.mesh import (
    Replicas, average_bn_stats_, average_grads_, average_metrics,
)
from adafocus_torch.ppo.core import (
    PPOConfig, PPOState, compute_rewards, discounted_returns, ppo_init, ppo_update,
)
from adafocus_torch.train.optim import OptimConfig, freeze_for_stage, make_stage_optimizer
from adafocus_torch.utils.profiling import span


@dataclasses.dataclass
class TrainState:
    """A supervised stage's model, SGD and schedule; stage 2's model and
    PPO learner (``optimizer`` and ``scheduler`` None)."""

    model: GFV
    optimizer: Optional[torch.optim.SGD]
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR]
    ppo: Optional[PPOState] = None


def create_train_state(cfg: GFVConfig, stage: int, optim: OptimConfig = OptimConfig(),
                       device: Device = None,
                       generator: Optional[torch.Generator] = None,
                       ppo: PPOConfig = PPOConfig()) -> TrainState:
    """A training GFV (float32 parameters, compute in ``cfg.dtype``; weights
    from ``generator``) on ``device`` (the GPU unless ``device="cpu"``), and
    the optimizer and schedule of ``stage``; for stage 2, the PPO learner
    of ``ppo`` over the policy (AdaFocus+ with ``plus_rl``: one Adam over the
    policy and the selector actor-critic, ``joint_learner``), every other
    component frozen. The sth-sth
    family's stage 3 finetunes the focuser and the classifier, so its
    optimizer takes stage 1's freeze matrix, as the JAX package's CLI
    labels it (``cli/train.py make_tx``); ``cfg.partial_bn`` freezes the
    focuser's block BatchNorms' affine parameters."""
    model = GFV(cfg, device=device, generator=generator, param_dtype=torch.float32)
    if stage == 2:
        freeze_for_stage(model, 2)
        learner = joint_learner(model) if cfg.frame_budget > 0 and cfg.plus_rl \
            else model.policy
        return TrainState(model, None, None, ppo_init(learner, ppo))
    return TrainState(model, *make_stage_optimizer(model, optimizer_stage(cfg, stage), optim,
                                                   partial_bn=cfg.partial_bn))


def joint_learner(model: GFV) -> nn.ModuleDict:
    """AdaFocus+'s joint stage-2 learner: the patch policy and the selector
    actor-critic, the JAX package's ``{"policy", "selector_ac"}`` tree."""
    return nn.ModuleDict({"policy": model.policy, "selector_ac": model.selector_ac})


def optimizer_stage(cfg: GFVConfig, stage: int) -> int:
    """The freeze-matrix row that ``stage``'s optimizer takes: stage 1's for
    the sth-sth family's stage 3, else the stage's own."""
    return 1 if cfg.sthsth and stage == 3 else stage


def _check_trainable(model: GFV, sthsth: bool = False) -> None:
    """Raises unless ``model`` trains in float32 or float64 parameters, on
    the steps of its family (``sthsth``: train/stages_sthsth.py)."""
    if model.cfg.sthsth != sthsth:
        raise ValueError(
            "a consensus-head (sth-sth) model trains through train.stages_sthsth"
            if model.cfg.sthsth else
            "the sth-sth steps train a consensus-head model (classifier='consensus')")
    if model.param_dtype not in (torch.float32, torch.float64):
        raise ValueError("a train step needs float32 parameters (create_train_state); "
                         f"this model's are {model.param_dtype}")


def _ce_per_step(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over B*T of per-step logits (B, T, C), the label
    broadcast over time; log-softmax in float32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    b, t = logp.shape[:2]
    return -logp.gather(-1, labels.long().reshape(b, 1, 1).expand(b, t, 1)).mean()


def make_stage_train_step(model: GFV, stage: int, optimizer: torch.optim.Optimizer,
                          scheduler: torch.optim.lr_scheduler.LRScheduler,
                          replicas: Optional[Replicas] = None) -> Callable:
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
    logits. With ``replicas`` the batch is this rank's shard; the
    gradients, the running statistics and the metrics are averaged. A step
    is the span ``train_step``, its update (the optimizer, the schedule and
    the running statistics' average) the span ``optimizer``
    (``utils/profiling.py span``).
    """
    if stage not in (0, 1, 3):
        raise ValueError(f"stage {stage}: stages 0, 1 and 3 only "
                         "(stage 2 is PPO: make_stage2_step)")
    _check_trainable(model)
    cfg = model.cfg
    train_glancer = stage == 0
    train_focuser = stage in (0, 1)

    def step(batch: Dict[str, torch.Tensor], generator: torch.Generator,
             actions: Optional[torch.Tensor] = None, keep: Optional[torch.Tensor] = None,
             mark: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        with span("train_step"):
            return _step(batch, generator, actions, keep, mark or (lambda phase: None))

    def _step(batch, generator, actions, keep, note):
        frames, small, labels = batch["frames"], batch["frames_small"], batch["labels"]
        b, t = small.shape[:2]
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
            if cfg.classifier == "linear":   # consensus log-probabilities (B, classes)
                logp = logits.to(torch.promote_types(logits.dtype, torch.float32))
                loss = -logp.gather(-1, labels.long()[:, None]).mean()
            else:
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
        with span("optimizer"):
            _sgd_step(optimizer, scheduler, replicas)
            average_bn_stats_(model, replicas)
        note("optimizer")
        top1, top5 = topk_accuracy(_final(logits).detach(), labels)
        return average_metrics({"loss": loss.detach(), "top1": top1, "top5": top5}, replicas)

    return step


def _final(logits: torch.Tensor) -> torch.Tensor:
    """The prediction: the last step of per-step logits (B, T, classes), or
    the linear head's log-probabilities (B, classes) as they are."""
    return logits[:, -1] if logits.dim() == 3 else logits


def _sgd_step(optimizer: torch.optim.Optimizer,
              scheduler: torch.optim.lr_scheduler.LRScheduler,
              replicas: Optional[Replicas] = None) -> None:
    """One optimizer and schedule step after the backward. optax updates
    every trainable leaf, one the loss does not reach too (zero gradient:
    weight decay and momentum still move it), so such a leaf gets a zero
    gradient first; then the gradients are averaged over ``replicas``."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    average_grads_(optimizer, replicas)
    optimizer.step()
    scheduler.step()


def _target_confidence(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, T, C) logits -> (B, T) softmax probability of the label, float32
    (the reward signal)."""
    probs = F.softmax(logits.float(), dim=-1)
    b, t = probs.shape[:2]
    return probs.gather(-1, labels.long().reshape(b, 1, 1).expand(b, t, 1))[..., 0]


def _rollout_time_major(policy: torch.nn.Module, fmaps_tb: torch.Tensor,
                        generator: Optional[torch.Generator], action_dim: int,
                        behavior: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The behavior rollout over time-major glance maps (T, B, gh, gw, C):
    actions sampled from ``generator``; ``behavior`` replaces the draw: the
    grid indices (T, B) of a discrete policy, the standard normal noise
    (T, B, 2) of a continuous one. Returns coords (T, B, 2) float32, store
    (what PPO scores again: the indices, or the clamped continuous actions),
    logprob and value (T, B) float32. A policy with a BatchNorm encoder runs
    in train mode with its running statistics left as they are, as the JAX
    package runs it (its update discarded): the same batch statistics as
    the evaluate pass, so that the ratios start at 1. The caller holds
    ``no_grad``."""
    with training(policy), stats_frozen(policy):
        _, actor_out, value = policy.rollout_states(fmaps_tb)
    if policy.continuous:
        coords, _, logprob = sample_rollout(actor_out, "sample", action_dim, generator, True,
                                            policy.action_std, behavior)
        coords, store = coords.float(), coords
    elif behavior is None:
        coords, store, logprob = sample_rollout(actor_out, "sample", action_dim, generator)
    else:
        store = behavior.to(actor_out.device)
        coords = discrete_to_coords(store, action_dim)
        logprob = discrete_logprobs(actor_out).gather(-1, store[..., None])[..., 0]
    return {"coords": coords, "store": store, "logprob": logprob.float(),
            "value": value.float()}


def stage2_episode(model: GFV, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator], cfg: PPOConfig,
                   behavior_idx: Optional[torch.Tensor] = None,
                   baseline_actions: Optional[torch.Tensor] = None,
                   note: Callable[[str], None] = lambda phase: None,
                   replicas: Optional[Replicas] = None) -> Dict[str, torch.Tensor]:
    """The stage-2 episode, every phase frozen and under ``no_grad``: the
    glance; the behavior policy's sampled rollout; extraction and focus at
    its actions; the GRU classifier with its hiddens; the rewards
    (``cfg.reward_mode``; for 'random' the baseline: extraction and focus at
    uniform random actions, then one ``classifier_lookahead`` from each
    step's previous hidden h_{t-1}); the normalised discounted returns
    (over ``replicas``, with the global batch's moments).
    Draws, in this order, the behavior sample and the baseline actions from
    ``generator``; ``behavior_idx`` (T, B) and ``baseline_actions`` (B, T, 2)
    replace them. Returns PPO's memory (fmaps, actions, old_logprob,
    returns; time-major) and the rewards and confidences (B, T)."""
    mc = model.cfg
    frames, small, labels = batch["frames"], batch["frames_small"], batch["labels"]
    b, t = small.shape[:2]
    with torch.no_grad(), model.autocast():
        fmap, pooled = model.glance(small, False)
        fmaps_tb = fmap.transpose(0, 1).contiguous()
        del fmap
        note("glance")
        roll = _rollout_time_major(model.policy, fmaps_tb, generator, mc.action_dim,
                                   behavior_idx)
        note("rollout")
        patches = extract_for_frames(frames, roll["coords"].transpose(0, 1),
                                     mc.image_size, mc.patch_size)
        note("extract")
        local = model.focus(patches, False).reshape(b, t, -1)
        del patches
        note("focus")
        logits, hiddens = model.classify_seq_with_hiddens(
            torch.cat([pooled, local], dim=-1).to(mc.dtype))
        confidence = _target_confidence(logits, labels)
        note("classify")
        baseline = None
        if cfg.reward_mode == "random":
            if baseline_actions is None:
                baseline_actions = random_patch_actions((b, t), generator, model.device)
            patches = extract_for_frames(frames, baseline_actions, mc.image_size, mc.patch_size)
            local = model.focus(patches, False).reshape(b, t, -1)
            del patches
            fused = torch.cat([pooled, local], dim=-1).to(mc.dtype)
            h_prev = torch.cat([torch.zeros_like(hiddens[:, :1]), hiddens[:, :-1]], dim=1)
            base_logits = model.classifier_lookahead(h_prev.reshape(b * t, -1),
                                                     fused.reshape(b * t, -1))
            baseline = _target_confidence(base_logits.reshape(b, t, -1), labels)
            note("baseline")
        rewards = compute_rewards(confidence, baseline, cfg.reward_mode)
        returns = discounted_returns(rewards.transpose(0, 1), cfg.gamma, replicas)
        note("returns")
    return {"fmaps": fmaps_tb, "actions": roll["store"], "old_logprob": roll["logprob"],
            "returns": returns, "rewards": rewards, "confidence": confidence}


def make_stage2_step(model: GFV, ppo: PPOState, replicas: Optional[Replicas] = None
                     ) -> Callable:
    """Stage 2, PPO on the patch policy. Returns ``step(batch, generator,
    behavior_idx=None, baseline_actions=None, mark=None) -> metrics``.

    batch: ``frames`` (B, T, S, S, 3), ``frames_small`` (B, T, g, g, 3) and
    ``labels`` (B,), on the model's device; ``generator`` (on the model's
    device) draws the behavior sample and the baseline actions, which
    ``behavior_idx`` (T, B) and ``baseline_actions`` (B, T, 2) replace
    (``stage2_episode``). Then ``ppo_update`` trains ``model.policy`` in
    place (``ppo`` from ``create_train_state(cfg, 2)`` or ``ppo_init``).
    ``mark(phase)``, when given, is called as each phase has been enqueued:
    'glance', 'rollout', 'extract', 'focus', 'classify', 'baseline' (reward
    'random'), 'returns', 'update'. The metrics are 0-d tensors on the
    device: the PPO loss terms and mean ratio of the last epoch, and the
    mean reward and confidence. With ``replicas`` the batch is this rank's
    shard: the returns take the global batch's moments, every epoch's
    gradients are averaged, then the policy's running statistics (a
    BatchNorm encoder's, which each replica carries through the epochs) and
    the metrics.
    """
    _check_trainable(model)
    _check_learner(model, ppo)

    def step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
             behavior_idx: Optional[torch.Tensor] = None,
             baseline_actions: Optional[torch.Tensor] = None,
             mark: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        note = mark or (lambda phase: None)
        episode = stage2_episode(model, batch, generator, ppo.cfg, behavior_idx,
                                 baseline_actions, note, replicas)
        metrics = ppo_update(ppo, episode, model.autocast, replicas=replicas)
        average_bn_stats_(model.policy, replicas)
        note("update")
        metrics["reward_mean"] = episode["rewards"].mean()
        metrics["confidence"] = episode["confidence"].mean()
        return average_metrics(metrics, replicas)

    return step


def _check_learner(model: GFV, ppo: PPOState, joint: bool = False) -> None:
    """Raises unless ``ppo`` trains this model's policy or, when ``joint``,
    its policy and selector actor-critic (``joint_learner``)."""
    if joint:
        modules = dict(ppo.policy.named_children()) if isinstance(ppo.policy, nn.ModuleDict) \
            else {}
        if modules.keys() != {"policy", "selector_ac"} or modules["policy"] is not model.policy \
                or modules["selector_ac"] is not getattr(model, "selector_ac", None):
            raise ValueError("the joint PPO learner must train this model's policy and "
                             "selector actor-critic (ppo_init(joint_learner(model)))")
    elif ppo.policy is not model.policy:
        raise ValueError("the PPO learner must train this model's policy (ppo_init(model.policy))")


def make_eval_step(model: GFV) -> Callable:
    """The deployment eval: ``step(batch) -> (logits (B, T, classes),
    {"top1", "top5"})``, ``inference`` (greedy policy) and the top-k
    accuracy of the last step's logits; the host aggregates mAP over an
    epoch (ops/metrics.py)."""

    def step(batch: Dict[str, torch.Tensor]):
        logits = inference(model, batch["frames"], batch["frames_small"],
                           device=model.device)
        top1, top5 = topk_accuracy(_final(logits).float(), batch["labels"])
        return logits, {"top1": top1, "top5": top5}

    return step
