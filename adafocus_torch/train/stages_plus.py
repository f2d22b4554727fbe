"""AdaFocus+ train and eval steps (counterpart of
adafocus_tpu/train/stages_plus.py).

  stage 1  ``make_plus_train_step``: glancer frozen, random patches on the
           selected frames; focuser, classifier and the ST selector train
           (with ``plus_rl`` the frames are uniform and the selector actor-
           critic waits for stage 2);
  stage 2  with ``plus_rl``, ``make_plus_stage2_joint_step``: one PPO over
           the factored action (which frame, where to look) of the selector
           actor-critic and the patch policy; without it, the base stage-2
           step over all T frames (train/stages.py ``make_stage2_step``);
  stage 3  ``make_plus_train_step`` under the frozen greedy spatial policy:
           classifier and ST selector train;
  eval     ``make_plus_eval_step``: top-K frames and the greedy policy.

As in the JAX package, stages 1 and 3 run the focuser in train mode, so its
BatchNorm normalises with batch statistics and advances its running ones in
stage 3 as well, where its parameters are frozen.

With ``replicas`` (``parallel/mesh.py``), as in train/stages.py, the batch
is the rank's shard and the gradients, running statistics, returns' moments
and metrics are averaged over the replicas; the joint stage 2 averages no
statistics, since it leaves them as they are.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from adafocus_torch.models.gfv import GFV, extract_for_frames
from adafocus_torch.models.gfv_plus import forward_plus, gather_frames, inference_plus
from adafocus_torch.models.layers import stats_frozen
from adafocus_torch.ops.metrics import topk_accuracy
from adafocus_torch.ops.patch import random_patch_actions
from adafocus_torch.parallel.mesh import Replicas, average_bn_stats_, average_metrics
from adafocus_torch.ppo.core import (
    PPOConfig, PPOState, clipped_objective, compute_rewards, discounted_returns,
    evaluate_episode, ppo_update,
)
from adafocus_torch.train.stages import (
    _ce_per_step, _check_learner, _check_trainable, _final, _rollout_time_major, _sgd_step,
    _target_confidence,
)


def _check_plus(model: GFV) -> None:
    _check_trainable(model)
    if model.cfg.frame_budget <= 0:
        raise ValueError("the AdaFocus+ steps need a frame-budget model (frame_budget > 0)")


def make_plus_train_step(model: GFV, stage: int, optimizer: torch.optim.Optimizer,
                         scheduler: torch.optim.lr_scheduler.LRScheduler,
                         replicas: Optional[Replicas] = None) -> Callable:
    """Supervised AdaFocus+ stages 1 and 3. Returns ``step(batch, generator,
    uniforms=None, frame_idx=None, actions=None, mark=None) -> {"loss",
    "top1", "top5"}``: ``forward_plus`` in train mode with the glancer
    frozen (random patches in stage 1, the greedy spatial policy in stage
    3), the per-step cross-entropy, one SGD step. ``generator`` draws the
    frames and the patch actions; ``uniforms``, ``frame_idx`` and ``actions``
    replace the draws (``forward_plus``); ``mark`` as ``forward_plus``'s,
    then 'backward' and 'optimizer'."""
    if stage not in (1, 3):
        raise ValueError("AdaFocus+ supervised stages are 1 and 3")
    _check_plus(model)
    patch_mode = "random" if stage == 1 else "policy"

    def step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
             uniforms: Optional[torch.Tensor] = None,
             frame_idx: Optional[torch.Tensor] = None,
             actions: Optional[torch.Tensor] = None,
             mark: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        note = mark or (lambda phase: None)
        optimizer.zero_grad(set_to_none=True)
        logits, _ = forward_plus(model, batch["frames"], batch["frames_small"], generator,
                                 train=True, patch_mode=patch_mode, freeze_glance=True,
                                 uniforms=uniforms, frame_idx=frame_idx, actions=actions,
                                 mark=note)
        loss = _ce_per_step(logits, batch["labels"])
        loss.backward()
        note("backward")
        _sgd_step(optimizer, scheduler, replicas)
        average_bn_stats_(model, replicas)
        note("optimizer")
        top1, top5 = topk_accuracy(_final(logits).detach().float(), batch["labels"])
        return average_metrics({"loss": loss.detach(), "top1": top1, "top5": top5}, replicas)

    return step


def slot_confidences(model: GFV, pooled: torch.Tensor, local_sel: torch.Tensor,
                     idx: torch.Tensor, labels: torch.Tensor,
                     rand_idx: Optional[torch.Tensor] = None,
                     rand_local: Optional[torch.Tensor] = None):
    """The classifier's final confidence in the label after each of the K
    slots, and the one-step lookahead baseline's, in one classifier call.

    Slot j's sequence carries the local features of slots 0..j at their
    frames (a later slot's write wins, as ``carry.at[...].set`` does) and
    zeros elsewhere; its baseline sequence is slot j-1's with the random
    frame ``rand_idx[:, j]`` set to ``rand_local[:, j]``. These are the
    sequences of the JAX package's K-step scan, which runs the classifier
    twice a slot; here all K (2K with the baseline) go through it as one
    batch (S*K*B sequences of T steps). pooled (B, T, 1280), local_sel and
    rand_local (B, K, 2048), idx and rand_idx (B, K). Returns (conf (B, K),
    baseline (B, K) or None), float32."""
    b, t = pooled.shape[:2]
    k = idx.shape[1]
    dev = pooled.device
    steps = torch.arange(t, device=dev)
    slot = torch.where(idx[:, :, None] == steps, torch.arange(k, device=dev)[:, None], -1)
    last = slot.cummax(dim=1).values                         # (B, K, T): last slot <= j
    rows = torch.arange(b, device=dev)[:, None, None]
    prefix = torch.where((last >= 0)[..., None], local_sel[rows, last.clamp_min(0)],
                         torch.zeros((), dtype=local_sel.dtype, device=dev))
    seqs = [prefix]
    if rand_idx is not None:
        prev = torch.cat([torch.zeros_like(prefix[:, :1]), prefix[:, :-1]], dim=1)
        at = (rand_idx[:, :, None] == steps)[..., None]
        seqs.append(torch.where(at, rand_local[:, :, None, :].to(prev.dtype), prev))
    local = torch.stack(seqs)                                 # (S, B, K, T, D)
    n = local.shape[0]
    glance = pooled[None, :, None].expand((n, b, k) + pooled.shape[1:])
    fused = torch.cat([glance, local], dim=-1).to(model.cfg.dtype)
    logits = model.classify_seq(fused.reshape((n * b * k, t, -1)))
    conf = _target_confidence(logits[:, -1:], labels[None, :, None].expand(n, b, k).reshape(-1))
    conf = conf.reshape(n, b, k)
    return conf[0], (conf[1] if rand_idx is not None else None)


def joint_loss(learner: nn.ModuleDict, memory: Dict[str, torch.Tensor], cfg: PPOConfig):
    """The joint clipped-PPO loss of a stored episode: the selector actor-
    critic replays its K picks, the patch policy its K actions; the
    factored action's logprob is the sum of the two, its value the sum of
    the two critics, its entropy the sum of the two. A BatchNorm encoder
    normalises with batch statistics and its running statistics are left
    as they are: the JAX package discards their update in this step
    (a known divergence from the base stage 2, which keeps it)."""
    k = memory["idx"].shape[1]
    sel = learner["selector_ac"].rollout(memory["pooled"], k, actions=memory["idx"])
    with stats_frozen(learner["policy"]):
        sp_logp, sp_value, sp_ent = evaluate_episode(learner["policy"], memory["fmaps"],
                                                     memory["actions"])
    return clipped_objective(sel["logprob"].T + sp_logp, sel["value"].T + sp_value,
                             sel["entropy"].T + sp_ent, memory["old_logprob"],
                             memory["returns"], cfg)


def plus_stage2_episode(model: GFV, batch: Dict[str, torch.Tensor],
                        generator: Optional[torch.Generator], cfg: PPOConfig,
                        draws: Optional[Dict[str, torch.Tensor]] = None,
                        note: Callable[[str], None] = lambda phase: None,
                        replicas: Optional[Replicas] = None) -> Dict[str, torch.Tensor]:
    """The joint stage-2 episode, every phase frozen and under ``no_grad``:
    the glance; the selector's sampled K-slot rollout; the patch policy's
    sampled rollout over the K picked frames; extraction and focus at its
    actions; for reward 'random' the baseline's random frames (with
    replacement) and random patches, extracted and focused; the per-slot
    confidences (``slot_confidences``); rewards and normalised returns.
    Draws from ``generator`` in this order: the selector's picks, the
    policy's actions, the baseline's frames and patch actions; ``draws``
    replaces any of them: 'select' (B, K), 'spatial' (K, B) grid indices,
    'base_idx' (B, K), 'base_actions' (B, K, 2). Returns PPO's memory
    (pooled, idx, fmaps (K, B, ...), actions, old_logprob, returns) and the
    rewards and confidences (B, K)."""
    mc = model.cfg
    draws = draws or {}
    frames, small, labels = batch["frames"], batch["frames_small"], batch["labels"]
    b, t = small.shape[:2]
    k = mc.frame_budget
    with torch.no_grad(), model.autocast():
        fmap, pooled = model.glance(small, False)
        note("glance")
        sel = model.select_rollout(pooled, "sample", generator, draws.get("select"))
        idx = sel["idx"]
        note("select")
        fmaps_tb = gather_frames(fmap, idx).transpose(0, 1).contiguous()
        frames_sel = gather_frames(frames, idx)
        del fmap
        note("gather")
        roll = _rollout_time_major(model.policy, fmaps_tb, generator, mc.action_dim,
                                   draws.get("spatial"))
        note("rollout")
        patches = extract_for_frames(frames_sel, roll["coords"].transpose(0, 1),
                                     mc.image_size, mc.patch_size)
        del frames_sel
        note("extract")
        local_sel = model.focus(patches, False).reshape(b, k, -1)
        del patches
        note("focus")
        rand_idx = rand_local = None
        if cfg.reward_mode == "random":
            rand_idx = draws.get("base_idx")
            if rand_idx is None:
                rand_idx = torch.randint(0, t, (b, k), generator=generator, device=model.device)
            rand_actions = draws.get("base_actions")
            if rand_actions is None:
                rand_actions = random_patch_actions((b, k), generator, model.device)
            rand_idx = rand_idx.to(model.device, torch.long)
            patches = extract_for_frames(gather_frames(frames, rand_idx), rand_actions,
                                         mc.image_size, mc.patch_size)
            rand_local = model.focus(patches, False).reshape(b, k, -1)
            del patches
            note("baseline")
        conf, baseline = slot_confidences(model, pooled, local_sel, idx, labels, rand_idx,
                                          rand_local)
        note("classify")
        rewards = compute_rewards(conf, baseline, cfg.reward_mode)
        returns = discounted_returns(rewards.transpose(0, 1), cfg.gamma, replicas)
        note("returns")
    return {"pooled": pooled, "idx": idx, "fmaps": fmaps_tb, "actions": roll["store"],
            "old_logprob": sel["logprob"].transpose(0, 1) + roll["logprob"],
            "returns": returns, "rewards": rewards, "confidence": conf}


def make_plus_stage2_joint_step(model: GFV, ppo: PPOState,
                                replicas: Optional[Replicas] = None) -> Callable:
    """Joint temporal + spatial PPO (``plus_rl``). Returns ``step(batch,
    generator, draws=None, mark=None) -> metrics``: ``plus_stage2_episode``,
    then ``ppo_update`` with ``joint_loss`` trains the selector actor-critic
    and the policy in place (``ppo`` from ``create_train_state(cfg, 2)``).
    The behavior policies are the current ones, as in the base stage 2.
    ``mark(phase)`` is called as each phase has been enqueued: 'glance',
    'select', 'gather', 'rollout', 'extract', 'focus', 'baseline' (reward
    'random'), 'classify', 'returns', 'update'. The metrics are 0-d tensors
    on the device: the PPO loss terms and mean ratio of the last epoch, the
    mean reward and confidence."""
    _check_plus(model)
    if not model.cfg.plus_rl:
        raise ValueError("the joint stage 2 needs plus_rl (without it, stage 2 is "
                         "train.stages.make_stage2_step over all T frames)")
    _check_learner(model, ppo, joint=True)

    def step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
             draws: Optional[Dict[str, torch.Tensor]] = None,
             mark: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        note = mark or (lambda phase: None)
        episode = plus_stage2_episode(model, batch, generator, ppo.cfg, draws, note, replicas)
        metrics = ppo_update(ppo, episode, model.autocast, joint_loss, replicas)
        note("update")
        metrics["reward_mean"] = episode["rewards"].mean()
        metrics["confidence"] = episode["confidence"].mean()
        return average_metrics(metrics, replicas)

    return step


def make_plus_eval_step(model: GFV) -> Callable:
    """The AdaFocus+ deployment eval: ``step(batch) -> (logits (B, T,
    classes), {"top1", "top5"})``, ``inference_plus`` and the top-k accuracy
    of the last step's logits."""

    def step(batch: Dict[str, torch.Tensor]):
        logits = inference_plus(model, batch["frames"], batch["frames_small"],
                                device=model.device)
        top1, top5 = topk_accuracy(_final(logits).float(), batch["labels"])
        return logits, {"top1": top1, "top5": top5}

    return step
