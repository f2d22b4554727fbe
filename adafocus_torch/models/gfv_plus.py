"""AdaFocus+, budgeted frame selection (counterpart of
adafocus_tpu/models/gfv_plus.py).

A GFV with ``frame_budget = K > 0`` glances at all T frames, then selects K
of them and runs the policy, extraction and focus on those K only:

  1. glance:   MobileNetV2 over all T downsampled frames;
  2. select:   ``FrameSelector`` scores each frame from the pooled glance
               features (a GRU over time and a 1-unit head) and a top-K
               picks K frames, Gumbel-perturbed in training (``select_topk``);
               or, with ``plus_rl``, ``SelectorActorCritic`` picks them one
               slot at a time (a PPO agent, trained jointly with the patch
               policy in stage 2);
  3. gather:   the K frames' glance maps and full-resolution frames
               (``gather_frames``, advanced indexing: one copy);
  4. policy, extraction, focus on the B*K gathered frames (one kernel launch);
  5. scatter:  the K local features back to T steps (``scatter_frames``, a
               one-hot product), times the straight-through mask, so the
               selector's scores train from the classification loss;
  6. classify: concat [pooled | local] over all T steps -> GRU head.

Top-K follows ``jax.lax.top_k``: among equal values the lower index comes
first. ``torch.topk`` promises no order among ties, so the top-K here is a
stable descending sort (``_top_k``); in bf16 the selector's scores tie often.

Every random draw comes from an explicit ``torch.Generator`` and may be
given instead (``uniforms``, ``noise``, ``actions``, ``frame_idx``), so that
a test can pass the JAX package's draws.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from adafocus_torch.models.gru import GRUCell
from adafocus_torch.ops.patch import random_patch_actions

# the selector actor-critic's additive-attention width (the JAX package's
# SelectorActorCritic.attn_dim, which GFV leaves at its default)
ATTN_DIM = 128


class FrameSelector(nn.Module):
    """Pooled glance features -> per-frame relevance scores: a GRU over time
    (the input projection hoisted over all T, ``GRUCell.scan_time``) and a
    1-unit head."""

    def __init__(self, in_dim: int = 1280, hidden_dim: int = 256):
        super().__init__()
        self.gru = GRUCell(in_dim, hidden_dim)
        self.score = nn.Linear(hidden_dim, 1)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> scores (B, T) float32, computed in the inputs' dtype."""
        h0 = self.gru.initial_state(pooled.shape[0], pooled.dtype)
        _, hs = self.gru.scan_time(h0, pooled.transpose(0, 1))      # (T, B, H)
        return self.score(hs)[..., 0].transpose(0, 1).float()


class SelectorActorCritic(nn.Module):
    """The joint-RL temporal policy (``plus_rl``): an actor-critic over K
    frame-selection slots. Each slot scores the frames not yet taken by
    additive attention between their glance features and the GRU carry,
    picks one, and feeds its features back into the GRU."""

    def __init__(self, in_dim: int = 1280, hidden_dim: int = 256, attn_dim: int = ATTN_DIM):
        super().__init__()
        self.gru = GRUCell(in_dim, hidden_dim)
        self.key_proj = nn.Linear(in_dim, attn_dim)
        self.query_proj = nn.Linear(hidden_dim, attn_dim)
        self.score = nn.Linear(attn_dim, 1)
        self.critic = nn.Linear(hidden_dim, 1)

    def rollout(self, pooled: torch.Tensor, k: int, mode: str = "sample",
                generator: Optional[torch.Generator] = None,
                actions: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The K-slot rollout over pooled features (B, T, D): mode 'sample'
        draws each slot's frame from its masked categorical by Gumbel-max
        (uniforms from ``generator``, on the features' device), 'top' takes
        the argmax (the first maximum); ``actions`` (B, K) replays a stored
        trajectory instead (the PPO evaluate pass). The logits, masked to
        -1e9 on taken frames, their ``log_softmax`` and the values are
        float32 whatever the compute dtype, as in the JAX package. Returns
        idx (B, K) long in pick order, and logprob, value and entropy (B, K)
        float32."""
        if mode not in ("sample", "top"):
            raise ValueError(f"unknown mode {mode!r}: 'sample' or 'top'")
        if actions is None and mode == "sample" and generator is None:
            raise ValueError("mode='sample' needs a generator or the actions")
        b, t, _ = pooled.shape
        keys = self.key_proj(pooled)                                 # (B, T, A)
        h = self.gru.initial_state(b, pooled.dtype)
        taken = torch.zeros((b, t), dtype=torch.bool, device=pooled.device)
        rows = torch.arange(b, device=pooled.device)
        outs = []
        for j in range(k):
            e = torch.tanh(keys + self.query_proj(h)[:, None, :])
            logits = self.score(e)[..., 0].float().masked_fill(taken, -1e9)
            if actions is not None:
                idx = actions[:, j].to(pooled.device, torch.long)
            elif mode == "sample":
                u = torch.rand(logits.shape, generator=generator, device=logits.device,
                               dtype=logits.dtype)
                gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
                idx = (logits + gumbel).argmax(dim=-1)
            else:
                idx = logits.argmax(dim=-1)
            logp_all = F.log_softmax(logits, dim=-1)
            logp = logp_all.gather(-1, idx[:, None])[:, 0]
            ent = -torch.where(taken, 0.0, logp_all.exp() * logp_all).sum(-1)
            value = self.critic(h)[..., 0].float()
            h = self.gru(h, pooled[rows, idx])
            taken = taken.scatter(1, idx[:, None], True)
            outs.append((idx, logp, value, ent))
        idx, logp, value, ent = (torch.stack(z, dim=1) for z in zip(*outs))
        return {"idx": idx, "logprob": logp, "value": value, "entropy": ent}


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (..., k) of the k largest values along the last axis, ties
    toward the lower index, as ``jax.lax.top_k`` breaks them."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def random_frame_selection(b: int, t: int, k: int,
                           generator: Optional[torch.Generator] = None,
                           device=None, noise: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Uniform K-of-T without replacement, (B, K) long in time order: the
    top K of uniform ``noise`` (B, T), drawn from ``generator`` on
    ``device`` unless given (stage 1 with ``plus_rl``, where the selector
    trains in stage 2 only)."""
    if noise is None:
        noise = torch.rand((b, t), generator=generator, device=device)
    return _top_k(noise, k).sort(dim=-1).values


def select_topk(scores: torch.Tensor, k: int, mode: str = "sample",
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[torch.Tensor] = None,
                idx: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Budgeted frame selection from scores (B, T).

    mode 'sample': the top K of ``scores + G``, G = -log(-log(u)) Gumbel
    noise from uniforms u in [1e-20, 1) (B, T), drawn from ``generator`` on
    the scores' device unless ``uniforms`` is given; 'top': the top K of
    the scores. ``idx`` (B, K) replaces the selection. Returns (idx (B, K)
    long in time order, st_mask (B, T)): the mask is exactly the hard 0/1
    selection in value, with the gradient of ``sigmoid(scores)``."""
    if idx is None:
        if mode == "sample":
            if uniforms is None:
                uniforms = torch.rand(scores.shape, generator=generator,
                                      device=scores.device).clamp_min(1e-20)
            noisy = scores - torch.log(-torch.log(uniforms.to(scores.device)))
        elif mode == "top":
            noisy = scores
        else:
            raise ValueError(f"unknown mode {mode!r}: 'sample' or 'top'")
        idx = _top_k(noisy, k).sort(dim=-1).values
    hard = torch.zeros_like(scores).scatter(1, idx, 1.0)
    soft = torch.sigmoid(scores)
    # parenthesised so that the value is exactly hard: soft - soft.detach()
    # is a true zero, where (hard + soft) - soft would round
    return idx, hard + (soft - soft.detach())


def gather_frames(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-frame tensors x (B, T, ...) at idx (B, K) -> (B, K, ...), a
    contiguous copy."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx.to(x.device)]


def scatter_frames(local_sel: torch.Tensor, idx: torch.Tensor, t: int) -> torch.Tensor:
    """Selected-frame features (B, K, D) back to (B, T, D), zeros elsewhere:
    the one-hot product ``einsum('bkt,bkd->btd')``, as the JAX package
    computes it."""
    onehot = F.one_hot(idx, t).to(local_sel.dtype)
    return torch.einsum("bkt,bkd->btd", onehot, local_sel)


def forward_plus(model, frames: torch.Tensor, frames_small: torch.Tensor,
                 generator: Optional[torch.Generator] = None, train: bool = True,
                 patch_mode: str = "random", freeze_glance: bool = False,
                 uniforms: Optional[torch.Tensor] = None,
                 frame_idx: Optional[torch.Tensor] = None,
                 actions: Optional[torch.Tensor] = None,
                 mark: Optional[Callable[[str], None]] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The AdaFocus+ forward: glance all T frames, select K, focus on those,
    classify the T-step sequence (unselected steps carry glance features
    only).

    frames (B, T, S, S, 3), frames_small (B, T, g, g, 3). patch_mode
    'random' (stage 1: uniform patch actions and, with ``plus_rl``, uniform
    frames) or 'policy' (stage 3 and serving: the greedy spatial policy,
    and with ``plus_rl`` the selector's greedy rollout). The ST selector
    samples (Gumbel top-K) when ``train``, else takes the top K. Draws come
    from ``generator`` in this order: the frames, then the patch actions;
    ``uniforms`` (the Gumbel uniforms, or with ``plus_rl`` the random
    frames' noise, (B, T)), ``frame_idx`` (B, K) and ``actions`` (B, K, 2)
    replace them. ``freeze_glance``: the glancer in eval mode and without
    autograd. Both backbones run in train mode when ``train``. Runs under
    ``model.autocast()``, recording autograd as the caller's grad mode says;
    the selector rollout and the spatial policy never record it.
    ``mark(phase)`` is called as each phase has been enqueued: 'glance',
    'select', 'gather', 'policy', 'extract', 'focus', 'scatter', 'classify'.
    Returns (per-step logits (B, T, classes), {'frame_idx', 'scores' (None
    with ``plus_rl``), 'actions'})."""
    from adafocus_torch.models.gfv import extract_for_frames, fuse_and_classify

    cfg = model.cfg
    b, t = frames_small.shape[:2]
    k = cfg.frame_budget
    note = mark or (lambda phase: None)
    if frame_idx is not None:
        frame_idx = frame_idx.to(model.device, torch.long)
    with model.autocast():
        with torch.set_grad_enabled(torch.is_grad_enabled() and not freeze_glance):
            fmap, pooled = model.glance(frames_small, train and not freeze_glance)
        note("glance")
        scores = None
        if cfg.plus_rl:
            # the selector is a PPO agent: uniform frames in stage 1, its
            # greedy rollout in pick order in stage 3 and serving, a hard
            # mask (no straight-through gradient)
            idx = frame_idx
            if idx is None and patch_mode == "random":
                idx = random_frame_selection(b, t, k, generator, model.device, uniforms)
            elif idx is None:
                with torch.no_grad():
                    idx = model.select_rollout(pooled, "top")["idx"]
            st_mask = torch.zeros((b, t), device=pooled.device).scatter(1, idx, 1.0)
        else:
            scores = model.frame_scores(pooled)
            idx, st_mask = select_topk(scores, k, "sample" if train else "top", generator,
                                       uniforms, frame_idx)
        note("select")
        fmap_sel = gather_frames(fmap, idx)
        frames_sel = gather_frames(frames, idx)
        note("gather")
        if actions is None and patch_mode == "random":
            actions = random_patch_actions((b, k), generator, model.device)
        elif actions is None:
            with torch.no_grad():
                actions = model.policy_rollout(fmap_sel)["actions"]
        note("policy")
        patches = extract_for_frames(frames_sel, actions, cfg.image_size, cfg.patch_size)
        note("extract")
        local_sel = model.focus(patches, train).reshape(b, k, -1)
        note("focus")
        local = scatter_frames(local_sel, idx, t) * st_mask[..., None].to(local_sel.dtype)
        note("scatter")
        logits = fuse_and_classify(model, pooled, local)
        note("classify")
    return logits, {"frame_idx": idx, "scores": scores, "actions": actions}


@torch.inference_mode()
def inference_plus(model, frames: torch.Tensor, frames_small: torch.Tensor,
                   device=None, frame_idx: Optional[torch.Tensor] = None,
                   actions: Optional[torch.Tensor] = None,
                   mark: Optional[Callable[[str], None]] = None) -> torch.Tensor:
    """The AdaFocus+ deployment forward: the top K frames (or the selector's
    greedy rollout), the greedy spatial policy, one batched focus on B*K
    patches. ``frame_idx`` (B, K) and ``actions`` (B, K, 2) replace the
    selection and the policy. Runs on ``device`` (the GPU unless
    ``device="cpu"``), where the model must already be. Returns per-step
    logits (B, T, classes)."""
    from adafocus_torch.models.gfv import _on_model_device

    frames, frames_small = _on_model_device(model, device, frames, frames_small)
    logits, _ = forward_plus(model, frames, frames_small, train=False, patch_mode="policy",
                             frame_idx=frame_idx, actions=actions, mark=mark)
    return logits
