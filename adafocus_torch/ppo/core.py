"""PPO for the patch policy (counterpart of adafocus_tpu/ppo/core.py).

  * no-bootstrap discounted returns over the T-step episode (gamma 0.7),
    normalised over the flattened T*B values by their population std;
  * clipped surrogate (eps 0.2) + 0.5 * value MSE - 0.01 * entropy;
  * ``k_epochs`` re-evaluations of the episode per update (1 by default),
    each followed by one Adam step.

optax's ``adam`` and ``torch.optim.Adam`` compute the same update:
bias-corrected first and second moments, eps (1e-8) added outside the
square root.

The JAX package keeps a behavior copy of the policy parameters
(``params_old``) and sets it to the trained ones after every update, so the
two are equal at the start of every step. Here the behavior policy is the
current policy run under ``torch.no_grad()``, and no second copy is kept.

As in the JAX package, the loss is computed in float32 whatever the
parameters' dtype: ``evaluate_episode`` returns float32 logprobs, values and
entropies. Its ``log_softmax`` runs in float32 at least, where the JAX
package takes it in the compute dtype (bf16 for the flagship).

A continuous policy (the sth-sth family's) scores the stored clamped
actions under its Gaussian, whose entropy is a constant. A policy with a
BatchNorm encoder carries its running statistics as the JAX package does:
each epoch's evaluate pass runs it in train mode and advances them once
(the behavior rollout, ``train.stages._rollout_time_major``, normalises
with the same batch statistics and leaves the running ones).

Data parallel (``replicas``, the JAX package's ``axis_name``): the returns
are normalised with the global batch's moments and every epoch's gradients
are averaged over the replicas (``parallel/mesh.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, ContextManager, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from adafocus_torch.models.layers import training
from adafocus_torch.models.policy import discrete_logprobs, gaussian_entropy, gaussian_logprob
from adafocus_torch.parallel.mesh import Replicas, average_, average_grads_

ADAM_EPS = 1e-8     # optax.adam's default


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    gamma: float = 0.7
    eps_clip: float = 0.2
    k_epochs: int = 1
    lr: float = 3e-4
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    reward_mode: str = "random"  # 'conf' | 'prev' | 'random'
    betas: Tuple[float, float] = (0.9, 0.999)


@dataclasses.dataclass
class PPOState:
    """The policy learner: the policy module (trained in place; AdaFocus+'s
    joint learner is a ``ModuleDict`` of the patch policy and the selector
    actor-critic), its Adam, the configuration and the count of updates."""

    policy: nn.Module
    optimizer: torch.optim.Adam
    cfg: PPOConfig
    step: int = 0


def make_optimizer(params: Iterable[torch.Tensor], cfg: PPOConfig) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=cfg.lr, betas=cfg.betas, eps=ADAM_EPS)


def ppo_init(policy: nn.Module, cfg: PPOConfig = PPOConfig()) -> PPOState:
    """A learner over ``policy``'s parameters, which it marks trainable."""
    policy.requires_grad_(True)
    return PPOState(policy, make_optimizer(policy.parameters(), cfg), cfg)


def compute_rewards(confidence: torch.Tensor, baseline: Optional[torch.Tensor],
                    mode: str) -> torch.Tensor:
    """Per-step rewards (B, T) from the target class's confidence (B, T)
    after each step: 'conf' the confidence, 'prev' its rise over the
    previous step, 'random' its excess over ``baseline``, the confidence of
    random patches."""
    if mode == "conf":
        return confidence
    if mode == "prev":
        prev = torch.cat([torch.zeros_like(confidence[:, :1]), confidence[:, :-1]], dim=1)
        return confidence - prev
    if mode == "random":
        if baseline is None:
            raise ValueError("reward mode 'random' needs a baseline")
        return confidence - baseline
    raise ValueError(f"unknown reward mode {mode}")


def discounted_returns(rewards_tb: torch.Tensor, gamma: float,
                       replicas: Optional[Replicas] = None) -> torch.Tensor:
    """No-bootstrap discounted returns of time-major rewards (T, B),
    normalised over all T*B values: mean 0, divided by the population std
    (``jnp.std``) plus 1e-5. Over several ``replicas`` the moments are the
    global batch's, as the JAX package's under ``axis_name``: the mean of
    the replicas' means, then the square root of the mean of their mean
    squared deviations from it (exact for equal shards)."""
    carry = torch.zeros_like(rewards_tb[0])
    returns = []
    for r in reversed(rewards_tb.unbind(0)):
        carry = r + gamma * carry
        returns.append(carry)
    returns = torch.stack(returns[::-1])
    if replicas is None or replicas.world == 1:
        return (returns - returns.mean()) / (returns.std(correction=0) + 1e-5)
    mean = returns.mean()
    average_([mean], replicas)
    var = ((returns - mean) ** 2).mean()
    average_([var], replicas)
    return (returns - mean) / (var.sqrt() + 1e-5)


def evaluate_episode(policy: nn.Module, fmaps_tb: torch.Tensor, actions_tb: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Re-run the recurrent policy over a stored episode under its current
    parameters, in the policy's current mode: fmaps (T, B, gh, gw, C), grid
    indices (T, B) or, for a continuous policy, clamped actions (T, B, 2)
    -> float32 at least (logprob (T, B), value (T, B), entropy (T, B))."""
    _, actor_out, value = policy.rollout_states(fmaps_tb)
    if policy.continuous:
        logp = gaussian_logprob(actions_tb, actor_out, policy.action_std)
        entropy = torch.full_like(logp, gaussian_entropy(policy.action_std))
    else:
        logprobs = discrete_logprobs(actor_out)
        logp = logprobs.gather(-1, actions_tb[..., None])[..., 0]
        entropy = -(logprobs.exp() * logprobs).sum(-1)
    return logp.float(), value.float(), entropy.float()


def clipped_objective(logp: torch.Tensor, values: torch.Tensor, entropy: torch.Tensor,
                      old_logprob: torch.Tensor, returns: torch.Tensor, cfg: PPOConfig
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The clipped-surrogate PPO loss and its terms from an evaluate pass's
    logprobs, values and entropies and the episode's behavior logprobs and
    returns (all the same shape)."""
    advantages = returns - values.detach()
    ratios = torch.exp(logp - old_logprob)
    surr1 = ratios * advantages
    surr2 = ratios.clamp(1.0 - cfg.eps_clip, 1.0 + cfg.eps_clip) * advantages
    value_loss = ((values - returns) ** 2).mean()
    policy_loss = -torch.minimum(surr1, surr2).mean()
    ent = entropy.mean()
    loss = policy_loss + cfg.value_coef * value_loss - cfg.entropy_coef * ent
    return loss, {"ppo/loss": loss, "ppo/policy_loss": policy_loss,
                  "ppo/value_loss": value_loss, "ppo/entropy": ent,
                  "ppo/ratio_mean": ratios.mean()}


def ppo_loss(policy: nn.Module, memory: Dict[str, torch.Tensor], cfg: PPOConfig
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped-surrogate PPO loss of a time-major episode: ``memory`` holds
    fmaps, actions (grid indices or continuous actions), old_logprob and
    returns (discounted and normalised), each (T, B, ...)."""
    logp, values, entropy = evaluate_episode(policy, memory["fmaps"], memory["actions"])
    return clipped_objective(logp, values, entropy, memory["old_logprob"], memory["returns"],
                             cfg)


def ppo_update(state: PPOState, memory: Dict[str, torch.Tensor],
               autocast: Callable[[], ContextManager] = contextlib.nullcontext,
               loss_fn: Callable = ppo_loss, replicas: Optional[Replicas] = None
               ) -> Dict[str, torch.Tensor]:
    """``cfg.k_epochs`` epochs of clipped PPO on one episode, each one Adam
    step; the loss, ``loss_fn(state.policy, memory, cfg)`` (``ppo_loss``
    unless given), runs under ``autocast()`` (``GFV.autocast`` for a
    model that computes in another dtype than its parameters'), its
    backward outside. With ``replicas``, each epoch's gradients are
    averaged over them before the Adam step, as the JAX package's
    ``pmean`` in every epoch. The policy is in train mode meanwhile, so
    that a BatchNorm encoder normalises with batch statistics and advances
    its running ones once an epoch (each replica its own; the step averages
    them after); its former mode after. Returns the last epoch's metrics of
    this replica, 0-d tensors."""
    with training(state.policy):
        for _ in range(state.cfg.k_epochs):
            state.optimizer.zero_grad(set_to_none=True)
            with autocast():
                loss, metrics = loss_fn(state.policy, memory, state.cfg)
            loss.backward()
            average_grads_(state.optimizer, replicas)
            state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}
