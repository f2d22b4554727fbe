"""Recurrent actor-critic policy (counterpart of adafocus_tpu/models/policy.py).

A 1x1-conv state encoder over the glance feature map (with BatchNorm in the
sth-sth variant; or the MLP encoder, ``policy_conv=False``), a GRU carried across the policy's steps, a linear actor
and a scalar critic.

- Discrete: the actor scores a K-point anchor grid; actions are the greedy
  argmax (eval) or a categorical draw from an explicit ``torch.Generator``
  (the stage-2 PPO rollout, ``sample_discrete``).
- Continuous (the sth-sth family): the actor emits a sigmoid 2-d mean; the
  greedy action is the mean, a sampled one a draw of N(mean, std^2 I)
  clamped to [0, 1], whose logprob is that of the clamped action
  (``sample_continuous``), as the behavior rollout and the PPO evaluate
  pass both score the stored clamped action.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from adafocus_torch.models.gru import GRUCell
from adafocus_torch.models.layers import BatchNorm2d

# width of the encoded policy state, whatever the GRU's hidden size (the
# JAX package's ActorCritic.feat_dim, which GFV leaves at its default)
STATE_DIM = 1024


def action_grid(action_dim: int, device=None) -> torch.Tensor:
    """K uniformly spaced (y, x) anchors in [0, 1]^2, float32, (K, 2).

    Bit-identical to the JAX package's ``jnp.linspace`` grid: ``iota * f32(1 /
    (k - 1))`` with the last point set to 1.0. ``torch.linspace`` differs from
    it by one ulp at some points, enough to move ``floor(a * span)`` by one
    pixel (K=49, span 96: 63 instead of 64). Built on ``device`` from no
    host tensor (a float32 tensor times a Python scalar multiplies in
    float32), so an exported program holds no CPU constant for it.
    """
    k = math.isqrt(action_dim)
    if k * k != action_dim:
        raise ValueError(f"action_dim {action_dim} must be a perfect square")
    line = torch.arange(k, dtype=torch.float32, device=device)
    if k > 1:
        line = torch.cat([line[:-1] * (1.0 / (k - 1)), line.new_ones(1)])
    yy, xx = torch.meshgrid(line, line, indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)


class StateEncoder(nn.Module):
    """Glance feature map (N, h, w, C) -> flat policy state (N, STATE_DIM):
    1x1 conv, ReLU, flatten in (h, w, c) order, Dense, ReLU; or, without
    ``use_conv`` (the MLP encoder), the mean over the map, Dense, ReLU.

    ``use_bn`` (the sth-sth encoder): the conv has no bias and BatchNorm
    (flax's: momentum 0.9, eps 1e-5) follows it, before the ReLU. As in the
    JAX package, no BatchNorm follows ``fc``, where the original sth-sth
    encoder has one.

    The flatten order is the JAX package's NHWC one, so that the ``fc``
    weights line up with a bridged flax tree."""

    def __init__(self, in_channels: int, map_hw: Tuple[int, int],
                 conv_channels: int = 32, use_bn: bool = False, use_conv: bool = True):
        super().__init__()
        if not use_conv:
            self.proj = self.bn = None
            self.fc = nn.Linear(in_channels, STATE_DIM)
            return
        self.proj = nn.Conv2d(in_channels, conv_channels, 1, bias=not use_bn)
        self.bn = BatchNorm2d(conv_channels) if use_bn else None
        self.fc = nn.Linear(map_hw[0] * map_hw[1] * conv_channels, STATE_DIM)

    def forward(self, fmap: torch.Tensor) -> torch.Tensor:
        if self.proj is None:
            return F.relu(self.fc(fmap.mean(dim=(1, 2))))
        x = self.proj(fmap.permute(0, 3, 1, 2))
        if self.bn is not None:
            x = self.bn(x)
        x = F.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.relu(self.fc(x))


class ActorCritic(nn.Module):
    """Recurrent actor-critic: discrete over a K-point anchor grid, or
    ``continuous`` (a sigmoid 2-d mean; the Gaussian's std ``action_std``
    when sampled)."""

    def __init__(self, in_channels: int, map_hw: Tuple[int, int],
                 action_dim: int = 49, hidden_dim: int = 1024,
                 encoder_channels: int = 32, continuous: bool = False,
                 encoder_bn: bool = False, action_std: float = 0.1,
                 encoder_conv: bool = True):
        super().__init__()
        self.continuous = continuous
        self.action_std = action_std
        self.encoder = StateEncoder(in_channels, map_hw, encoder_channels, encoder_bn,
                                    encoder_conv)
        self.gru = GRUCell(STATE_DIM, hidden_dim)
        self.actor = nn.Linear(hidden_dim, 2 if continuous else action_dim)
        self.critic = nn.Linear(hidden_dim, 1)

    def rollout_states(self, fmaps_tb: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Encode all T steps in one batched call, run the GRU recurrence,
        then actor and critic batched.

        fmaps_tb: (T, B, gh, gw, C). Returns time-major
        (hiddens (T, B, H), actor out (T, B, K) logits or (T, B, 2) sigmoid
        means in the compute dtype, value (T, B)).
        """
        t, b = fmaps_tb.shape[:2]
        states = self.encoder(fmaps_tb.reshape((t * b,) + fmaps_tb.shape[2:]))
        _, hiddens = self.gru.scan_time(
            self.gru.initial_state(b, states.dtype), states.reshape(t, b, -1)
        )
        actor_out = self.actor(hiddens)
        if self.continuous:
            actor_out = torch.sigmoid(actor_out)
        return hiddens, actor_out, self.critic(hiddens)[..., 0]


def discrete_logprobs(logits: torch.Tensor) -> torch.Tensor:
    """``log_softmax`` over the K anchors in float32 at least (float64 stays
    float64): the one computation that the behavior rollout and the PPO
    evaluate pass share, so that their ratios start at exactly 1."""
    return F.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)


def sample_discrete(logits: torch.Tensor, generator: torch.Generator
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A categorical draw from the actor's logits (..., K) by Gumbel-max, as
    ``jax.random.categorical`` draws: ``argmax(logits + G)`` with G =
    -log(-log(u)), u uniform from ``generator`` (on the logits' device).
    Returns (idx (...), logprob (...)), the logprob ``discrete_logprobs``
    gathered at idx."""
    logp = discrete_logprobs(logits)
    u = torch.rand(logp.shape, generator=generator, device=logp.device, dtype=logp.dtype)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    idx = (logp + gumbel).argmax(dim=-1)
    return idx, logp.gather(-1, idx[..., None])[..., 0]


def greedy_discrete(logits: torch.Tensor) -> torch.Tensor:
    """Eval-time deterministic action: the first index of the maximum."""
    return logits.argmax(dim=-1)


def discrete_to_coords(idx: torch.Tensor, action_dim: int) -> torch.Tensor:
    """Grid index -> (y, x) in [0, 1]^2, float32."""
    return action_grid(action_dim, device=idx.device)[idx]


def gaussian_logprob(x: torch.Tensor, mean: torch.Tensor, action_std: float) -> torch.Tensor:
    """log N(x; mean, std^2 I) summed over the last axis, in float32 at least
    (float64 stays float64)."""
    dtype = torch.promote_types(torch.promote_types(x.dtype, mean.dtype), torch.float32)
    var = action_std ** 2
    d = x.to(dtype) - mean.to(dtype)
    return (-0.5 * (d * d / var + math.log(2.0 * math.pi * var))).sum(-1)


def gaussian_entropy(action_std: float, dim: int = 2) -> float:
    """Entropy of N(., std^2 I) in ``dim`` dimensions (independent of the mean)."""
    return 0.5 * dim * (1.0 + math.log(2.0 * math.pi * action_std ** 2))


def sample_continuous(mean: torch.Tensor, action_std: float,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A draw of N(mean, std^2 I) clamped to [0, 1]: ``clamp(mean + std *
    noise)``, ``noise`` standard normal from ``generator`` (on the means'
    device) unless given (the means' shape). Returns (action, logprob), in
    float32 at least; the logprob is ``gaussian_logprob`` of the *clamped*
    action, the one stored and scored again by the PPO evaluate pass."""
    dtype = torch.promote_types(mean.dtype, torch.float32)
    if noise is None:
        if generator is None:
            raise ValueError("sampling needs a generator or the noise")
        noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=dtype)
    action = (mean.to(dtype) + noise.to(mean.device, dtype) * action_std).clamp(0.0, 1.0)
    return action, gaussian_logprob(action, mean, action_std)


def sample_rollout(actor_out: torch.Tensor, mode: str, action_dim: int,
                   generator: Optional[torch.Generator] = None,
                   continuous: bool = False, action_std: float = 0.25,
                   noise: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Action selection over a time-major rollout.

    actor_out: (T, B, K) logits, or (T, B, 2) sigmoid means when
    ``continuous``. mode 'greedy' takes the argmax (the mean), 'sample'
    draws from ``generator`` (the continuous draw ``sample_continuous`` at
    ``action_std``; its standard normal ``noise`` (T, B, 2) may be given
    instead). Returns time-major (actions (T, B, 2), f32 on the grid and
    when sampled, the means' dtype when greedy and continuous, idx (T, B),
    zeros when continuous, logprob (T, B) f32 at least, zeros in greedy
    mode).
    """
    if mode not in ("greedy", "sample"):
        raise ValueError(f"unknown mode {mode!r}: 'greedy' or 'sample'")
    if continuous:
        zeros = actor_out.shape[:-1]
        idx = torch.zeros(zeros, dtype=torch.long, device=actor_out.device)
        if mode == "sample":
            actions, logprob = sample_continuous(actor_out, action_std, generator, noise)
            return actions, idx, logprob
        return (actor_out, idx,
                torch.zeros(zeros, dtype=torch.float32, device=actor_out.device))
    if mode == "sample":
        if generator is None:
            raise ValueError("mode='sample' needs a generator")
        idx, logprob = sample_discrete(actor_out, generator)
        logprob = logprob.float()
    else:
        idx = greedy_discrete(actor_out)
        logprob = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    return discrete_to_coords(idx, action_dim), idx, logprob
