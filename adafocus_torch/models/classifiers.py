"""Classifier heads (counterpart of adafocus_tpu/models/classifiers.py).

``RecurrentClassifier``, the ActivityNet head: GRU(input = 1280 + 2048 =
3328, hidden = 1024) over fused glance + focus features and a per-step FC.
The hidden state is an explicit carry; ``step`` is one MDP step and
``lookahead`` one step whose hidden is not carried (the stage-2 random-patch
baseline).

``LinearClassifier``: a per-frame FC and the log of the mean over time of
the per-frame softmax (clipped at 1e-12), the consensus log-probabilities
(B, classes).

``ConsensusHead`` and ``avg_consensus``, the sth-sth head: dropout and a
per-frame FC over focuser features, averaged over time by the caller.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from adafocus_torch.models.gru import GRUCell


class RecurrentClassifier(nn.Module):
    def __init__(self, in_dim: int, num_classes: int, hidden_dim: int = 1024):
        super().__init__()
        self.gru = GRUCell(in_dim, hidden_dim)
        self.fc = nn.Linear(hidden_dim, num_classes)

    def step(self, hidden: torch.Tensor, feature: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One timestep: (h, (B, D)) -> (h', (B, classes))."""
        hidden = self.gru(hidden, feature)
        return hidden, self.fc(hidden)

    def lookahead(self, hidden: torch.Tensor, feature: torch.Tensor) -> torch.Tensor:
        """One GRU step from ``hidden`` whose result is not carried:
        (N, H), (N, D) -> logits (N, classes)."""
        return self.fc(self.gru(hidden, feature))

    def forward_with_hiddens(self, features: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, D) -> (logits (B, T, classes), hiddens (B, T, H))."""
        h0 = self.gru.initial_state(features.shape[0], features.dtype)
        _, hs = self.gru.scan_time(h0, features.transpose(0, 1))
        return self.fc(hs).transpose(0, 1), hs.transpose(0, 1)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """features (B, T, D) -> per-step logits (B, T, classes)."""
        return self.forward_with_hiddens(features)[0]


class LinearClassifier(nn.Module):
    """Per-frame FC; the consensus is the mean of the per-frame softmax
    probabilities. The JAX package's GFV builds it without dropout."""

    def __init__(self, in_dim: int, num_classes: int):
        super().__init__()
        self.fc = nn.Linear(in_dim, num_classes)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """features (B, T, D) -> consensus log-probabilities (B, classes)."""
        probs = torch.softmax(self.fc(features), dim=-1).mean(dim=1)
        return torch.log(probs.clamp_min(1e-12))


class ConsensusHead(nn.Module):
    """The sth-sth local head: dropout, then a per-frame FC over focuser
    features (..., D) -> (..., classes)."""

    def __init__(self, in_dim: int, num_classes: int, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.fc = nn.Linear(in_dim, num_classes)

    def forward(self, features: torch.Tensor, keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The dropout is the identity in eval mode. In train mode it is
        flax's, ``where(keep, x / (1 - rate), 0)``: ``keep``, the boolean
        mask of kept units (the features' shape), is drawn from
        ``generator`` (on the features' device) unless given; one of the two
        is required."""
        if self.training and self.dropout_rate > 0:
            if keep is None:
                if generator is None:
                    raise ValueError("train-mode dropout needs a keep mask or a generator")
                keep = torch.rand(features.shape, generator=generator,
                                  device=features.device) < 1.0 - self.dropout_rate
            features = torch.where(keep, features / (1.0 - self.dropout_rate), 0.0)
        return self.fc(features)


def avg_consensus(logits: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Average consensus over the time axis."""
    return logits.mean(dim=dim)
