"""Evaluation metrics (counterpart of adafocus_tpu/ops/metrics.py): top-k
accuracy on the device, multi-label mAP and a running meter on the host.

The numpy functions are copies of the JAX package's, so that the port
imports nothing of it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks: Sequence[int] = (1, 5)) -> Tuple[torch.Tensor, ...]:
    """logits (B, C), int labels (B,) -> float32 fraction correct for each k
    (k clamped to C). Ties rank the lower class index first, as
    ``lax.top_k`` does: a stable descending sort."""
    c = logits.shape[-1]
    max_k = min(max(ks), c)
    top = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :max_k]
    correct = top == labels.to(top.device)[:, None]
    return tuple(correct[:, : min(k, c)].any(dim=1).float().mean() for k in ks)


def average_precision(scores: np.ndarray, targets: np.ndarray) -> float:
    """AP for one class: scores (N,), binary targets (N,)."""
    order = np.argsort(-scores, kind="stable")
    t = targets[order]
    n_pos = t.sum()
    if n_pos == 0:
        return 0.0
    hits = np.cumsum(t)
    prec = hits / (np.arange(len(t)) + 1)
    return float((prec * t).sum() / n_pos)


def mean_average_precision(scores: np.ndarray, multi_hot: np.ndarray,
                           skip_empty: bool = False) -> float:
    """mAP over classes; scores (N, C), multi_hot (N, C) in {0, 1}. A class
    with no positives counts as AP 0 (the reference's ``cal_map``) unless
    ``skip_empty``, which averages over the classes with positives only."""
    aps = []
    for c in range(scores.shape[1]):
        if multi_hot[:, c].sum() > 0:
            aps.append(average_precision(scores[:, c], multi_hot[:, c]))
        elif not skip_empty:
            aps.append(0.0)
    return float(np.mean(aps)) if aps else 0.0


def multi_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """(N, K) padded label lists (-1 = empty slot) or (N,) ints -> (N, C)."""
    labels = np.asarray(labels)
    if labels.ndim == 1:
        labels = labels[:, None]
    out = np.zeros((labels.shape[0], num_classes), np.float32)
    for i, row in enumerate(labels):
        for label in np.atleast_1d(row):
            if label >= 0:
                out[i, int(label)] = 1.0
    return out


class AverageMeter:
    """Host-side running average."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __repr__(self):
        return f"{self.name}={self.avg:.4f}(n={self.count})"
