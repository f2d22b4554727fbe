"""Plain reference of the ActivityNet AdaFocus model (``family: gfv``):
the greedy deployment forward and the stage-1 training step.

Forward: MobileNetV2 over the T downsampled frames; the recurrent policy's
anchor logits a step; a patch cropped from each full frame at the served
action; ResNet-50 over the patches; a GRU over [pooled glance | pooled
patch] features and a linear layer a step -> logits (B, T, classes).

Stage 1 (AdaFocus, section 3.3): the glancer frozen (running statistics),
patches at given random actions, the focuser in train mode (batch
statistics, running statistics updated), cross-entropy of every step's
logits against the video's label, mean over B*T; SGD with momentum and
weight decay added to the gradient, the focuser at the backbone rate and the
classifier at the fc rate, under the cosine schedule at the update count.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.nn import functional as F

from perfbench.reference.nets import (
    crop, gru_scan, linear, mobilenet_v2, nchw, policy_outputs, resnet50, wide,
)
from perfbench.reference.precision import identity

# videos a block of the reference's forward: a bound on its memory
CHUNK = 8


def glance(W, small: torch.Tensor, q=identity):
    """(B, T, g, g, 3) -> maps (B, T, 1280, h, w), pooled (B, T, 1280)."""
    b, t = small.shape[:2]
    fmap, pooled = mobilenet_v2(W, nchw(small.reshape((b * t,) + small.shape[2:])), q=q)
    return fmap.reshape((b, t) + fmap.shape[1:]), pooled.reshape(b, t, -1)


def classify(W, pooled, local, q=identity):
    return linear(gru_scan(W, "classifier.gru", torch.cat([pooled, local], dim=-1), q), W,
                  "classifier.fc", q)


def focus_at(W, cfg, frames, actions, q=identity, stats=None):
    """(B, T, S, S, 3) frames, (B, T, 2) actions -> pooled (B, T, 2048)."""
    b, t = frames.shape[:2]
    patches = crop(frames.reshape((b * t,) + frames.shape[2:]), actions.reshape(-1, 2),
                   cfg["patch_size"])
    return resnet50(W, nchw(patches), stats=stats, q=q).reshape(b, t, -1)


@torch.no_grad()
def serve(W, cfg: dict, frames, small, actions, q=identity) -> Dict[str, torch.Tensor]:
    """The forward at the served ``actions`` (B, T, 2): the policy's anchor
    logits (B, T, K) and the logits (B, T, classes), float32, in blocks of
    ``CHUNK`` videos."""
    policy, logits = [], []
    for i in range(0, frames.shape[0], CHUNK):
        sl = slice(i, i + CHUNK)
        fmap, pooled = glance(W, wide(small[sl]), q)
        policy.append(policy_outputs(W, cfg, fmap, q))
        logits.append(classify(W, pooled, focus_at(W, cfg, wide(frames[sl]), actions[sl], q),
                               q))
    return {"policy": torch.cat(policy), "logits": torch.cat(logits)}


def lr_factor(optim: dict, count: int) -> float:
    """The cosine schedule's multiplier at update ``count``."""
    epoch = count / optim["steps_per_epoch"]
    return 0.5 * (1.0 + math.cos(math.pi * epoch / optim["epochs"]))


def stage1_steps(W0: Dict[str, torch.Tensor], cfg: dict, optim: dict, batches: List[dict],
                 q=identity) -> Dict[str, object]:
    """Stage-1 steps from weights ``W0`` over ``batches`` (each ``frames``,
    ``frames_small``, ``labels``, ``actions``). Returns each step's loss, the
    raw gradient and the momentum buffer of each trained tensor after the
    first step, and the weights after the last."""
    W = {k: wide(v).clone() for k, v in W0.items()}
    trained = {k: optim["backbone_lr"] if k.startswith("focuser.") else optim["fc_lr"]
               for k, v in W.items() if k.startswith(("focuser.", "classifier."))
               and v.is_floating_point() and "running_" not in k}
    buffers: Dict[str, torch.Tensor] = {}
    losses, first_grad, first_buf = [], {}, {}
    for count, batch in enumerate(batches):
        with torch.no_grad():
            pooled = torch.cat([glance(W, wide(batch["frames_small"][i:i + CHUNK]), q)[1]
                                for i in range(0, batch["frames_small"].shape[0], CHUNK)])
        leaves = {k: W[k].detach().requires_grad_(True) for k in trained}
        Wg = dict(W, **leaves)
        stats: Dict[str, torch.Tensor] = {}
        local = focus_at(Wg, cfg, wide(batch["frames"]), batch["actions"], q, stats)
        logits = classify(Wg, pooled, local, q)
        logp = F.log_softmax(wide(logits), dim=-1)
        b, t = logp.shape[:2]
        labels = batch["labels"].long().reshape(b, 1, 1).expand(b, t, 1)
        loss = -logp.gather(-1, labels).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        losses.append(loss.detach())
        factor = lr_factor(optim, count)
        with torch.no_grad():
            for (k, p), g in zip(leaves.items(), grads):
                g = torch.zeros_like(p) if g is None else g
                d = g + optim["weight_decay"] * p
                buffers[k] = d.clone() if count == 0 else optim["momentum"] * buffers[k] + d
                if count == 0:
                    first_grad[k], first_buf[k] = g.clone(), buffers[k].clone()
                W[k] = p.detach() - trained[k] * factor * buffers[k]
            W.update(stats)
        del leaves, Wg, local, logits, logp, loss, grads
    return {"losses": losses, "first_grad": first_grad, "first_buf": first_buf, "weights": W}
