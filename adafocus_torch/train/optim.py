"""Per-stage optimizers (counterpart of adafocus_tpu/train/optim.py): SGD
with momentum, a backbone and an fc learning rate, cosine or step
schedules, stage-wise freezing.

The JAX package chains optax's ``add_decayed_weights(wd)`` and
``sgd(schedule, momentum)``: g + wd * p goes into the momentum trace
(trace = g + momentum * trace), then p -= lr * trace. That is
``torch.optim.SGD(momentum, dampening=0, nesterov=False, weight_decay=wd)``,
here with one parameter group for ``backbone_lr`` and one for ``fc_lr``.
optax evaluates the schedule at the update count, starting at 0; a
``LambdaLR`` stepped after every update does the same.

Freezing: the JAX package labels a frozen component ``set_to_zero``; here
its parameters get ``requires_grad=False`` and stay out of the optimizer.
Stage 2 trains the policy alone (with AdaFocus+'s ``plus_rl``, the policy and
the selector actor-critic), by PPO's Adam (``adafocus_torch.ppo``), and has no
SGD optimizer.

The sth-sth recipe's focuser groups (``tsn_policies``, the reference's
``get_optim_policies``): the stem conv's weight, the other conv and fc
weights, the biases, and the BatchNorm affines, each its own SGD group at
``backbone_lr`` times the group's lr multiplier and ``weight_decay`` times
its decay multiplier, under the same schedule. ``partial_bn`` freezes every
BatchNorm affine of the focuser but the stem's. A tensor's group follows
from its state-dict name, which carries the flax path's parts (``stem``,
``bn``; a flax ``kernel`` is a ``weight`` here, ``weights.py``), so each
tensor lands in the group the JAX package labels its bridged counterpart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn

# component -> parameter group, per stage ('ppo': PPO's Adam); a component
# not listed is frozen. AdaFocus+'s 'selector' (the ST top-K scorer) trains
# with the classifier; its 'selector_ac' (plus_rl) trains in stage 2 only,
# in PPO's joint learner (train.stages.joint_learner).
_STAGE_LABELS: Dict[int, Dict[str, str]] = {
    0: {"glancer": "backbone", "focuser": "backbone", "classifier": "fc",
        "policy": "frozen", "selector": "fc"},
    1: {"glancer": "frozen", "focuser": "backbone", "classifier": "fc",
        "policy": "frozen", "selector": "fc"},
    2: {"glancer": "frozen", "focuser": "frozen", "classifier": "frozen",
        "policy": "ppo", "selector": "frozen"},
    3: {"glancer": "frozen", "focuser": "frozen", "classifier": "fc",
        "policy": "frozen", "selector": "fc"},
}


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    backbone_lr: float = 0.01
    fc_lr: float = 0.005
    momentum: float = 0.9
    weight_decay: float = 1e-4
    lr_type: str = "cos"        # 'cos' | 'step'
    lr_steps: tuple = (30, 60)  # epoch milestones for 'step'
    epochs: int = 50
    steps_per_epoch: int = 1000
    tsn_policies: bool = False  # per-parameter-type focuser groups (the sth-sth recipe)


# TSN per-parameter-type groups, as (lr_mult, decay_mult) over backbone_lr /
# weight_decay: the JAX package's _TSN_GROUPS for RGB input, the only
# modality of the port's data
_TSN_GROUPS = {
    "first_conv_weight": (1.0, 1.0),
    "first_conv_bias": (2.0, 0.0),
    "normal_weight": (1.0, 1.0),
    "normal_bias": (2.0, 0.0),
    "bn": (1.0, 0.0),
}


def stage_trainable(stage: int) -> Dict[str, str]:
    """The freeze matrix row of ``stage``: component -> 'backbone' | 'fc' |
    'ppo' | 'frozen'."""
    if stage not in _STAGE_LABELS:
        raise ValueError(f"unknown stage {stage}")
    return _STAGE_LABELS[stage]


def freeze_for_stage(model: nn.Module, stage: int) -> Dict[str, List[nn.Parameter]]:
    """Sets ``requires_grad`` on every component of a GFV from the freeze
    matrix row of ``stage``; returns the trained components' parameters by
    label."""
    labels = stage_trainable(stage)
    groups: Dict[str, List[nn.Parameter]] = {}
    for name, module in model.named_children():
        label = labels.get(name, "frozen")
        module.requires_grad_(label != "frozen")
        if label != "frozen":
            groups.setdefault(label, []).extend(module.parameters())
    return groups


def tsn_param_labels(module: nn.Module, partial_bn: bool = False) -> Dict[str, str]:
    """The TSN group of each parameter of a (TSM-)ResNet, by name: BatchNorm
    affines 'tsn_bn' ('frozen' with ``partial_bn`` outside the stem), the
    stem conv's 'tsn_first_conv_weight' / '_bias', every other weight
    'tsn_normal_weight' and bias 'tsn_normal_bias' (the vestigial ``fc``
    head included)."""
    labels = {}
    for name, _ in module.named_parameters():
        parts = name.split(".")
        in_stem = parts[0] == "stem"
        if "bn" in parts[:-1]:
            labels[name] = "frozen" if partial_bn and not in_stem else "tsn_bn"
        else:
            kind = "weight" if parts[-1] == "weight" else "bias"
            labels[name] = f"tsn_{'first_conv' if in_stem else 'normal'}_{kind}"
    return labels


def _focuser_labels(module: nn.Module, base: str, cfg: OptimConfig,
                    partial_bn: bool) -> Dict[str, str]:
    """The trained focuser's parameter labels: the TSN groups with
    ``tsn_policies``; else ``base`` throughout, but 'frozen' for the block
    BatchNorm affines under ``partial_bn``."""
    if cfg.tsn_policies:
        return tsn_param_labels(module, partial_bn)
    labels = {}
    for name, _ in module.named_parameters():
        parts = name.split(".")
        block_bn = parts[0] != "stem" and "bn" in parts[:-1]
        labels[name] = "frozen" if partial_bn and block_bn else base
    return labels


def _lr_factor(cfg: OptimConfig) -> Callable[[int], float]:
    """Update count -> the schedule's multiplier of the base rate."""
    spe = max(cfg.steps_per_epoch, 1)
    if cfg.lr_type == "cos":
        return lambda step: 0.5 * (1.0 + math.cos(math.pi * (step / spe) / cfg.epochs))
    if cfg.lr_type == "step":
        return lambda step: 0.1 ** sum(step / spe >= m for m in cfg.lr_steps)
    raise ValueError(f"unknown lr_type {cfg.lr_type}")


def lr_schedule(base_lr: float, cfg: OptimConfig) -> Callable[[int], float]:
    """Update count -> learning rate: cos ``0.5 * lr * (1 + cos(pi * epoch /
    epochs))``, step ``lr * 0.1^(milestones passed)``, with epoch = count /
    steps_per_epoch."""
    factor = _lr_factor(cfg)
    return lambda step: base_lr * factor(step)


def make_stage_optimizer(model: nn.Module, stage: int, cfg: OptimConfig,
                         partial_bn: bool = False
                         ) -> Tuple[torch.optim.SGD, torch.optim.lr_scheduler.LambdaLR]:
    """The optimizer of ``stage`` over a GFV's components and its schedule.

    Sets ``requires_grad`` on every component from the freeze matrix (frozen
    components get False and stay out of the optimizer). A trained focuser
    takes the TSN groups with ``cfg.tsn_policies``, and ``partial_bn``
    freezes its block BatchNorm affines. Each group's ``name`` is its label.
    Call
    ``scheduler.step()`` after each ``optimizer.step()``.
    """
    if stage == 2:
        raise ValueError("stage 2 trains the policy by PPO's Adam, not by SGD: "
                         "adafocus_torch.ppo.core.ppo_init")
    freeze_for_stage(model, stage)
    hyper = {"backbone": (cfg.backbone_lr, cfg.weight_decay),
             "fc": (cfg.fc_lr, cfg.weight_decay)}
    for name, (lr_mult, decay_mult) in _TSN_GROUPS.items():
        hyper["tsn_" + name] = (cfg.backbone_lr * lr_mult, cfg.weight_decay * decay_mult)
    groups: Dict[str, List[nn.Parameter]] = {}
    for comp, module in model.named_children():
        base = stage_trainable(stage).get(comp, "frozen")
        if base == "frozen":
            continue
        if comp == "focuser":
            labels = _focuser_labels(module, base, cfg, partial_bn)
        else:
            labels = dict.fromkeys(dict(module.named_parameters()), base)
        for name, p in module.named_parameters():
            p.requires_grad_(labels[name] != "frozen")
            if labels[name] != "frozen":
                groups.setdefault(labels[name], []).append(p)
    optimizer = torch.optim.SGD(
        [{"params": groups[label], "lr": lr, "weight_decay": wd, "name": label}
         for label, (lr, wd) in hyper.items() if label in groups],
        momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, _lr_factor(cfg))
