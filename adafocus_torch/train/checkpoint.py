"""Checkpoint / resume, component-keyed and stage-aware (counterpart of
adafocus_tpu/train/checkpoint.py).

A checkpoint is one ``torch.save`` file: each component of the GFV
(``glancer``, ``focuser``, ``classifier``, ``policy``, and AdaFocus+'s
``selector`` or ``selector_ac`` where the model has one) as its own
``state_dict`` (BatchNorm's running statistics inside it), the SGD
optimizer and the ``LambdaLR`` schedule of a supervised stage, the PPO
learner of stage 2 (its Adam and update count; its policy is the model's),
and ``meta`` (epoch, acc, best_acc). It is written to a temporary file and
renamed, so a reader never sees half a checkpoint; ``checkpoint.pt`` is the
latest and ``model_best.pt`` the best by accuracy, as the JAX package's
``checkpoint`` / ``model_best`` pair.

Stage N warm-starts from stage N-1 by loading the components of
``STAGE_LOADS[N]`` only; a tensor whose shape disagrees with the fresh
model's (a head of another class count) keeps its fresh value. The port
reads its own format only; a JAX checkpoint crosses with
``weights.gfv_state_dict_from_flax``.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch

# components each stage loads from the previous stage's checkpoint (the JAX
# package's table; AdaFocus+'s 'selector' and 'selector_ac' are skipped
# where the model or the checkpoint has none)
STAGE_LOADS = {
    0: (),
    1: ("glancer", "focuser"),
    2: ("glancer", "focuser", "classifier", "selector"),
    3: ("glancer", "focuser", "classifier", "policy", "selector",
        "selector_ac"),
}
COMPONENTS = ("glancer", "focuser", "classifier", "policy")   # every model's
SELECTORS = ("selector", "selector_ac")                         # AdaFocus+'s, one at most
FILES = {False: "checkpoint.pt", True: "model_best.pt"}


def _to_saveable(state) -> Dict[str, Any]:
    """TrainState -> a dict of CPU tensors and plain values."""
    model = state.model
    out: Dict[str, Any] = {
        "components": {name: getattr(model, name).state_dict() for name in components_of(model)}}
    if state.optimizer is not None:
        out["optimizer"] = state.optimizer.state_dict()
        out["scheduler"] = state.scheduler.state_dict()
    if state.ppo is not None:
        out["ppo"] = {"optimizer": state.ppo.optimizer.state_dict(), "step": state.ppo.step}
    return out


def components_of(model) -> tuple:
    """The checkpointed components ``model`` has."""
    return COMPONENTS + tuple(name for name in SELECTORS if hasattr(model, name))


def load_components(model, tree: Dict[str, Any]) -> None:
    """Every component of ``model`` from a checkpoint's (evaluation)."""
    for name in components_of(model):
        getattr(model, name).load_state_dict(tree["components"][name])


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, state, epoch: int, acc: float, best_acc: float,
                    is_best: bool = False) -> None:
    """Write ``<ckpt_dir>/checkpoint.pt`` (atomically); copy it to
    ``model_best.pt`` when ``is_best``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tree = _to_saveable(state)
    tree["meta"] = {"epoch": int(epoch), "acc": float(acc), "best_acc": float(best_acc)}
    path = os.path.join(ckpt_dir, FILES[False])
    _atomic_save(tree, path)
    if is_best:
        best = os.path.join(ckpt_dir, FILES[True])
        tmp = f"{best}.{os.getpid()}.tmp"
        shutil.copyfile(path, tmp)
        os.replace(tmp, best)


def load_checkpoint(ckpt_dir: str, best: bool = False) -> Optional[Dict[str, Any]]:
    """Read a checkpoint (tensors on the CPU), or None if absent."""
    path = os.path.join(ckpt_dir, FILES[best])
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_train_state(state, tree: Dict[str, Any]):
    """Full resume of a run of the same stage: every component, the
    optimizer with its momentum, the schedule's update count (so that the
    learning rate goes on from where it was), the PPO learner. In place;
    returns ``state``."""
    load_components(state.model, tree)
    if state.optimizer is not None:
        state.optimizer.load_state_dict(tree["optimizer"])
        state.scheduler.load_state_dict(tree["scheduler"])
        _rates_at_count(state.scheduler)
    if state.ppo is not None:
        state.ppo.optimizer.load_state_dict(tree["ppo"]["optimizer"])
        state.ppo.step = int(tree["ppo"]["step"])
    return state


def _rates_at_count(scheduler: torch.optim.lr_scheduler.LambdaLR) -> None:
    """Sets each parameter group's learning rate to this run's schedule at
    the restored update count. The optimizer's saved rates are the saved
    run's schedule's, which differs when the resumed run asks for other
    epochs; the JAX package's optax evaluates the current schedule at the
    count."""
    rates = [base * factor(scheduler.last_epoch)
             for base, factor in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, rate in zip(scheduler.optimizer.param_groups, rates):
        group["lr"] = rate
    scheduler._last_lr = rates


def _merge_compatible(fresh: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """``src``'s tensors where the key exists and the shape agrees, else the
    fresh ones (the reference's strict=False component loads)."""
    return {k: src[k] if k in src and src[k].shape == v.shape else v
            for k, v in fresh.items()}


def load_stage_components(state, tree: Dict[str, Any], stage: int):
    """Stage-aware warm start: load only the components ``stage`` inherits
    from the previous stage's checkpoint (a tensor whose shape disagrees
    keeps its fresh value); the optimizer stays fresh. In place; returns
    ``state``."""
    src = tree["components"]
    for name in STAGE_LOADS[stage]:
        if name in src and hasattr(state.model, name):
            module = getattr(state.model, name)
            module.load_state_dict(_merge_compatible(module.state_dict(), src[name]))
    return state


def best_acc_of(tree: Optional[Dict[str, Any]]) -> float:
    if not tree:
        return 0.0
    return float(tree.get("meta", {}).get("best_acc", 0.0))
