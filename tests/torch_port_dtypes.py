"""The dtype map of the port's stage-0 train step (no JAX here: the card's
tests import this module too).

``stage0_dtypes`` runs one stage-0 step of a GFV with float32 parameters
under its compute dtype (``model.autocast()``, as the CLI trains) and
records the dtype of every tensor at each point of the step that the JAX
package's loss also passes (``tests/test_torch_port_train_bf16.py``):

- ``glancer.units``, ``glancer.blocks``, ``focuser.units``,
  ``focuser.blocks``: the output of every conv-BatchNorm unit and every
  block (inverted residual, bottleneck) of each backbone;
- ``glance.fmap``, ``glance.pooled``: the glancer's map and pooled features;
- ``patches``, ``focus.local``: the extracted patches, the focuser's
  pooled features;
- ``fused``: the classifier's 3328-d input;
- ``gru.h0``, ``gru.hidden``: the GRU's initial and every later hidden state;
- ``logits``, ``glance_logits``, ``focus_logits``: the three heads' logits;
- ``log_softmax``: the log-probabilities of each loss;
- ``loss``: the three stage-0 losses, in the step's order (the classifier's,
  the glancer's, the focuser's).

Each point maps to the sorted list of the dtype names seen there (a point
reached several times, as ``gru.hidden`` is, lists each dtype once).
``grad_dtypes`` gives the dtype of every parameter's gradient after it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
from torch.nn import functional as F

from adafocus_torch.models.layers import ConvBNAct
from adafocus_torch.models.mobilenet import InvertedResidual
from adafocus_torch.models.resnet import Bottleneck
from adafocus_torch.ops.patch import random_patch_actions
from adafocus_torch.train import optim as toptim
from adafocus_torch.train import stages as tstages


def dtype_name(dtype) -> str:
    """'bfloat16', 'float32', ... for a torch or numpy-style dtype."""
    return str(dtype).replace("torch.", "")


class DtypeLog:
    def __init__(self):
        self.points: Dict[str, set] = {}

    def add(self, name: str, *tensors) -> None:
        for t in tensors:
            self.points.setdefault(name, set()).add(dtype_name(t.dtype))

    def as_dict(self) -> Dict[str, List[str]]:
        return {k: sorted(v) for k, v in self.points.items()}


@contextlib.contextmanager
def _wrapped(obj, name: str, after):
    """``obj.name`` replaced within the block by a call of the original whose
    arguments and result are passed to ``after(args, out)``."""
    orig = getattr(obj, name)

    def call(*args, **kwargs):
        out = orig(*args, **kwargs)
        after(args, out)
        return out

    setattr(obj, name, call)
    try:
        yield
    finally:
        if obj.__dict__.get(name) is call:
            if isinstance(obj, torch.nn.Module):
                delattr(obj, name)
            else:
                setattr(obj, name, orig)


def stage0_dtypes(model, batch: Dict[str, torch.Tensor], keep: torch.Tensor,
                  seed: int = 0) -> Dict[str, List[str]]:
    """One stage-0 step of ``model`` (float32 parameters) on ``batch``
    (``frames``, ``frames_small`` in the model's compute dtype, ``labels``)
    with the glancer's dropout mask ``keep``; the dtype map above."""
    log = DtypeLog()
    losses: List[str] = []
    gru = model.classifier.gru
    b, t = batch["frames_small"].shape[:2]
    gen = torch.Generator(device=model.device).manual_seed(seed)
    actions = random_patch_actions((b, t), gen, model.device)

    def ce(args, out):
        log.add("logits" if not losses else ("glance_logits", "focus_logits")[len(losses) - 1],
                args[0])
        losses.append(dtype_name(out.dtype))

    with contextlib.ExitStack() as stack:
        for backbone in ("glancer", "focuser"):
            for m in getattr(model, backbone).modules():
                kind = "units" if isinstance(m, ConvBNAct) else \
                    "blocks" if isinstance(m, (InvertedResidual, Bottleneck)) else None
                if kind:
                    point = f"{backbone}.{kind}"
                    hook = m.register_forward_hook(
                        lambda mod, a, out, point=point: log.add(point, out))
                    stack.callback(hook.remove)
        enter = stack.enter_context
        enter(_wrapped(model, "glance", lambda a, out: (log.add("glance.fmap", out[0]),
                                                        log.add("glance.pooled", out[1]))))
        enter(_wrapped(tstages, "extract_for_frames", lambda a, out: log.add("patches", out)))
        enter(_wrapped(model, "focus", lambda a, out: log.add("focus.local", out)))
        enter(_wrapped(model, "classify_seq", lambda a, out: log.add("fused", a[0])))
        enter(_wrapped(gru, "initial_state", lambda a, out: log.add("gru.h0", out)))
        enter(_wrapped(gru, "step_from_proj", lambda a, out: log.add("gru.hidden", out)))
        enter(_wrapped(F, "log_softmax", lambda a, out: log.add("log_softmax", out)))
        enter(_wrapped(tstages, "_ce_per_step", ce))
        opt, sched = toptim.make_stage_optimizer(model, 0, toptim.OptimConfig())
        tstages.make_stage_train_step(model, 0, opt, sched)(batch, gen, actions, keep)
    out = log.as_dict()
    out["loss"] = losses
    return out


def grad_dtypes(model) -> Dict[str, str]:
    """Parameter name -> its gradient's dtype, for every parameter that has
    one."""
    return {name: dtype_name(p.grad.dtype) for name, p in model.named_parameters()
            if p.grad is not None}
