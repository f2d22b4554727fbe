"""The comparison that decides ``correct``, and the work counted for the
metrics' peaks: both from the plain reference (``reference/<family>.py``),
never from the program.

Serving. For each judged request the reference runs, in float32 with TF32
off, over the request's own inputs and the actions the program served:

- ``logit_err``: max |program's logits - reference's| / max |reference's|;
- ``logit_rms``: |program's logits - reference's| / |reference's|, the
  roots of the sums of squares over the request;
- ``anchor_gap`` (a discrete policy): the widest gap by which the
  reference's logit of a served anchor lies below its best anchor's, over
  the largest |logit|; a served action that is no anchor reads infinity;
- ``action_err`` (a continuous policy): max |served action - the
  reference's mean|.

Judging the served actions by the reference's logits, and then following
the served actions, keeps a near-tie between two anchors, which bf16 and
float32 may break differently, from deciding the comparison by itself.

Training: see ``train.py``.
"""

from __future__ import annotations

import importlib
import json
import math
import os
from typing import Dict, List

import torch

from perfbench import peaks
from perfbench.common import HERE
from perfbench.reference.nets import anchor_grid


def reference(cfg: dict):
    return importlib.import_module(f"perfbench.reference.{cfg['family']}")


def limits(cell_name: str) -> Dict[str, float]:
    with open(os.path.join(HERE, "limits", cell_name + ".json")) as f:
        return json.load(f)["limits"]


def serve_request(cfg: dict, weights, batch: dict, output: torch.Tensor,
                  actions: torch.Tensor) -> Dict[str, float]:
    """The numbers of one judged request (see the module's docstring)."""
    ref = reference(cfg).serve(weights, cfg, batch["frames"], batch["frames_small"],
                               actions.float())
    logits = ref["logits"]
    diff = output.to(logits.device).float() - logits
    out = {"logit_err": float(diff.abs().max() / logits.abs().max()),
           "logit_rms": float(diff.norm() / logits.norm())}
    policy = ref["policy"]
    if cfg["continuous_policy"]:
        out["action_err"] = float((actions.float() - policy).abs().max())
    else:
        grid = anchor_grid(cfg["action_dim"], policy.device)
        match = (actions.float()[..., None, :] == grid).all(-1)
        if not bool(match.any(-1).all()):
            out["anchor_gap"] = math.inf
        else:
            chosen = policy.gather(-1, match.float().argmax(-1, keepdim=True))[..., 0]
            gap = (policy.max(-1).values - chosen).max() / policy.abs().max()
            out["anchor_gap"] = float(gap)
    return out


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in readings) for k in readings[0]}


def checks(cell_name: str, values: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number (those ``limits/<cell>.json`` holds a limit for)
    beside its limit."""
    lim = limits(cell_name)
    return {k: {"value": values[k], "limit": lim[k]} for k in lim}


def passed(checks_: Dict[str, dict]) -> bool:
    return all(isinstance(c["value"], float) and c["value"] <= c["limit"]
               for c in checks_.values())


def _meta(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
            for k, v in tensors.items()}


def serve_flops(cfg: dict, traffic: dict, weights) -> float:
    """FLOPs a video of the reference's forward at the cell's shapes (2 a
    multiply-add; every product, padding taps included), counted on the
    meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    b = traffic["batch"]
    tf = cfg.get("num_frames_focuser") or cfg["num_frames"]
    s, g, t = cfg["image_size"], cfg["glance_size"], cfg["num_frames"]
    d = cfg["video_div"] if cfg["continuous_policy"] else t
    with FlopCounterMode(display=False) as counter:
        reference(cfg).serve(_meta(weights), cfg,
                             torch.empty((b, tf, s, s, 3), device="meta"),
                             torch.empty((b, t, g, g, 3), device="meta"),
                             torch.empty((b, d, 2), device="meta"))
    return counter.get_total_flops() / b


def patch_bytes(cfg: dict, batch: int, elem: int = 2) -> float:
    """Bytes one extraction of a request must move: each patch element read
    once and written once, at the frames' element size."""
    tf = cfg.get("num_frames_focuser") or cfg["num_frames"]
    return 2.0 * batch * tf * cfg["patch_size"] ** 2 * 3 * elem


def train_flops(cfg: dict, traffic: dict, weights) -> float:
    """FLOPs a video of the reference's training step at the cell's shapes:
    the frozen glance's forward, the trained part's forward and backward
    (2 a multiply-add), counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    b, t = traffic["batch"], cfg["num_frames"]
    s, g = cfg["image_size"], cfg["glance_size"]
    batch = {"frames": torch.empty((b, t, s, s, 3), device="meta"),
             "frames_small": torch.empty((b, t, g, g, 3), device="meta"),
             "labels": torch.empty((b,), dtype=torch.long, device="meta"),
             "actions": torch.empty((b, t, 2), device="meta")}
    with FlopCounterMode(display=False) as counter:
        reference(cfg).stage1_steps(_meta(weights), cfg, traffic["optim"], [batch])
    return counter.get_total_flops() / b


def int8_units(cfg: dict, batch: int):
    """(bytes, operations) of each int8 product of one int8 forward at the
    cell's shapes: every conv-BatchNorm unit of both backbones but the two
    stems (which stay bf16). Bytes: the int8 input and weights read once,
    the output written once as int8, whatever format an implementation
    writes; operations: 2 a multiply-add."""
    from perfbench.reference.nets import mbv2_blocks, resnet50_blocks

    units = []

    def unit(n, h, cin, cout, k=1, stride=1, groups=1):
        ho = (h - 1) // stride + 1
        units.append((n * h * h * cin + cout * cin // groups * k * k + n * ho * ho * cout,
                      2 * n * ho * ho * cout * cin // groups * k * k))
        return ho

    n = batch * cfg["num_frames"]
    h = (cfg["glance_size"] - 1) // 2 + 1
    for _, cin, hidden, cout, stride, expand, _ in mbv2_blocks():
        if expand:
            unit(n, h, cin, hidden)
        h = unit(n, h, hidden, hidden, 3, stride, hidden)
        unit(n, h, hidden, cout)
    unit(n, h, 320, 1280)
    n = batch * (cfg.get("num_frames_focuser") or cfg["num_frames"])
    h = ((cfg["patch_size"] - 1) // 2 + 1 - 1) // 2 + 1
    for _, cin, inner, cout, stride, down in resnet50_blocks():
        unit(n, h, cin, inner)
        ho = unit(n, h, inner, inner, 3, stride)
        unit(n, ho, inner, cout)
        if down:
            unit(n, h, cin, cout, 1, stride)
        h = ho
    return units


def int8_bound_us(cfg: dict, batch: int) -> float:
    """The least time the card could take for one forward's int8 products:
    the sum over units of max(bytes / bandwidth, operations / int8 peak)."""
    return sum(max(b / peaks.BYTES_PER_S, o / peaks.FLOPS["int8"])
               for b, o in int8_units(cfg, batch)) * 1e6
