"""The program under test, reached at its public entries: a model of a
configuration with the benchmark's weights loaded, and the entry named in
the configuration file (``module:function``)."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64}


def entry(path: str) -> Callable:
    module, _, name = path.partition(":")
    return getattr(importlib.import_module(module), name)


def gfv_config(cfg: dict):
    """The program's ``GFVConfig`` of a configuration file."""
    from adafocus_torch.models.gfv import GFVConfig

    fields = {f.name for f in dataclasses.fields(GFVConfig)}
    return GFVConfig(**{k: (DTYPES[v] if k == "dtype" else v) for k, v in cfg.items()
                        if k in fields})


def model(cfg: dict, weights: Dict[str, torch.Tensor], device,
          param_dtype: torch.dtype = None):
    """The program's model of ``cfg`` on ``device`` holding ``weights``
    (built on the meta device, so that nothing is drawn twice, then loaded
    strictly: every tensor the program has is one the benchmark made)."""
    from adafocus_torch.models.gfv import GFV

    with torch.device("meta"):
        net = GFV(gfv_config(cfg), device="meta", param_dtype=param_dtype)
    net = net.to_empty(device=device)
    net.load_state_dict(weights, strict=True)
    return net
