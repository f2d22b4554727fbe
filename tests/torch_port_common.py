"""Shared set-up of the port's parity tests (tests/test_torch_port_*.py).

A JAX GFV is built in-process with ``create_train_state``; its trees go to
numpy, every BatchNorm gets random scale, bias and running statistics (fresh
ones are trivially 1/0/0/1 and would hide a swapped or dropped leaf), and
the same trees feed both the flax modules and, through the weight bridge,
the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.core import unfreeze

from adafocus_torch.models import gfv as tgfv
from adafocus_torch.weights import gfv_state_dict_from_flax
from adafocus_tpu.models.gfv import GFV, GFVConfig
from adafocus_tpu.train.stages import create_train_state

# JAX GFVConfig of the tiny model of __graft_entry__._flagship
TINY = GFVConfig(
    num_classes=10, num_frames=2, image_size=24, glance_size=16,
    patch_size=16, action_dim=4, hidden_dim=16, policy_hidden=16,
    dtype=jnp.float32,
)
# the flagship's widths (49 anchors, 200 classes, 1024-wide GRUs) at a small
# spatial size; a 64^2 glance gives a 2x2 glance map, so the policy's
# (h, w, c) flatten order matters
FLAGSHIP_WIDTH = GFVConfig(
    num_classes=200, num_frames=2, image_size=64, glance_size=64,
    patch_size=32, action_dim=49, hidden_dim=1024, policy_hidden=1024,
    dtype=jnp.float32,
)


def _map_tree(fn, tree, path=()):
    return {k: _map_tree(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def jax_variables(cfg: GFVConfig, seed: int = 0):
    """(flax GFV, {'params', 'batch_stats'} as numpy trees, BN randomised)."""
    model = GFV(cfg)
    state = create_train_state(model, jax.random.key(seed), batch_size=1)
    return model, randomize_bn(
        {"params": state.params, "batch_stats": state.batch_stats}, seed)


def randomize_bn(variables, seed: int):
    """Flax {'params', 'batch_stats'} -> numpy trees in which every
    BatchNorm scale, bias, mean and var is drawn uniformly from a seeded
    generator."""
    rs = np.random.RandomState(seed)
    ranges = {"scale": (0.5, 1.5), "bias": (-0.5, 0.5), "mean": (-0.5, 0.5),
              "var": (0.5, 1.5)}

    def randomize(path, v):
        v = np.array(v, np.float32)
        if len(path) >= 2 and path[-2] == "bn":
            lo, hi = ranges[path[-1]]
            v = rs.uniform(lo, hi, v.shape).astype(np.float32)
        return v

    params = _map_tree(randomize, unfreeze(variables["params"]))
    stats = _map_tree(randomize, unfreeze(variables["batch_stats"]))
    return {"params": params, "batch_stats": stats}


def port_config(cfg: GFVConfig) -> tgfv.GFVConfig:
    """The port's GFVConfig with the same sizes, float32."""
    names = {f.name for f in dataclasses.fields(tgfv.GFVConfig)} - {"dtype"}
    return tgfv.GFVConfig(**{n: getattr(cfg, n) for n in names},
                          dtype=torch.float32)


def port_model(cfg: GFVConfig, variables) -> tgfv.GFV:
    """The port's GFV on the CPU, loaded through the weight bridge."""
    model = tgfv.GFV(port_config(cfg), device="cpu")
    model.load_state_dict(gfv_state_dict_from_flax(
        variables["params"], variables["batch_stats"]))
    return model
