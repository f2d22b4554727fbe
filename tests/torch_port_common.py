"""Shared set-up of the port's parity tests (tests/test_torch_port_*.py).

A JAX GFV's variables take the structure of ``create_train_state``'s from
``jax.eval_shape`` and their values from a seeded numpy generator
(``abstract_variables``: no jitted init, which costs tens of seconds of
XLA:CPU compile a configuration); every BatchNorm gets random scale, bias
and running statistics (fresh ones are trivially 1/0/0/1 and would hide a
swapped or dropped leaf), and the same trees feed both the flax modules and,
through the weight bridge, the port.

Tests that write checkpoints, cases or artifacts take ``scratch_path``
(module fixtures ``removed_after``): pytest keeps the temporary directories
of its last three runs, and a run's ~190 MB checkpoints would otherwise
stay on the disk after it.
"""

import contextlib
import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from adafocus_torch.models import gfv as tgfv
from adafocus_torch.models.gru import GRUCell
from adafocus_torch.weights import gfv_state_dict_from_flax
from adafocus_tpu.models.gfv import GFV, GFVConfig
from adafocus_tpu.ops.patch import pad_for_extraction
from adafocus_tpu.train.stages import TrainState

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

# the train steps' configuration: TINY's widths at 48^2 frames, 32^2 glance
# and 32^2 patches, batch 4, so that train-mode BatchNorm normalises over 8
# values a channel at the backbones' last (1x1) maps, where TINY has 4. In
# float32 the two packages' gradients of this random network differ far
# beyond float32 rounding on some focuser tensors after one step (rounding
# amplified through the train-mode BatchNorm backward), while in float64
# they agree, so the train steps are compared in float64.
TRAIN_CFG = dataclasses.replace(TINY, image_size=48, glance_size=32, patch_size=32)
TRAIN_B = 4


@contextlib.contextmanager
def removed_after(path):
    """``path``, removed with everything in it when the block ends, whether
    it ended well or raised."""
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture
def scratch_path(tmp_path):
    """``tmp_path``, removed after the test whether it passed or failed."""
    with removed_after(tmp_path):
        yield tmp_path


def _map_tree(fn, tree, path=()):
    return {k: _map_tree(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _variable_shapes(cfg: GFVConfig) -> dict:
    """``GFV(cfg).init``'s variables as shapes, from ``jax.eval_shape``
    (a trace of the whole model, seconds: once a configuration)."""
    key = jax.random.key(0)
    return unfreeze(jax.eval_shape(
        GFV(cfg).init, {"params": key},
        jnp.zeros((1, cfg.num_frames, cfg.glance_size, cfg.glance_size, 3), cfg.dtype),
        jnp.zeros((cfg.t_focuser, cfg.patch_size, cfg.patch_size, 3), cfg.dtype), key))


def abstract_variables(cfg: GFVConfig, seed: int = 0):
    """(flax GFV, {'params', 'batch_stats'} as numpy trees) with the
    structure of ``create_train_state``'s, from ``jax.eval_shape`` (nothing
    compiled: a jitted init of the full-depth backbones costs tens of
    seconds on the CPU) and values from a seeded generator: kernels normal
    of variance 1 / fan-in, GRU weights and biases uniform in +-1/sqrt(H),
    other biases uniform in +-0.1; BatchNorm scale, bias and statistics as
    ``randomize_bn`` draws them, every BatchNorm's."""
    model = GFV(cfg)
    shapes = _variable_shapes(cfg)
    rs = np.random.RandomState(seed)
    dtype = np.dtype(cfg.dtype)
    ranges = {"scale": (0.5, 1.5), "mean": (-0.5, 0.5), "var": (0.5, 1.5)}

    def fill(path, s):
        name, shape = path[-1], s.shape
        if name == "kernel":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("wi", "wh", "bi", "bh"):
            k = 1.0 / np.sqrt(shape[-1] // 3)
            v = rs.uniform(-k, k, shape)
        elif name in ranges:
            v = rs.uniform(*ranges[name], shape)
        elif name == "bias":
            bn = len(path) >= 2 and path[-2].startswith("bn")
            v = rs.uniform(-0.5, 0.5, shape) if bn else rs.uniform(-0.1, 0.1, shape)
        else:
            raise KeyError(f"no filler for {'/'.join(path)}")
        return v.astype(dtype)

    return model, {"params": _map_tree(fill, shapes["params"]),
                   "batch_stats": _map_tree(fill, shapes.get("batch_stats", {}))}


def fresh_bn(tree, in_bn=False):
    """``tree`` with every BatchNorm as flax's init makes it: scale and
    variance 1, bias and mean 0."""
    fresh = {"scale": 1.0, "var": 1.0, "bias": 0.0, "mean": 0.0}
    return {k: fresh_bn(v, k.startswith("bn")) if isinstance(v, dict)
            else np.full_like(v, fresh[k]) if in_bn and k in fresh else v
            for k, v in tree.items()}


def abstract_state(model: GFV, rng=None, tx=None, ppo_cfg=None,
                   batch_size: int = 2) -> TrainState:
    """A stand-in for the JAX package's ``create_train_state`` (its
    signature; ``rng`` and ``batch_size`` change nothing it returns), with
    the variables from ``abstract_variables`` and every BatchNorm fresh, as
    the package's init leaves them: nothing compiled but ``tx.init``, where
    the package's jitted init of the full-depth backbones costs tens of
    seconds a configuration on the CPU. No PPO state (stage 2)."""
    if ppo_cfg is not None:
        raise NotImplementedError("abstract_state makes no PPO state")
    _, variables = abstract_variables(model.cfg)
    params, stats = (jax.tree.map(jnp.asarray, fresh_bn(variables[k]))
                     for k in ("params", "batch_stats"))
    return TrainState(params=params, batch_stats=stats,
                      opt_state=None if tx is None else jax.jit(tx.init)(params),
                      step=jnp.zeros((), jnp.int32))


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


@contextlib.contextmanager
def no_init():
    """Builds the port's modules without drawing their initial weights (each
    ``reset_parameters`` a no-op), for a model whose every weight is loaded
    right after (``load_state_dict``, strict): a GFV's draws take about 2 s
    on the CPU, its build without them 0.1 s."""
    with pytest.MonkeyPatch.context() as mp:
        for cls in (torch.nn.Linear, torch.nn.modules.conv._ConvNd, GRUCell, tgfv.GFV):
            mp.setattr(cls, "reset_parameters", lambda self, *a, **k: None)
        yield


def port_model(cfg: GFVConfig, variables) -> tgfv.GFV:
    """The port's GFV on the CPU, loaded through the weight bridge."""
    with no_init():
        model = tgfv.GFV(port_config(cfg), device="cpu")
    model.load_state_dict(gfv_state_dict_from_flax(
        variables["params"], variables["batch_stats"]))
    return model


def train_batch(cfg: GFVConfig, b: int, seed: int, dtype=np.float32):
    """The same random inputs as a JAX batch (frames padded for its
    extraction) and as the port's."""
    rs = np.random.RandomState(seed)
    t, s, g = cfg.num_frames, cfg.image_size, cfg.glance_size
    frames = rs.randn(b, t, s, s, 3).astype(dtype)
    small = rs.randn(b, t, g, g, 3).astype(dtype)
    labels = rs.randint(0, cfg.num_classes, b).astype(np.int32)
    flat = pad_for_extraction(jnp.asarray(frames.reshape(b * t, s, s, 3)))
    jbatch = {"frames_flat": flat.reshape((b, t) + flat.shape[1:]),
              "frames_small": jnp.asarray(small), "labels": jnp.asarray(labels)}
    tbatch = {"frames": torch.from_numpy(frames), "frames_small": torch.from_numpy(small),
              "labels": torch.from_numpy(labels).long()}
    return jbatch, tbatch


def state_dict_from_jax(variables, dtype=torch.float32):
    """The port's state dict of flax {'params', 'batch_stats'} (any leaves)."""
    return gfv_state_dict_from_flax(jax.tree.map(np.asarray, variables["params"]),
                                    jax.tree.map(np.asarray, variables["batch_stats"]), dtype)


def snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def float64_train_setup(seed: int, variables_of=abstract_variables):
    """The float64 JAX GFV at TRAIN_CFG, its variables (``variables_of``)
    as float64 numpy trees and a float64 batch of TRAIN_B (JAX's and the port's)."""
    with jax.enable_x64(True):
        cfg = dataclasses.replace(TRAIN_CFG, dtype=jnp.float64)
        jmodel, variables = variables_of(cfg, seed=seed)
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        return (cfg, jmodel, variables) + train_batch(cfg, TRAIN_B, seed + 1, np.float64)


def port_model64(cfg: GFVConfig, variables) -> tgfv.GFV:
    """The port's float64 GFV on the CPU with the bridged ``variables``."""
    with no_init():
        model = tgfv.GFV(dataclasses.replace(port_config(cfg), dtype=torch.float64),
                         device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, torch.float64))
    return model
