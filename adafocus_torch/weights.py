"""Weight bridge: the flax trees of a whole GFV -> the port's ``state_dict``.

The port's modules carry the flax submodule names, so a flax path maps to a
state-dict key by joining its parts with dots and renaming the leaf:

  conv kernel (kh, kw, in, out)  -> ``weight`` (out, in, kh, kw); a depthwise
                                    (3, 3, 1, C) kernel becomes (C, 1, 3, 3)
  Dense kernel (in, out)         -> ``weight`` (out, in)
  GRU wi / wh (in, 3H)           -> ``weight_ih`` / ``weight_hh`` (3H, in)
  GRU bi / bh                    -> ``bias_ih`` / ``bias_hh``
  BatchNorm scale / bias         -> ``weight`` / ``bias``
  BatchNorm mean / var (stats)   -> ``running_mean`` / ``running_var``
                                    (plus ``num_batches_tracked`` = 0)

A sth-sth tree crosses the same way: the encoder's ``proj`` kernel has no
bias there, its ``bn`` takes scale, bias and running statistics, the actor
is 2 wide, and the consensus head is ``classifier/fc``. So do AdaFocus+'s
``selector`` (``gru``, ``score``) and ``selector_ac`` (``gru``,
``key_proj``, ``query_proj``, ``score``, ``critic``), the linear head
(``classifier/fc``) and the MLP state encoder (``encoder/fc`` alone).

The caller converts the flax trees to numpy first (``jax.tree.map(np.asarray,
...)``), so nothing here imports JAX. Every leaf is carried, the heads that
inference does not use included; a leaf name the bridge does not know
raises.

``ppo_state_from_flax`` carries a stage-2 learner's Adam moments and counts
the same way, so that a stage-2 run continues from a JAX state, and
``quant_scales_from_jax`` the int8 activation scales of JAX's
``calibrate_gfv``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from adafocus_torch.ppo.core import PPOState

_RENAME = {"bi": "bias_ih", "bh": "bias_hh", "bias": "bias",
           "scale": "weight", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _convert_leaf(path: tuple, value: np.ndarray):
    *mods, leaf = path
    if leaf == "kernel":
        if value.ndim == 4:
            return mods + ["weight"], value.transpose(3, 2, 0, 1)
        if value.ndim == 2:
            return mods + ["weight"], value.T
        raise ValueError(f"{'/'.join(path)}: kernel of rank {value.ndim}")
    if leaf in ("wi", "wh"):
        return mods + ["weight_ih" if leaf == "wi" else "weight_hh"], value.T
    if leaf in _RENAME:
        return mods + [_RENAME[leaf]], value
    raise KeyError(f"flax leaf {'/'.join(path)} has no counterpart in the port")


def gfv_state_dict_from_flax(params: Mapping, batch_stats: Mapping,
                             dtype: torch.dtype = torch.float32
                             ) -> Dict[str, torch.Tensor]:
    """Flax ``params`` and ``batch_stats`` of a GFV (nested dicts of numpy
    arrays) -> the port's ``GFV`` state dict (CPU tensors in ``dtype``)."""
    sd: Dict[str, torch.Tensor] = {}
    for collection in (params, batch_stats):
        for path, value in _flatten(collection).items():
            mods, value = _convert_leaf(path, value)
            key = ".".join(mods)
            if key in sd:
                raise KeyError(f"two flax leaves map to {key}")
            sd[key] = torch.tensor(value, dtype=dtype)
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def ppo_state_from_flax(flax_ppo: Any, ppo: PPOState) -> None:
    """A JAX ``PPOState`` (numpy leaves) -> the port's learner ``ppo``, in
    place: the moments ``mu`` / ``nu`` and the count of its ``optax.adam``
    state become each policy parameter's ``exp_avg`` / ``exp_avg_sq`` and
    ``step`` in ``ppo.optimizer``, and its step count ``ppo.step``. The
    policy's weights cross with ``gfv_state_dict_from_flax``. AdaFocus+'s
    joint learner (``{"policy", "selector_ac"}`` in JAX, the port's
    ``train.stages.joint_learner`` ``ModuleDict``) crosses the same way: its
    parameter names carry the two prefixes."""
    adam = flax_ppo.opt_state[0]
    params = dict(ppo.policy.named_parameters())
    moments = {}
    for name, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for path, value in _flatten(tree).items():
            mods, value = _convert_leaf(path, value)
            key = ".".join(mods)
            if key not in params:
                raise KeyError(f"Adam moment {'/'.join(path)} has no policy parameter")
            moments.setdefault(key, {})[name] = torch.tensor(
                value, dtype=params[key].dtype, device=params[key].device)
    if moments.keys() != params.keys():
        raise KeyError(f"no Adam moments for {sorted(params.keys() - moments.keys())}")
    count = torch.tensor(float(adam.count), dtype=torch.float32)
    for key, p in params.items():
        ppo.optimizer.state[p] = {"step": count.clone(), **moments[key]}
    ppo.step = int(flax_ppo.step)


def quant_scales_from_jax(scales: Mapping, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's ``calibrate_gfv`` output as numpy arrays ({'glancer':
    {unit: ()}, 'focuser': {unit: ()}, optionally 'heads': {point: (C,)}})
    -> the port's scales: float32 tensors on ``device`` under the same names
    (the unit and point names, ``block_3_1/dw``, ``layer2_0/conv2``,
    ``cls/gru/h``, are the same strings in both packages)."""
    return {group: {name: torch.tensor(np.asarray(v, np.float32), device=device)
                    for name, v in sub.items()}
            for group, sub in scales.items()}

