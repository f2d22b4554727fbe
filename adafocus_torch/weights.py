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

The caller converts the flax trees to numpy first (``jax.tree.map(np.asarray,
...)``), so nothing here imports JAX. Every leaf is carried, the heads that
inference does not use included; a leaf name the bridge does not know
raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

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
