"""Serving artifacts of the deployment forward (counterpart of
adafocus_tpu/serving.py), through ``torch.export``.

The greedy deployment forward of any of the three families (ActivityNet's
GRU head, sth-sth's consensus head, AdaFocus+), in mode ``bf16`` (the
model's own dtype) or ``int8`` (the PTQ forward of
``models/quant_inference.py``), exports to a ``torch.export``
``ExportedProgram``: one graph of ATen ops and the port's custom ops
(``adafocus_torch::extract_patches_at``, ``adafocus_torch::int8_conv``,
``adafocus_torch::int8_dwconv``), with the weights it reads as its state.
Saved to a ``.pt2`` file, it runs with no model code: ``load_exported``
imports only the modules that register those ops (``ops.patch``,
``ops.quant``), and on the card the reloaded program launches the
hand-written kernels.

The artifact is a callable ``(frames, frames_small) -> per-step logits``
at one fixed batch (static shapes: export one artifact per served batch
size, as the JAX package does). Its inputs are the port's: unpadded
``frames`` (B, Tf, S, S, 3) and ``frames_small`` (B, T, g, g, 3) in the
model's dtype, as ``benchmark.make_data`` makes them; JAX's lane-padded
``frames_flat`` is a constraint of its TPU kernel that the port does not
have. An ``ExportedProgram`` holds its weights on one device: the artifact
serves on the device the model was on when it was exported (the GPU unless
the model was built with ``device="cpu"``), where JAX lowers one program
for several platforms.

The program's state is the tensors the forward reads and nothing else:
``_Serving`` records them in one batch-1 forward and holds them as
buffers. An int8 artifact carries the prepared int8 weights of
``prepare_q8`` (packed for the kernels, with their rescales) and the
activation scales, and no float copy of a weight it runs in int8.

Usage::

    ep = export_inference(model, batch_size=64)     # mode="int8", scales=...
    save_exported(ep, "model.pt2")
    fn = load_exported("model.pt2")                 # no model code needed
    logits = fn(frames, frames_small)
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch._ops import HigherOrderOperator
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

MODES = ("bf16", "int8")


def _family_inference(model, mode: str, scales=None, qw=None) -> Callable:
    """The family's greedy deployment forward in ``mode``:
    ``fn(frames, frames_small, scales, qw) -> logits``. bf16:
    ``benchmark.inference_fn`` (the library-conv path, ``fused="auto"``, as
    the JAX package exports); int8: ``quant_inference.family_q8`` on the
    prepared weights ``qw`` (``scales`` and ``qw`` are arguments so that
    the exported module passes its own buffers in)."""
    if mode == "int8":
        from adafocus_torch.models.quant_inference import family_q8

        forward = family_q8(model.cfg)
        return lambda frames, small, scales, qw: forward(model, scales, frames, small,
                                                         device=model.device, qw=qw)
    from adafocus_torch.benchmark import inference_fn

    forward = inference_fn(model)
    return lambda frames, small, scales, qw: forward(frames, small)


class _Reads(TorchDispatchMode):
    """Records which of ``tensors`` an op reads, by identity."""

    def __init__(self, tensors):
        super().__init__()
        self.ids = {id(t) for t in tensors}
        self.read = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.read.update(id(t) for t in pytree.tree_leaves((args, kwargs))
                         if id(t) in self.ids)
        return func(*args, **kwargs)


class _Adapter(nn.Module):
    """The model as a submodule and the forward as ``forward``, so that
    ``torch.func.functional_call`` can run the forward on other tensors."""

    def __init__(self, model, forward: Callable):
        super().__init__()
        self.model = model
        self.fn = forward

    def forward(self, frames, frames_small, tables):
        return self.fn(frames, frames_small, tables["scales"], tables["qw"])


def _buffer_name(path: str) -> str:
    return re.sub(r"\W+", "_", path).strip("_")


class _Serving(nn.Module):
    """The exported module: ``forward(frames, frames_small)`` runs the
    family's forward with every model tensor and every int8 table tensor
    that it reads replaced by a buffer of this module. The model itself is
    not a submodule, so a tensor the forward does not read (a float weight
    that runs in int8, a head the deployment forward skips) is no part of
    the program's state."""

    def __init__(self, model, forward: Callable, tables: dict, probe: tuple):
        super().__init__()
        self._adapter = [_Adapter(model, forward)]   # a list: not a submodule
        named = dict(model.named_parameters())
        named.update(model.named_buffers())
        with_path, self._spec = pytree.tree_flatten_with_path(tables)
        self._leaves = [leaf for _, leaf in with_path]
        candidates = list(named.values()) + [t for t in self._leaves
                                             if isinstance(t, torch.Tensor)]
        reads = _Reads(candidates)
        with reads:   # which tensors the forward reads does not depend on the data
            forward(*probe, tables["scales"], tables["qw"])
        self._model_names: Dict[str, str] = {}
        by_id: Dict[int, str] = {}
        for name, t in named.items():
            if id(t) in reads.read:
                by_id[id(t)] = self._model_names[name] = _buffer_name("model." + name)
                self.register_buffer(by_id[id(t)], t.detach())
        self._leaf_names = []
        for path, t in with_path:
            name = None
            if isinstance(t, torch.Tensor) and id(t) in reads.read:
                name = by_id.get(id(t))
                if name is None:   # an int8 table's tensor, once however often it is listed
                    by_id[id(t)] = name = _buffer_name(pytree.keystr(path))
                    self.register_buffer(name, t)
            self._leaf_names.append(name)

    def forward(self, frames: torch.Tensor, frames_small: torch.Tensor) -> torch.Tensor:
        tables = pytree.tree_unflatten(
            [leaf if name is None else getattr(self, name)
             for name, leaf in zip(self._leaf_names, self._leaves)], self._spec)
        state = {"model." + n: getattr(self, b) for n, b in self._model_names.items()}
        return torch.func.functional_call(self._adapter[0], state,
                                          (frames, frames_small, tables), strict=False)


def export_inference(model, batch_size: int, mode: str = "bf16",
                     scales: Optional[dict] = None) -> torch.export.ExportedProgram:
    """Export the deployment forward as a ``torch.export.ExportedProgram``.

    model: the GFV, its weights baked in as the program's state, on the
      device the artifact will serve on.
    batch_size: the served batch (one artifact per batch size).
    mode: 'bf16' (the model's dtype) | 'int8' (PTQ: pass the calibrated
      ``scales`` of ``models.quant_inference.calibrate_gfv``; the weights
      are prepared first, ``prepare_q8``, and the program carries them).
    The JAX package's ``seed`` only fed its rollout's key, and
    ``platforms`` its lowering targets: the port's greedy forward takes no
    key, and the program serves on the model's device, so neither has a
    counterpart.
    """
    from adafocus_torch.benchmark import make_data

    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: 'bf16' or 'int8'")
    if mode == "int8" and scales is None:
        raise ValueError("int8 export needs calibrated activation scales")
    qw = None
    if mode == "int8":
        from adafocus_torch.models.quant_inference import prepare_q8

        qw = prepare_q8(model, scales)
    forward = _family_inference(model, mode, scales, qw)
    probe = make_data(model.cfg, 1, device=model.device)
    module = _Serving(model, forward, {"scales": scales, "qw": qw},
                      (probe["frames"], probe["frames_small"]))
    data = make_data(model.cfg, batch_size, device=model.device)
    exported = torch.export.export(module, (data["frames"], data["frames_small"]), strict=False)
    _drop_empty_regions(exported.graph_module)
    # the program keeps its example inputs, and saves them with it: at B=64
    # the flagship's frames alone are 616 MB
    exported.example_inputs = None
    return exported


def _drop_empty_regions(gm: torch.fx.GraphModule) -> None:
    """Removes the calls of higher-order ops (the regions of
    ``wrap_with_autocast`` and ``wrap_with_set_grad_enabled``) that compute
    nothing and return nothing. ``torch.export`` cuts an autocast region at
    each grad-mode context inside it, so ``forward_plus``'s
    ``set_grad_enabled`` at the top of its autocast block leaves an empty
    region; the saved program drops that region's (empty) output metadata,
    and ``torch.export.load`` then rejects the program."""
    for mod in list(gm.modules()):
        if not isinstance(mod, torch.fx.GraphModule):
            continue
        dropped = False
        for node in list(mod.graph.nodes):
            if (node.op == "call_function" and isinstance(node.target, HigherOrderOperator)
                    and not node.users and node.meta.get("val") == ()):
                body = [a for a in node.args if isinstance(a, torch.fx.Node)]
                mod.graph.erase_node(node)
                for sub in body:
                    if sub.op == "get_attr" and not sub.users:
                        mod.graph.erase_node(sub)
                        delattr(mod, sub.target)
                dropped = True
        if dropped:
            mod.recompile()


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    torch.export.save(exported, path)


def load_exported(path: str) -> nn.Module:
    """Load a saved artifact: a module ``(frames, frames_small) ->
    logits``. Imports the modules that register the custom ops and nothing
    of the model code (``adafocus_torch.models``)."""
    from adafocus_torch.ops import patch, quant  # noqa: F401 (they register the ops)

    return torch.export.load(path).module()
