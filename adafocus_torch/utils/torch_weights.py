"""torchvision / TSM state dicts -> the port's backbones (counterpart of
adafocus_tpu/utils/torch_weights.py).

The reference seeds its backbones from torchvision's and TSM's ImageNet
checkpoints. The port's modules are NCHW, as torchvision's are, so a
state dict maps onto ``models/resnet.py`` and ``models/mobilenet.py`` by
renaming keys only; no tensor is transposed:

  * torchvision ResNet-18/34/50/101: ``conv1``/``bn1`` -> ``stem.conv``/
    ``stem.bn``; ``layer{s}.{j}.conv{c}``/``bn{c}`` ->
    ``layer{s}_{j}.conv{c}.conv``/``.bn``; ``downsample.0``/``.1`` ->
    ``down.conv``/``.bn``; ``fc`` -> ``fc``;
  * torchvision MobileNetV2: ``features.0`` -> ``stem``, ``features.{k}``
    -> ``block_{i}_{j}`` (``expand``, ``dw``, ``project``), the last
    ``features`` entry -> ``head_conv``, ``classifier.1`` -> ``classifier``;
  * the tonylins MobileNetV2 layout of the TSM checkpoints, first renamed
    to torchvision's by the reference's index arithmetic (``_tonylins_to_tv``).

``module.`` prefixes (DataParallel) are stripped. Tensors become float32
CPU tensors; a BatchNorm's ``num_batches_tracked`` is carried where the
dict has one, else 0, as the weight bridge sets it.

``python -m adafocus_torch.utils.torch_weights ckpt.pth out_dir --arch
resnet50`` writes ``out_dir/checkpoint.pt`` in the port's checkpoint
format with the converted backbone as one component (``focuser`` for a
ResNet, ``glancer`` for MobileNetV2); ``run.warm_start=out_dir`` loads it
through ``train.checkpoint.load_stage_components``, where a tensor whose
shape disagrees with the fresh model's (an ImageNet head at another class
count) keeps its fresh value, as ``merge_into`` does.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from adafocus_torch.train.checkpoint import FILES, _atomic_save, _merge_compatible

_RESNET_STAGES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                  101: (3, 4, 23, 3)}
_MBV2_BLOCKS = (1, 2, 3, 4, 3, 3, 1)  # n per cfg row
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
_WRAPPERS = ("state_dict", "model_state_dict", "model")
ARCHS = ("resnet18", "resnet34", "resnet50", "resnet101", "mobilenet_v2")


def _tensor(v) -> torch.Tensor:
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v))
    return v.detach().to("cpu", torch.float32).clone()


def _convbn(sd: Mapping, out: Dict[str, torch.Tensor], dst: str, conv_key: str,
            bn_key: str) -> None:
    out[f"{dst}.conv.weight"] = _tensor(sd[f"{conv_key}.weight"])
    for leaf in _BN_LEAVES:
        out[f"{dst}.bn.{leaf}"] = _tensor(sd[f"{bn_key}.{leaf}"])
    count = sd.get(f"{bn_key}.num_batches_tracked", 0)
    out[f"{dst}.bn.num_batches_tracked"] = torch.as_tensor(count, dtype=torch.int64).clone()


def _dense(sd: Mapping, out: Dict[str, torch.Tensor], dst: str, key: str) -> None:
    out[f"{dst}.weight"] = _tensor(sd[f"{key}.weight"])
    out[f"{dst}.bias"] = _tensor(sd[f"{key}.bias"])


def _strip_module(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    return {k.replace("module.", ""): v for k, v in state_dict.items()}


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------


def convert_resnet(state_dict: Mapping[str, Any], depth: int = 50,
                   with_fc: bool = True) -> Dict[str, torch.Tensor]:
    """torchvision ResNet state dict -> the state dict of the port's
    ``ResNet`` of that depth (``models/resnet.py``)."""
    sd = _strip_module(state_dict)
    n_convs = 2 if depth < 50 else 3
    out: Dict[str, torch.Tensor] = {}
    _convbn(sd, out, "stem", "conv1", "bn1")
    for stage, n_blocks in enumerate(_RESNET_STAGES[depth]):
        for j in range(n_blocks):
            name = f"layer{stage + 1}_{j}"
            src = f"layer{stage + 1}.{j}"
            for c in range(1, n_convs + 1):
                _convbn(sd, out, f"{name}.conv{c}", f"{src}.conv{c}", f"{src}.bn{c}")
            if f"{src}.downsample.0.weight" in sd:
                _convbn(sd, out, f"{name}.down", f"{src}.downsample.0",
                        f"{src}.downsample.1")
    if with_fc and "fc.weight" in sd:
        _dense(sd, out, "fc", "fc")
    return out


# ---------------------------------------------------------------------------
# MobileNetV2
# ---------------------------------------------------------------------------


def _is_tonylins(sd: Mapping[str, Any]) -> bool:
    """tonylins layout flattens ConvBNReLU into conv.{0..8} and names the
    head 'classifier.weight' (no dropout wrapper index)."""
    return any(k.startswith("features.1.conv.3.") for k in sd) or \
        "classifier.weight" in sd


def _tonylins_to_tv(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Normalize tonylins key layout to torchvision's (the same mapping the
    reference applies in get_mobv2_new_sd, sthsth/ops/utils.py:239-290)."""
    out = {}
    for k, v in sd.items():
        nk = k
        if k.startswith("features.1.conv."):
            # t=1 block: tonylins conv.{0,1,3,4} = dw conv, dw bn, proj conv,
            # proj bn -> torchvision conv.{0.0,0.1,1,2}
            idx = int(k.split(".")[3])
            rest = k.split(".", 4)[4]
            sub = {0: "conv.0.0", 1: "conv.0.1", 3: "conv.1", 4: "conv.2"}[idx]
            nk = f"features.1.{sub}.{rest}"
        elif k.startswith("features.") and ".conv." in k:
            parts = k.split(".")
            if parts[1].isdigit() and int(parts[1]) >= 2 and parts[2] == "conv":
                idx = int(parts[3])
                rest = ".".join(parts[4:])
                sub = {0: "conv.0.0", 1: "conv.0.1", 3: "conv.1.0",
                       4: "conv.1.1", 6: "conv.2", 7: "conv.3"}[idx]
                nk = f"features.{parts[1]}.{sub}.{rest}"
        elif k.startswith("classifier."):
            nk = k.replace("classifier.", "classifier.1.")
        out[nk] = v
    return out


def convert_mobilenet_v2(state_dict: Mapping[str, Any],
                         with_classifier: bool = True) -> Dict[str, torch.Tensor]:
    """torchvision (or tonylins) MobileNetV2 state dict -> the state dict of
    the port's ``MobileNetV2`` (``models/mobilenet.py``)."""
    sd = _strip_module(state_dict)
    if _is_tonylins(sd):
        sd = _tonylins_to_tv(sd)
    out: Dict[str, torch.Tensor] = {}
    _convbn(sd, out, "stem", "features.0.0", "features.0.1")
    feat_idx = 1
    for i, n in enumerate(_MBV2_BLOCKS):
        for j in range(n):
            name = f"block_{i}_{j}"
            src = f"features.{feat_idx}"
            if f"{src}.conv.0.0.weight" in sd and f"{src}.conv.1.0.weight" in sd:
                # expanded block: conv.0=expand, conv.1=dw, conv.2/3=project
                _convbn(sd, out, f"{name}.expand", f"{src}.conv.0.0", f"{src}.conv.0.1")
                _convbn(sd, out, f"{name}.dw", f"{src}.conv.1.0", f"{src}.conv.1.1")
                _convbn(sd, out, f"{name}.project", f"{src}.conv.2", f"{src}.conv.3")
            else:
                # t=1 block: conv.0=dw, conv.1/2=project
                _convbn(sd, out, f"{name}.dw", f"{src}.conv.0.0", f"{src}.conv.0.1")
                _convbn(sd, out, f"{name}.project", f"{src}.conv.1", f"{src}.conv.2")
            feat_idx += 1
    _convbn(sd, out, "head_conv", f"features.{feat_idx}.0", f"features.{feat_idx}.1")
    if with_classifier and "classifier.1.weight" in sd:
        _dense(sd, out, "classifier", "classifier.1")
    return out


def merge_into(model, component: str, converted: Mapping[str, torch.Tensor]) -> List[str]:
    """Load converted backbone weights into ``model.<component>`` ('glancer'
    | 'focuser'), in place, the other components untouched. A tensor whose
    shape disagrees with the module's (an ImageNet head at another class
    count) keeps its value, the reference's strict=False component loads.
    Returns the keys of the module that kept their value."""
    module = getattr(model, component)
    fresh = module.state_dict()
    module.load_state_dict(_merge_compatible(fresh, converted))
    return [k for k, v in fresh.items()
            if k not in converted or converted[k].shape != v.shape]


def convert_checkpoint(path: str, arch: str) -> Dict[str, torch.Tensor]:
    """The converted state dict of the ``arch`` checkpoint at ``path``: a
    ``.pth`` / ``.pth.tar`` state dict, unwrapped from ``state_dict``,
    ``model_state_dict`` or ``model`` where a training checkpoint holds it.
    Read with ``weights_only=True``: tensors and plain values only."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in _WRAPPERS:
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    if arch == "mobilenet_v2":
        return convert_mobilenet_v2(sd)
    return convert_resnet(sd, depth=int(arch[len("resnet"):]))


def convert_checkpoint_cli(argv=None) -> str:
    """CLI: convert a torch backbone checkpoint into a warm-startable
    component checkpoint.

    Usage: ``python -m adafocus_torch.utils.torch_weights ckpt.pth out_dir
    --arch resnet50 [--component focuser]``. The output directory is
    loadable with ``run.warm_start=out_dir`` (only the converted component
    is grafted; everything else keeps its fresh initialisation). Returns
    the path written.
    """
    import argparse

    ap = argparse.ArgumentParser(description=convert_checkpoint_cli.__doc__)
    ap.add_argument("ckpt", help="torch .pth/.pth.tar state dict")
    ap.add_argument("out_dir")
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--component", default=None,
                    help="GFV component name (default: focuser for resnets, "
                         "glancer for mobilenet)")
    args = ap.parse_args(argv)
    converted = convert_checkpoint(args.ckpt, args.arch)
    component = args.component or ("glancer" if args.arch == "mobilenet_v2" else "focuser")
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, FILES[False])
    _atomic_save({"components": {component: converted},
                  "meta": {"epoch": 0, "acc": 0.0, "best_acc": 0.0, "arch": args.arch,
                           "converted_from": os.path.abspath(args.ckpt)}}, path)
    stats = ("running_mean", "running_var", "num_batches_tracked")
    n = sum(v.numel() for k, v in converted.items() if k.rpartition(".")[2] not in stats)
    print(f"converted {args.arch} -> {path} (component '{component}', {n:,} params)")
    return path


if __name__ == "__main__":
    convert_checkpoint_cli()
