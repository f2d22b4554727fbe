"""Experiment configuration: nested dataclasses + YAML + CLI overrides
(counterpart of adafocus_tpu/config.py).

A typed ``ExperimentConfig`` tree over the port's ``GFVConfig``,
``OptimConfig``, ``PPOConfig``, ``LoaderConfig`` and ``AugmentConfig``,
loadable from the JAX package's YAML files unchanged
(``configs/actnet_default.yaml``), overridable with ``section.key=value``
arguments and echoed at start-up. ``model.dtype=bfloat16|float32`` maps to
torch dtypes. Every model key of the JAX package is a field here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Sequence

import torch

from adafocus_torch.data.pipeline import LoaderConfig
from adafocus_torch.data.transforms import AugmentConfig
from adafocus_torch.models.gfv import GFVConfig
from adafocus_torch.ppo.core import PPOConfig
from adafocus_torch.train.optim import OptimConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Run-level knobs (the reference's trainer flags); the JAX package's
    fields, so that its YAML files and override lines load unchanged."""

    family: str = "actnet"        # 'actnet' | 'sthsth'
    stage: int = 1                # 0..3; eval uses the eval entry
    dataset: str = "actnet"
    data_root: str = ""
    synthetic_data: bool = False  # procedural frames (no dataset on disk)
    synthetic_videos: int = 64
    epochs: int = 50
    eval_freq: int = 1
    ckpt_dir: str = "checkpoints"
    resume: str = ""              # ckpt dir to fully resume from
    warm_start: str = ""          # previous stage's ckpt dir
    seed: int = 1007
    log_file: str = "training.log"
    print_freq: int = 20
    platform: str = ""            # '' or 'cuda' = the GPU; 'cpu' = the CPU
    host_devices: int = 0         # multi-device (item 12)
    anytime_eval: bool = False    # report per-timestep mAP (GRU head only)
    multihost: bool = False       # multi-host (item 12)
    coordinator: str = ""
    num_processes: int = 0
    process_id: int = -1
    visualize_patches: int = 0    # >0: save a patch grid of N videos at eval
    eval_policy: str = "learned"  # evaluate CLI: 'learned' | 'random' |
                                  # 'center' | 'oracle' (needs oracle_gt)
    oracle_gt: str = ""           # gt.npz with per-video target tracks
    quantize: str = ""            # 'int8': the int8 serving eval (models/quant_inference.py)
    quantize_batches: int = 4
    quantize_heads: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    run: RunConfig = RunConfig()
    model: GFVConfig = GFVConfig()
    optim: OptimConfig = OptimConfig()
    ppo: PPOConfig = PPOConfig()
    loader: LoaderConfig = LoaderConfig()
    augment: AugmentConfig = AugmentConfig()


def _coerce(value: str, target: Any) -> Any:
    """Parse a CLI string against the current field value's type."""
    if isinstance(target, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(target, int):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, tuple):
        parts = [p for p in value.strip("()[]").split(",") if p]
        elem = target[0] if target else 0
        return tuple(_coerce(p.strip(), elem) for p in parts)
    if isinstance(target, torch.dtype):
        if value not in _DTYPES:
            raise ValueError(f"model.dtype must be one of {sorted(_DTYPES)}; got {value!r}")
        return _DTYPES[value]
    return value


def _replace_fields(cfg: ExperimentConfig, section: str, fields: Dict[str, Any]
                    ) -> ExperimentConfig:
    sub = getattr(cfg, section)
    kwargs = {}
    for k, v in fields.items():
        current = getattr(sub, k)
        if isinstance(v, str) and not isinstance(current, str):
            v = _coerce(v, current)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return dataclasses.replace(cfg, **{section: dataclasses.replace(sub, **kwargs)})


def apply_overrides(cfg: ExperimentConfig, overrides: Sequence[str]) -> ExperimentConfig:
    for ov in overrides:
        key, _, value = ov.partition("=")
        section, _, field = key.strip().partition(".")
        if not field:
            raise ValueError(f"override '{key}' must be section.key=value")
        cfg = _replace_fields(cfg, section, {field: value.strip()})
    return cfg


def load_config(
    yaml_path: Optional[str] = None, overrides: Sequence[str] = ()
) -> ExperimentConfig:
    cfg = ExperimentConfig()
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            tree = yaml.safe_load(f) or {}
        for section, fields in tree.items():
            cfg = _replace_fields(cfg, section, fields)
    cfg = apply_overrides(cfg, overrides)
    return sync_derived(cfg)


def sync_derived(cfg: ExperimentConfig) -> ExperimentConfig:
    """Keep cross-section invariants: loader segment counts and augment
    input size follow the model config; sth-sth disables flip (its labels
    name directions, 'pushing left to right')."""
    loader = dataclasses.replace(
        cfg.loader,
        num_segments=cfg.model.num_frames,
        num_segments_focuser=(cfg.model.num_frames_focuser
                              if cfg.model.num_frames_focuser else 0),
        seed=cfg.run.seed,
    )
    augment = dataclasses.replace(
        cfg.augment,
        input_size=cfg.model.image_size,
        flip=cfg.augment.flip and cfg.run.family != "sthsth",
    )
    return dataclasses.replace(cfg, loader=loader, augment=augment)


def echo(cfg: ExperimentConfig) -> str:
    """Resolved-config dump (the reference's start() banner)."""
    lines = ["=" * 12 + " experiment config " + "=" * 12]
    for f in dataclasses.fields(cfg):
        d = {k: (v if isinstance(v, (int, float, bool, str, tuple, list)) else str(v))
             for k, v in dataclasses.asdict(getattr(cfg, f.name)).items()}
        lines.append(f"[{f.name}] " + json.dumps(d))
    lines.append("=" * 43)
    return "\n".join(lines)
