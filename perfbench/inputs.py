"""What a run makes from its seed, on the device, in a few large calls: the
weights (``weights``), the pool of input batches (``input_pool``), labels
and random patch actions (``labels``, ``uniform_actions``).

Each use of the seed draws from its own stream (``stream``), so that a
cell's weights do not change when another of its draws changes size.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List

import torch

from perfbench.reference.nets import param_specs


def stream(seed: int, purpose: str, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and ``purpose``."""
    digest = hashlib.sha256(f"{seed}/{purpose}".encode()).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest[:8], "little") >> 1)


def weights(cfg: dict, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every tensor of the model of ``cfg`` (``reference.nets.param_specs``),
    drawn from ``seed``: convolution and linear weights normal of variance
    1 / fan-in, truncated at 2 standard deviations; their biases zero; GRU
    tensors uniform in +-1/sqrt(hidden); BatchNorm scale 1 + 0.1 n, shift
    0.1 n, running mean 0.1 n, running variance uniform in [0.5, 1.5]
    (n standard normal). Weights in ``dtype``, BatchNorm tensors in float32
    at least."""
    specs = param_specs(cfg)
    gen = stream(seed, "weights", device)
    out: Dict[str, torch.Tensor] = {}
    by_kind: Dict[str, List[tuple]] = {}
    for name, shape, kind in specs:
        by_kind.setdefault(kind, []).append((name, shape))

    def split(flat: torch.Tensor, entries) -> None:
        for (name, shape), part in zip(entries, flat.split([math.prod(s) for _, s in entries])):
            out[name] = part.view(shape)

    def counts(entries):
        return torch.tensor([math.prod(s) for _, s in entries], device=device)

    lecun = by_kind.get("lecun", [])
    std = torch.tensor([1.0 / math.sqrt(math.prod(s[1:])) for _, s in lecun], device=device)
    flat = torch.randn(int(counts(lecun).sum()), generator=gen, device=device)
    split((flat.clamp_(-2.0, 2.0) * std.repeat_interleave(counts(lecun))).to(dtype), lecun)
    gru = by_kind.get("gru", [])
    bound = torch.tensor([1.0 / math.sqrt(s[0] // 3) for _, s in gru], device=device)
    flat = torch.rand(int(counts(gru).sum()), generator=gen, device=device) * 2.0 - 1.0
    split((flat * bound.repeat_interleave(counts(gru))).to(dtype), gru)
    zero = by_kind.get("zero", [])
    split(torch.zeros(int(counts(zero).sum()), device=device, dtype=dtype), zero)
    bn = {k: by_kind.get(k, []) for k in ("bn_weight", "bn_bias", "bn_mean", "bn_var")}
    n_bn = int(counts(bn["bn_weight"]).sum())
    wide = torch.promote_types(dtype, torch.float32)
    draws = (torch.randn(3, n_bn, generator=gen, device=device) * 0.1).to(wide)
    split(draws[0] + 1.0, bn["bn_weight"])
    split(draws[1], bn["bn_bias"])
    split(draws[2], bn["bn_mean"])
    split((torch.rand(n_bn, generator=gen, device=device) + 0.5).to(wide), bn["bn_var"])
    for name, _ in by_kind.get("count", []):
        out[name] = torch.zeros((), dtype=torch.long, device=device)
    return {name: out[name] for name, _, _ in specs}


def input_pool(cfg: dict, batch: int, pool: int, seed: int, device,
               dtype: torch.dtype, purpose: str = "inputs") -> List[Dict[str, torch.Tensor]]:
    """``pool`` distinct batches of ``batch`` videos, standard normal in
    ``dtype`` (the decoded, normalized frames they stand in for): ``frames``
    (B, Tf, S, S, 3), unpadded, at the focuser's frame count, and
    ``frames_small`` (B, T, g, g, 3); drawn from the stream ``purpose``."""
    gen = stream(seed, purpose, device)
    tf = cfg.get("num_frames_focuser") or cfg["num_frames"]
    s, g, t = cfg["image_size"], cfg["glance_size"], cfg["num_frames"]
    frames = torch.randn((pool * batch, tf, s, s, 3), generator=gen, device=device, dtype=dtype)
    small = torch.randn((pool * batch, t, g, g, 3), generator=gen, device=device, dtype=dtype)
    return [{"frames": f, "frames_small": sm}
            for f, sm in zip(frames.split(batch), small.split(batch))]


def labels(cfg: dict, n: int, seed: int, device) -> torch.Tensor:
    """(n,) labels uniform over the classes."""
    return torch.randint(0, cfg["num_classes"], (n,), generator=stream(seed, "labels", device),
                         device=device)


def uniform_actions(shape, seed: int, device) -> torch.Tensor:
    """(*shape, 2) patch actions uniform in [0, 1), float32."""
    return torch.rand(tuple(shape) + (2,), generator=stream(seed, "actions", device),
                      device=device)
