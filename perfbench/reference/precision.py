"""Lower precisions for the benchmark's control: the reference computed one
step below the precision a configuration states.

``int4``: every product's inputs rounded to 4-bit integers (-7..7) with a
per-tensor scale (the tensor's abs-max onto 7), the step below int8.

``fp8``: every product's inputs rounded to float8 e4m3 with a per-tensor
scale (the tensor's abs-max onto e4m3's largest finite value, 448), and,
in a backward, the gradient that reaches a product's input rounded to
float8 e5m2 with the same kind of scale (e5m2's largest, 57344): the
recipe of fp8 training on Hopper's tensor cores, simulated in float32.
"""

from __future__ import annotations

import torch

_E4M3_MAX, _E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, _E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(x)


def int4(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    return ((x.float() / scale).round().clamp(-7, 7) * scale).to(x.dtype)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


QUANTIZERS = {"float32": identity, "fp8": fp8, "int4": int4}
