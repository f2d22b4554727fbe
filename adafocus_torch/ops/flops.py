"""FLOPs accounting (counterpart of adafocus_tpu/ops/flops.py): GFLOPs a
video is the reference's headline efficiency metric.

``flops`` runs a function once under ``torch.utils.flop_counter.
FlopCounterMode`` and returns what it counts: convolutions and matrix
products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions and
attention), 2 FLOPs a multiply-add, every tap of a convolution, those on
its zero padding included. Elementwise work, BatchNorm, pooling and
reductions count nothing. The JAX package's ``xla_flops`` takes XLA's cost
analysis of the whole compiled program instead: elementwise work too, but
not the taps on zero padding. On the tiny GFV forward
(``tests/torch_port_common.py TINY``, batch 2, float32) the port counts
1.4489 times JAX's count (tests/test_torch_port_tooling.py measures it); at
larger maps padding is a smaller share and the two come closer
(tests/test_torch_port_bench.py).
"""

from __future__ import annotations

from typing import Callable

from torch.utils.flop_counter import FlopCounterMode


def flops(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of one call ``fn(*args, **kwargs)``, as counted above."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def gflops_per_video(fn: Callable, batch_size: int, *args) -> float:
    """GFLOPs a video for a batched function (``batch_size`` videos a call)."""
    return flops(fn, *args) / batch_size / 1e9
