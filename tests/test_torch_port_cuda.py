"""The fused-block CUDA kernels against their plain versions, on a GPU.

Every test here is marked ``cuda`` and skips where no GPU is visible: a
CUDA kernel has no CPU or interpret mode. The file imports nothing of JAX,
so it runs on a machine without it, past tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerance, max|kernel - plain| / max|plain|: 1e-4 in float32 (summation
order only, TF32 off) and 2e-2 in bf16 (a hidden value whose rounding flips
moves by one bf16 ulp).
"""

import pytest
import torch

from adafocus_torch.models import mobilenet as tmob
from adafocus_torch.models import resnet as tres
from adafocus_torch.ops import fused_blocks as tfb


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")


CUDA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cin,cout,stride,expand,size,use_res", [
    (8, 8, 1, 6, 16, True), (8, 12, 2, 6, 9, False), (16, 16, 1, 1, 13, False),
    (32, 16, 1, 1, 20, False), (24, 24, 1, 6, 12, False),
])
def test_cuda_inverted_residual_matches_reference(dtype, cin, cout, stride, expand,
                                                  size, use_res):
    _needs_gpu()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(cin + size)
    block = tmob.InvertedResidual(cin, cout, stride, expand)
    for prm in block.parameters():
        prm.data = torch.rand(prm.shape, generator=gen) - 0.5
    fold = tfb.fold_inv_residual(block.cuda(), dtype)
    x = torch.randn((5, size, size, cin), generator=gen).to("cuda", dtype)
    before = tfb.fused_inverted_residual.launches
    got = tfb.fused_inverted_residual(x, fold, stride, use_res)
    torch.cuda.synchronize()
    assert tfb.fused_inverted_residual.launches == before + 1
    want = tfb.fused_inverted_residual_reference(x, fold, stride, use_res)
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel_err(got, want) <= CUDA_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("stride,downsample,size,use_res", [
    (1, True, 8, True), (1, False, 8, True), (2, True, 9, True), (1, False, 7, False),
])
def test_cuda_bottleneck_matches_reference(dtype, stride, downsample, size, use_res):
    _needs_gpu()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(size)
    block = tres.Bottleneck(64, 16, stride, downsample)
    for prm in block.parameters():
        prm.data = torch.rand(prm.shape, generator=gen) - 0.5
    fold = tfb.fold_bottleneck(block.cuda(), dtype)
    x = torch.randn((3, size, size, 64), generator=gen).to("cuda", dtype)
    before = tfb.fused_bottleneck.launches
    got = tfb.fused_bottleneck(x, fold, stride, use_res)
    torch.cuda.synchronize()
    assert tfb.fused_bottleneck.launches == before + 1
    want = tfb.fused_bottleneck_reference(x, fold, stride, use_res)
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel_err(got, want) <= CUDA_TOL[dtype]
