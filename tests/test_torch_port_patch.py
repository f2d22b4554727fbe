"""Port parity: patch offsets, the anchor grid and patch extraction.

The port (adafocus_torch/ops/patch.py, models/policy.py) against the JAX
package on the same numpy inputs. Every comparison is exact: offsets are
integers and extraction is a copy. The JAX Pallas kernel runs in interpret
mode on the CPU, as tests/test_patch.py runs it. The CUDA kernel itself is
held against the plain version by tests/test_torch_port_cuda.py, which
runs only where a GPU is visible (and by chip_smoke.py); its host plan by
tests/test_torch_port_patch_plan.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from adafocus_torch.models import policy as tpolicy
from adafocus_torch.ops import patch as tpatch
from adafocus_tpu.models import policy as jpolicy
from adafocus_tpu.ops import patch as jpatch
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("k", [4, 16, 25, 36, 49, 64, 81, 100])
def test_anchor_grid_and_offsets_match_jax(k):
    got_grid = tpolicy.discrete_to_coords(torch.arange(k), k).numpy()
    want_grid = np.asarray(jpolicy.discrete_to_coords(jnp.arange(k), k))
    assert got_grid.dtype == np.float32
    np.testing.assert_array_equal(got_grid, want_grid)
    # every span 0..224 (frames 224^2, patches 224..0): floor(a * span)
    # moves by a pixel if the grid is one ulp off
    rs = np.random.RandomState(k)
    acts = np.concatenate([want_grid, rs.uniform(0, 1, (64, 2)),
                           [[0.0, 1.0], [1.0, 0.0]]]).astype(np.float32)
    for span in range(225):
        p = 224 - span
        got = tpatch.patch_offsets(torch.from_numpy(acts), 224, p)
        want = np.asarray(jpatch.patch_offsets(jnp.asarray(acts), 224, p))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"span {span}")


def _frames(shape, dtype, seed):
    rs = np.random.RandomState(seed)
    if dtype == "int8":
        return rs.randint(-128, 128, shape).astype(np.int8)
    return rs.randn(*shape).astype(np.float32)


def _torch(x, dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_extract_matches_jax_pallas_interpret(dtype):
    # a in {0, 1} at both axes plus interior actions
    n, s, p = 5, 32, 16
    imgs = _frames((n, s, s, 3), dtype, seed=1)
    acts = np.array([[0, 0], [1, 1], [0, 1], [1, 0], [0.37, 0.81]], np.float32)
    offs_j = jpatch.patch_offsets(jnp.asarray(acts), s, p)
    offs_t = tpatch.patch_offsets(torch.from_numpy(acts), s, p)
    with pltpu.force_tpu_interpret_mode():
        want = jpatch.extract_patches_flat(
            jpatch.pad_for_extraction(_jax(imgs, dtype)), offs_j, p, 3)
    got = tpatch.extract_patches(_torch(imgs, dtype), offs_t, p)
    assert got.shape == (n, p, p, 3)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("n,h,w,c,p", [
    (5, 37, 37, 3, 11),     # nothing a multiple of 8
    (6, 29, 45, 5, 13),     # H != W, odd channel count
    (1100, 12, 10, 3, 5),   # N above the TPU kernel's 1024-program chunk
])
def test_extract_matches_jax_slice(n, h, w, c, p):
    imgs = _frames((n, h, w, c), "float32", seed=n)
    rs = np.random.RandomState(h)
    offs = np.stack([rs.randint(0, h - p + 1, n), rs.randint(0, w - p + 1, n)], 1)
    # edges, and starts outside the frame: dynamic_slice wraps a negative
    # start once (start + dim), then clamps the window into the frame
    edges = [[0, 0], [h - p, w - p], [-3, w - p + 2], [h + 5, -1],
             [-h - 4, -p]]
    offs[:len(edges)] = edges
    offs = offs.astype(np.int32)
    want = np.asarray(jpatch.extract_patches_slice(
        jnp.asarray(imgs), jnp.asarray(offs), p))
    got = tpatch.extract_patches(torch.from_numpy(imgs), torch.from_numpy(offs), p)
    np.testing.assert_array_equal(got.numpy(), want)


def test_extract_has_no_silent_fallback():
    frames = torch.zeros((2, 8, 8, 3), device="meta")
    offs = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no patch-extraction kernel"):
        tpatch.extract_patches(frames, offs, 4)
    acts = torch.zeros((1, 2, 2), device="meta")
    with pytest.raises(ValueError, match="no patch-extraction kernel"):
        tpatch.extract_patches_at(frames.reshape(1, 2, 8, 8, 3), acts, 8, 4)


@pytest.mark.parametrize("s,p", [(32, 16), (37, 11)])
def test_extract_at_matches_jax(s, p):
    # extract_for_frames' path: (B, T, 2) actions, here transposed as the
    # policy returns them, with the anchor grid's values plus 0 and 1
    b, t = 3, 17
    imgs = _frames((b, t, s, s, 3), "float32", seed=s)
    grid = np.asarray(jpolicy.discrete_to_coords(jnp.arange(49), 49))
    acts = np.concatenate([grid, [[0, 0], [1, 1]]]).astype(np.float32).reshape(t, b, 2)
    got = tpatch.extract_patches_at(torch.from_numpy(imgs),
                                    torch.from_numpy(acts).transpose(0, 1), s, p)
    offs = jpatch.patch_offsets(jnp.asarray(acts.transpose(1, 0, 2).reshape(b * t, 2)), s, p)
    want = np.asarray(jpatch.extract_patches_slice(
        jnp.asarray(imgs.reshape(b * t, s, s, 3)), offs, p))
    np.testing.assert_array_equal(got.numpy(), want)
