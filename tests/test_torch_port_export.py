"""Export (adafocus_torch/serving.py) on the CPU, bf16 mode, every family.

For the ActivityNet family (``TINY``), the sth-sth family (the consensus
head with TSM backbones, two divisions and four focus frames: the
configuration of tests/test_serving.py's sth-sth round trip) and AdaFocus+
(tests/test_plus.py's tiny configuration, K=3 of T=6), on one set of flax
weights carried into the port:

- the port's artifact, exported, saved and reloaded through
  ``load_exported``, against the port's eager forward on the same inputs:
  atol = rtol = 1e-5, the JAX package's own bar for its reloaded artifact
  (tests/test_serving.py);
- the same reloaded artifact against JAX's artifact (``export_inference``,
  ``save_exported``, ``load_exported`` of adafocus_tpu/serving.py) on the
  same weights, JAX's frames lane-padded by ``pad_for_extraction``: atol =
  rtol = 1e-3, the forward's tolerance (float32 through two backbones and
  two GRUs, summed in another order; tests/test_torch_port_gfv.py).

Also: ``torch.library.opcheck`` of the four custom ops with CPU tensors
(schema, fake implementation, the dispatch tests and, for the two patch
ops, their autograd); the program's state holds only tensors the forward
reads; and a fresh process loads and serves an artifact through
``adafocus_torch.serving`` without importing ``adafocus_torch.models`` or
JAX. The int8 artifacts: tests/test_torch_port_export_q8.py; the CLI:
tests/test_torch_port_export_cli.py.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adafocus_torch import serving as tserving
from adafocus_torch.benchmark import inference_fn
from adafocus_torch.ops import patch as tpatch
from adafocus_torch.ops import quant as tq
from adafocus_tpu import serving as jserving
from adafocus_tpu.ops.patch import pad_for_extraction
from tests.torch_port_common import (  # noqa: F401 (scratch_path is a fixture)
    TINY, abstract_variables, port_model, scratch_path,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
B = 2
FAMILIES = {
    "actnet": TINY,
    # tests/test_serving.py's sth-sth configuration
    "sthsth": dataclasses.replace(
        TINY, num_classes=5, image_size=32, glance_size=32, hidden_dim=16,
        classifier="consensus", tsm=True, video_div=2, num_frames_focuser=4),
    # tests/test_plus.py's tiny configuration
    "plus": dataclasses.replace(
        TINY, num_classes=5, num_frames=6, frame_budget=3, selector_hidden=8),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(cfg, seed):
    """(port frames, port small, JAX frames_flat) of the same numbers."""
    rs = np.random.RandomState(seed)
    tf, t, s, g = cfg.t_focuser, cfg.num_frames, cfg.image_size, cfg.glance_size
    frames = rs.randn(B, tf, s, s, 3).astype(np.float32)
    small = rs.randn(B, t, g, g, 3).astype(np.float32)
    flat = pad_for_extraction(jnp.asarray(frames.reshape(B * tf, s, s, 3)))
    return (torch.from_numpy(frames), torch.from_numpy(small),
            flat.reshape((B, tf) + flat.shape[1:]))


@pytest.fixture(scope="module")
def exported():
    """family -> (flax GFV, variables, the port's model, its exported
    program), each family exported once a module (an export takes seconds)."""
    done = {}

    def get(family):
        if family not in done:
            jmodel, variables = abstract_variables(FAMILIES[family], seed=5)
            model = port_model(FAMILIES[family], variables)
            done[family] = (jmodel, variables, model, tserving.export_inference(model, B))
        return done[family]

    return get


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_export_matches_eager_and_jax(family, exported, scratch_path):
    cfg = FAMILIES[family]
    jmodel, variables, model, program = exported(family)
    frames, small, flat = _inputs(cfg, seed=6)

    path = str(scratch_path / "port.pt2")
    tserving.save_exported(program, path)
    got = tserving.load_exported(path)(frames, small)
    want = inference_fn(model)(frames, small)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)

    jpath = str(scratch_path / "jax.stablehlo")
    jserving.save_exported(jserving.export_inference(jmodel, variables, batch_size=B), jpath)
    jgot = jserving.load_exported(jpath)(flat, jnp.asarray(small.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-3, rtol=1e-3)


def test_state_is_what_the_forward_reads(exported):
    """The program's state holds the tensors the forward reads: the glancer's
    and the focuser's stage-0 classifiers, which the deployment forward
    never runs, are no part of it; every tensor it holds is one of the
    model's."""
    _, _, model, program = exported("actnet")
    state = program.state_dict
    names = {n.replace(".", "_") for n in model.state_dict()}
    assert {n.removeprefix("model_") for n in state} <= names
    for skipped in ("glancer.classifier.weight", "focuser.fc.weight"):
        assert "model_" + skipped.replace(".", "_") not in state
    assert "model_focuser_stem_conv_weight" in state


def _opcheck_cases():
    gen = torch.Generator().manual_seed(7)
    frames = torch.randn((6, 20, 23, 3), generator=gen)
    offsets = torch.tensor([[0, 0], [-3, 5], [13, 16], [20, 32], [5, -1], [2, 11]],
                           dtype=torch.int32)
    actions = torch.rand((2, 3, 2), generator=gen)
    x = torch.randint(-127, 128, (2, 9, 9, 24), generator=gen, dtype=torch.int8)
    w = tq.pack_conv_weight(torch.randint(-127, 128, (40, 24, 3, 3), generator=gen,
                                          dtype=torch.int8))
    dw = tq.pack_dw_weight(torch.randint(-127, 128, (24, 1, 3, 3), generator=gen,
                                         dtype=torch.int8))
    rescale, bias = torch.rand(40, generator=gen) * 1e-3, torch.randn(40, generator=gen)
    return {
        "extract_patches": (tpatch._patches_op, (frames.requires_grad_(), offsets, 7)),
        "extract_patches_at": (tpatch._patches_at_op,
                               (frames.detach().requires_grad_(), actions, 20, 7)),
        "int8_conv": (tq._int8_conv_op, (x, w, rescale, bias, 3, 2, tq.ACTS["relu6"],
                                         torch.bfloat16)),
        "int8_dwconv": (tq._int8_dwconv_op, (x, dw, rescale[:24], bias[:24], 1,
                                             tq.ACTS["relu"], torch.float32)),
    }


@pytest.mark.parametrize("op", ["extract_patches", "extract_patches_at", "int8_conv",
                                "int8_dwconv"])
def test_custom_ops_opcheck(op):
    fn, args = _opcheck_cases()[op]
    torch.library.opcheck(fn, args)


def test_fresh_process_loads_without_model_code(exported, scratch_path):
    _, _, model, program = exported("actnet")
    path = str(scratch_path / "port.pt2")
    tserving.save_exported(program, path)
    frames, small, _ = _inputs(TINY, seed=8)
    torch.save({"frames": frames, "frames_small": small}, scratch_path / "inputs.pt")
    want = inference_fn(model)(frames, small)
    code = (
        "import sys, torch\n"
        "from adafocus_torch.serving import load_exported\n"
        f"fn = load_exported({path!r})\n"
        f"x = torch.load({str(scratch_path / 'inputs.pt')!r})\n"
        f"torch.save(fn(x['frames'], x['frames_small']), {str(scratch_path / 'out.pt')!r})\n"
        "bad = sorted(m for m in sys.modules if m.startswith('adafocus_torch.models')\n"
        "             or m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'adafocus_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = torch.load(scratch_path / "out.pt")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
