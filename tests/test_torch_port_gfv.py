"""Port parity for the whole slice: the deployment forward ``inference``.

The port's ``inference`` against the JAX package's ``inference`` on the CPU
in float32 (the JAX side takes its portable slice path for extraction), at
the tiny configuration of ``__graft_entry__.py`` and at the flagship's
widths. The greedy anchor indices must be equal and the logits within
``atol = rtol = 1e-3`` (float32 through two backbones and two GRUs, summed
in another order). Each
case first asserts that every step's top-2 actor-logit margin exceeds 1e-3,
so that the argmax cannot flip on rounding.

Also here: the port imports nothing of JAX, and its entry points refuse to
fall back to the CPU without being asked.
"""

import ast
import pathlib
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adafocus_torch
from adafocus_torch.models import gfv as tgfv
from adafocus_tpu.models.gfv import GFV, glance_policy_actions, inference
from adafocus_tpu.models.gfv import inference_with_actions
from adafocus_tpu.ops.patch import pad_for_extraction
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.torch_port_common import FLAGSHIP_WIDTH, TINY, abstract_variables, port_model

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-3


def _inputs(cfg, b, seed):
    rs = np.random.RandomState(seed)
    t, s, g = cfg.num_frames, cfg.image_size, cfg.glance_size
    frames = rs.randn(b, t, s, s, 3).astype(np.float32)
    small = rs.randn(b, t, g, g, 3).astype(np.float32)
    flat = pad_for_extraction(jnp.asarray(frames.reshape(b * t, s, s, 3)))
    return frames, small, flat.reshape((b, t) + flat.shape[1:])


@pytest.mark.parametrize("cfg,b", [(TINY, 2), (FLAGSHIP_WIDTH, 1)],
                         ids=["tiny", "flagship_width"])
def test_inference_matches_jax(cfg, b):
    jmodel, variables = abstract_variables(cfg, seed=1)
    model = port_model(cfg, variables)
    frames, small, flat = _inputs(cfg, b, seed=2)
    rng = jax.random.key(0)

    @jax.jit     # one program, where eagerly each op compiles at each shape
    def glance(variables, small, rng):
        fmap, _, roll = glance_policy_actions(jmodel, variables, small, rng)
        _, actor_logits, _ = jmodel.apply(
            variables, jnp.swapaxes(fmap, 0, 1),
            method=lambda m, x: m.policy.rollout_states(x))
        return actor_logits, roll

    actor_logits, roll = glance(variables, jnp.asarray(small), rng)
    top2 = np.sort(np.asarray(actor_logits), axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-3

    with torch.inference_mode():
        got_roll = tgfv.glance_policy_actions(model, torch.from_numpy(small))[2]
    np.testing.assert_array_equal(got_roll["action_idx"].numpy(),
                                  np.asarray(roll["action_idx"]))
    np.testing.assert_array_equal(got_roll["actions"].numpy(),
                                  np.asarray(roll["actions"]))

    want = jax.jit(partial(inference, jmodel))(variables, flat, jnp.asarray(small), rng)
    got = tgfv.inference(model, frames, small, device="cpu")
    assert got.shape == (b, cfg.num_frames, cfg.num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)

    acts = np.random.RandomState(3).uniform(0, 1, (b, cfg.num_frames, 2))
    acts = acts.astype(np.float32)
    want_a = jax.jit(partial(inference_with_actions, jmodel))(
        variables, flat, jnp.asarray(small), jnp.asarray(acts))
    got_a = tgfv.inference_with_actions(model, frames, small, acts, device="cpu")
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a),
                               atol=TOL, rtol=TOL)


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    cfg = tgfv.flagship(tiny=True)
    model = tgfv.GFV(cfg, device="cpu")
    b, t, s, g = 1, cfg.num_frames, cfg.image_size, cfg.glance_size
    frames, small = torch.zeros(b, t, s, s, 3), torch.zeros(b, t, g, g, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgfv.inference(model, frames, small)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgfv.GFV(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        adafocus_torch.default_device()
    assert tgfv.inference(model, frames, small, device="cpu").shape == (
        b, t, cfg.num_classes)


def _port_files():
    return sorted((ROOT / "adafocus_torch").rglob("*.py")) + [
        ROOT / name for name in ("chip_smoke.py", "port_bench.py", "port_build_times.py",
                                  "port_miniact.py",
                                  "port_patch_times.py", "port_smoke_lines.py",
                                  "port_test_times.py",
                                  "port_videos_per_s.py",
                                  "tests/torch_port_parallel_workers.py")]


def test_port_imports_no_jax():
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "adafocus_tpu"}
    checked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for sub in ("adafocus_torch/data/transforms.py", "adafocus_torch/data/cache.py",
                "adafocus_torch/cli/train.py", "adafocus_torch/cli/evaluate.py",
                "adafocus_torch/config.py", "adafocus_torch/train/checkpoint.py",
                "adafocus_torch/utils/visualize.py", "adafocus_torch/train/stages_sthsth.py",
                "adafocus_torch/models/gfv_plus.py", "adafocus_torch/train/stages_plus.py",
                "adafocus_torch/ops/quant.py", "adafocus_torch/models/quant_inference.py",
                "adafocus_torch/weights.py", "adafocus_torch/benchmark.py",
                "adafocus_torch/serving.py", "adafocus_torch/cli/export.py",
                "adafocus_torch/parallel/mesh.py", "adafocus_torch/parallel/dryrun.py",
                "adafocus_torch/utils/torch_weights.py", "adafocus_torch/utils/profiling.py",
                "adafocus_torch/utils/device_lock.py", "adafocus_torch/ops/flops.py",
                "tests/torch_port_parallel_workers.py", "port_miniact.py",
                "port_smoke_lines.py", "port_test_times.py"):
        assert sub in checked, sub
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            elif (isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and getattr(node.func, "attr", getattr(node.func, "id", ""))
                  in ("import_module", "__import__")):
                mods = [str(node.args[0].value)]
            else:
                continue
            roots = {m.split(".")[0] for m in mods}
            assert not roots & banned, f"{path.relative_to(ROOT)} imports {roots & banned}"
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in _port_files())
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(banned)!r})\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
