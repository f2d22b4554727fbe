"""Port parity for the sth-sth serving slice: the temporal shift, the TSM
backbones on both paths, the BatchNorm-encoder continuous division rollout,
``inference_sthsth`` and the weight bridge of a sth-sth tree.

Everything runs on the CPU in float32 on numpy inputs from a seed, with
weights from the JAX package's own initialisation (BatchNorm randomised)
carried through ``gfv_state_dict_from_flax``. Tolerances:

- ``temporal_shift``: exact (a copy);
- TSM backbones against flax, and the port's fused TSM backbones (their
  plain versions here) against JAX's ``*_features_fused`` in interpret
  mode: atol 5e-4, rtol 1e-4, as tests/test_fused_blocks.py holds the JAX
  path;
- the division rollout's continuous actions: 1e-5 (float32 through the
  encoder, a GRU step and a sigmoid);
- the forward's summed consensus logits: atol = rtol = 1e-3, as
  tests/test_torch_port_gfv.py holds the ActivityNet forward. The patch
  offsets floor(a * (S - P)) must equal JAX's; each case first asserts that
  no action sits within 1e-4 of a floor boundary, so that float32 rounding
  cannot move an offset.

The CUDA kernels are held against their plain versions at the matched
configuration's TSM shapes by tests/test_torch_port_cuda.py and
chip_smoke.py.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adafocus_torch.models import fused_inference as tfi
from adafocus_torch.models import gfv as tgfv
from adafocus_torch.models import gfv_sthsth as tsth
from adafocus_torch.models import mobilenet as tmob
from adafocus_torch.models import resnet as tres
from adafocus_torch.models.tsm import temporal_shift as t_shift
from adafocus_torch.ops import patch as tpatch
from adafocus_torch.train import stages as tstages
from adafocus_torch.weights import gfv_state_dict_from_flax
from adafocus_tpu.models import fused_inference as jfi
from adafocus_tpu.models import gfv_sthsth as jsth
from adafocus_tpu.models import mobilenet as jmob
from adafocus_tpu.models import resnet as jres
from adafocus_tpu.models.gfv import GFV, GFVConfig
from adafocus_tpu.models.tsm import temporal_shift as j_shift
from adafocus_tpu.ops import fused_blocks as jfb
from adafocus_tpu.ops.patch import pad_for_extraction, patch_offsets
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.torch_port_common import abstract_variables, no_init, port_model, randomize_bn

BACKBONE_TOL = dict(atol=5e-4, rtol=1e-4)
ACTION_TOL = 1e-5
SLICE_TOL = 1e-3
FLOOR_MARGIN = 1e-4

# tests/test_sthsth.py's tiny configuration, with the matched config's
# continuous policy and BatchNorm encoder
STH = GFVConfig(
    num_classes=5, num_frames=4, num_frames_focuser=6, image_size=24,
    glance_size=16, patch_size=16, action_dim=4, hidden_dim=16,
    policy_hidden=16, classifier="consensus", tsm=True, video_div=2,
    continuous_policy=True, policy_bn=True, policy_channels=64,
    dtype=jnp.float32,
)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("n_frames", [2, 3])
def test_temporal_shift_matches_jax(n_frames):
    x = np.random.RandomState(n_frames).randn(2 * n_frames, 3, 5, 16).astype(np.float32)
    got = t_shift(torch.from_numpy(x), n_frames)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_shift(jnp.asarray(x), n_frames)))
    with pytest.raises(ValueError, match="divisible"):
        t_shift(torch.from_numpy(x[:-1]), n_frames)


@pytest.fixture(scope="module")
def sthsth_pair():
    """The JAX GFV at STH, its variables (BatchNorm random) and the port's
    GFV loaded with them."""
    jmodel, variables = abstract_variables(STH, seed=1)
    return jmodel, variables, port_model(STH, variables)


# name: (flax module, the port's, the JAX fused features, the port's fused
# features), the TSM variants at n_frames=2
BACKBONES = {
    "glancer": (lambda: jmob.MobileNetV2(num_classes=5, n_frames=2),
                lambda: tmob.MobileNetV2(num_classes=5, n_frames=2),
                jfi.mobilenet_features_fused, tfi.mobilenet_features_fused),
    "focuser": (lambda: jres.resnet50(num_classes=5, n_frames=2),
                lambda: tres.resnet50(num_classes=5, n_frames=2),
                jfi.resnet_features_fused, tfi.resnet_features_fused),
}


@pytest.fixture(scope="module", params=sorted(BACKBONES))
def tsm_backbone(request, sthsth_pair):
    """(name, flax module, its variables (STH's glancer or focuser), the
    port's module with the same weights, input: clips of 2 frames at 16^2,
    as many frames as the STH forward at B=2 gives the backbone)."""
    make_flax, make_port = BACKBONES[request.param][:2]
    variables = sthsth_pair[1]
    vs = {k: variables[k][request.param] for k in ("params", "batch_stats")}
    port = make_port()
    port.load_state_dict(gfv_state_dict_from_flax(vs["params"], vs["batch_stats"]))
    n = 2 * (STH.num_frames if request.param == "glancer" else STH.t_focuser)
    x = np.random.RandomState(6).randn(n, 16, 16, 3).astype(np.float32)
    return request.param, make_flax(), vs, port.eval(), x


def test_tsm_backbone_matches_flax(tsm_backbone):
    _, module, vs, port, x = tsm_backbone
    with jax.default_matmul_precision("highest"):
        want_map, want_pool = jax.jit(partial(module.apply, method=module.features))(
            vs, jnp.asarray(x))
    with torch.no_grad():
        got_map, got_pool = port.features(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got_map.permute(0, 2, 3, 1), want_map, BACKBONE_TOL)
    _close(got_pool, want_pool, BACKBONE_TOL)


def test_fused_tsm_backbone_matches_jax(tsm_backbone):
    name, _, vs, port, x = tsm_backbone
    jax_fused, port_fused = BACKBONES[name][2:]
    want_map, want_pool = jax.jit(partial(jax_fused, n_frames=2, interpret=True))(
        vs, jnp.asarray(x))
    got_map, got_pool = port_fused(port, torch.from_numpy(x), n_frames=2)
    _close(got_map, want_map, BACKBONE_TOL)
    _close(got_pool, want_pool, BACKBONE_TOL)
    with torch.no_grad():   # and the port's own library-conv path
        lib_map, _ = port.features(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got_map, lib_map.permute(0, 2, 3, 1), BACKBONE_TOL)


def _inputs(cfg, b, seed):
    rs = np.random.RandomState(seed)
    tf, s, g = cfg.t_focuser, cfg.image_size, cfg.glance_size
    frames = rs.randn(b, tf, s, s, 3).astype(np.float32)
    small = rs.randn(b, cfg.num_frames, g, g, 3).astype(np.float32)
    flat = pad_for_extraction(jnp.asarray(frames.reshape(b * tf, s, s, 3)))
    return frames, small, flat.reshape((b, tf) + flat.shape[1:])


def _jax_rollout(jmodel, variables, small):
    """JAX's greedy division rollout (actions (B, D, 2)), under one jit:
    eagerly each op compiles at each shape."""
    rollout = jax.jit(lambda v, s: jsth.glance_division_rollout(jmodel, v, s,
                                                                jax.random.key(0))[2])
    return rollout(variables, jnp.asarray(small))


def _assert_off_floor_ties(actions, cfg):
    scaled = np.asarray(actions, np.float64) * (cfg.image_size - cfg.patch_size)
    assert np.abs(scaled - np.round(scaled)).min() > FLOOR_MARGIN


@pytest.mark.parametrize("video_div", [1, 2])
def test_policy_rollout_div_matches_jax(sthsth_pair, video_div):
    cfg = dataclasses.replace(STH, video_div=video_div)
    jmodel, variables, model = sthsth_pair
    rs = np.random.RandomState(4)
    fmap = np.abs(rs.randn(2, cfg.num_frames, 1, 1, 1280)).astype(np.float32)
    if video_div != STH.video_div:
        # STH's weights, with a policy initialised for this division's width
        jmodel = GFV(cfg)
        stacked = jnp.zeros((1, 1, 1, 1, 1280 * cfg.num_frames // video_div))
        policy = jmodel.apply(variables, method=lambda m: m.policy.clone(parent=None))
        pv = randomize_bn(policy.init(jax.random.key(3), stacked,
                                      method=policy.rollout_states), seed=3)
        variables = {k: {**variables[k], "policy": pv[k]} for k in ("params", "batch_stats")}
        model = port_model(cfg, variables)
    want = jmodel.apply(variables, jnp.asarray(fmap), jax.random.key(0), "greedy", False,
                        method=GFV.policy_rollout_div)
    with torch.inference_mode():
        got = model.policy_rollout_div(torch.from_numpy(fmap))
    assert got["actions"].shape == (2, video_div, 2) and got["actions"].dtype == torch.float32
    np.testing.assert_allclose(got["actions"].numpy(), np.asarray(want["actions"]),
                               atol=ACTION_TOL, rtol=0)
    np.testing.assert_allclose(got["value"].numpy(), np.asarray(want["value"]),
                               atol=ACTION_TOL, rtol=1e-5)
    assert not got["action_idx"].any() and not got["logprob"].any()
    # sampled: a Gaussian draw around the greedy mean, clamped to [0, 1]
    # (held against JAX's with its noise in tests/test_torch_port_sthsth_train.py)
    with torch.inference_mode():
        sampled = model.policy_rollout_div(torch.from_numpy(fmap), "sample",
                                           torch.Generator().manual_seed(0))
    assert sampled["actions"].shape == (2, video_div, 2)
    assert 0 <= sampled["actions"].min() and sampled["actions"].max() <= 1
    assert torch.isfinite(sampled["logprob"]).all() and sampled["logprob"].any()


@pytest.mark.parametrize("fused,with_glancer", [("auto", True), ("auto", False),
                                                ("on", True)])
def test_inference_sthsth_matches_jax(sthsth_pair, monkeypatch, fused, with_glancer):
    monkeypatch.setattr(jfb, "INTERPRET_DEFAULT", True)
    jmodel, variables, model = sthsth_pair
    if not with_glancer:
        cfg = dataclasses.replace(STH, with_glancer=False)
        jmodel = GFV(cfg)
        with no_init():
            model = tgfv.GFV(dataclasses.replace(model.cfg, with_glancer=False), device="cpu")
        model.load_state_dict(sthsth_pair[2].state_dict())
    b = 2
    frames, small, flat = _inputs(STH, b, seed=2)

    want_roll = _jax_rollout(jmodel, variables, small)
    _assert_off_floor_ties(want_roll["actions"], STH)
    with torch.inference_mode():
        if fused == "on":
            fmap, _ = tfi.fused_glance_logits(model, torch.from_numpy(small))
            got_roll = model.policy_rollout_div(fmap)
        else:
            got_roll = tsth.glance_division_rollout(model, torch.from_numpy(small))[2]
    span = (STH.image_size, STH.patch_size)
    np.testing.assert_array_equal(
        tpatch.patch_offsets(got_roll["actions"], *span).numpy(),
        np.asarray(patch_offsets(want_roll["actions"], *span)))

    want = jax.jit(partial(jsth.inference_sthsth, jmodel, fused=fused))(
        variables, flat, jnp.asarray(small), jax.random.key(0))
    got = tsth.inference_sthsth(model, frames, small, device="cpu", fused=fused)
    assert got.shape == (b, STH.num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SLICE_TOL, rtol=SLICE_TOL)


def test_inference_sthsth_with_actions_matches_jax(sthsth_pair):
    jmodel, variables, model = sthsth_pair
    frames, small, flat = _inputs(STH, 2, seed=5)
    acts = np.random.RandomState(6).uniform(0, 1, (2, STH.video_div, 2)).astype(np.float32)
    _assert_off_floor_ties(acts, STH)
    want = jsth.inference_sthsth_with_actions(jmodel, variables, flat, jnp.asarray(small),
                                              jnp.asarray(acts))
    got = tsth.inference_sthsth_with_actions(model, frames, small, acts, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SLICE_TOL, rtol=SLICE_TOL)
    # the frame counts are the configuration's
    with pytest.raises(ValueError, match="focuser"):
        tsth.inference_sthsth(model, frames[:, :4], small, device="cpu")
    with pytest.raises(ValueError, match="inference_sthsth"):
        tgfv.inference(model, frames, small, device="cpu")


def test_weight_bridge_carries_sthsth_tree(sthsth_pair):
    _, variables, model = sthsth_pair
    sd = gfv_state_dict_from_flax(variables["params"], variables["batch_stats"])
    assert sd.keys() == model.state_dict().keys()
    for key in ("policy.encoder.bn.weight", "policy.encoder.bn.running_var",
                "classifier.fc.weight", "glancer.classifier.weight"):
        assert key in sd
    assert "policy.encoder.proj.bias" not in sd
    assert sd["policy.actor.weight"].shape == (2, STH.policy_hidden)
    assert sd["policy.encoder.proj.weight"].shape == (
        STH.policy_channels, 1280 * STH.num_frames // STH.video_div, 1, 1)
    params = dict(variables["params"], extra={"gate": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="extra/gate"):
        gfv_state_dict_from_flax(params, variables["batch_stats"])


def test_training_refuses_sthsth_config():
    """A consensus-head model trains through train.stages_sthsth; the
    ActivityNet steps refuse it."""
    cfg = tgfv.GFVConfig(**{**dataclasses.asdict(tgfv.flagship(tiny=True)),
                            "classifier": "consensus", "tsm": True,
                            "num_frames_focuser": 4})
    state = tstages.create_train_state(cfg, 1, device="cpu")
    with pytest.raises(ValueError, match="stages_sthsth"):
        tstages.make_stage_train_step(state.model, 1, state.optimizer, state.scheduler)
    state2 = tstages.create_train_state(cfg, 2, device="cpu")
    with pytest.raises(ValueError, match="stages_sthsth"):
        tstages.make_stage2_step(state2.model, state2.ppo)
