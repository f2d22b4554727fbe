"""Port parity, module by module, on bridged weights in float32 on the CPU.

One JAX GFV at the flagship's widths (49 anchors, 200 classes, 1024-wide
GRUs; 64^2 glance, so the glance map is 2x2) is built with
``create_train_state``; its BatchNorm scale, bias and running statistics are
randomised, and the same trees feed the flax modules and, through
``adafocus_torch.weights``, the port. Tolerance: ``atol`` 1e-4 on feature
maps, pooled features, hiddens and logits, as in tests/test_torch_parity.py
(float32 sums in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adafocus_torch.models import gfv as tgfv
from adafocus_torch.weights import gfv_state_dict_from_flax
from adafocus_tpu.models.classifiers import RecurrentClassifier
from adafocus_tpu.models.gru import GRUCell
from adafocus_tpu.models.mobilenet import MobileNetV2
from adafocus_tpu.models.policy import ActorCritic
from adafocus_tpu.models.resnet import resnet50
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.torch_port_common import FLAGSHIP_WIDTH as CFG
from tests.torch_port_common import abstract_variables, port_model

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    _, variables = abstract_variables(CFG, seed=3)
    return variables, port_model(CFG, variables)


def _sub(variables, name):
    out = {"params": variables["params"][name]}
    if name in variables["batch_stats"]:
        out["batch_stats"] = variables["batch_stats"][name]
    return out


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def test_bridge_consumes_every_leaf(models):
    variables, model = models
    sd = gfv_state_dict_from_flax(variables["params"], variables["batch_stats"])
    want = model.state_dict()
    assert set(sd) == set(want)
    for key, value in sd.items():
        assert value.shape == want[key].shape, key
    # the heads that inference does not run are carried too
    assert "glancer.classifier.weight" in sd and "focuser.fc.weight" in sd
    # depthwise (3, 3, 1, C) -> (C, 1, 3, 3)
    np.testing.assert_array_equal(
        sd["glancer.block_1_0.dw.conv.weight"].numpy(),
        variables["params"]["glancer"]["block_1_0"]["dw"]["conv"]["kernel"]
        .transpose(3, 2, 0, 1))
    extra = dict(variables["params"], unknown={"leaf": np.zeros(3)})
    with pytest.raises(KeyError, match="unknown/leaf"):
        gfv_state_dict_from_flax(extra, variables["batch_stats"])


def test_mobilenet_features(models):
    variables, model = models
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    fmap, pooled = MobileNetV2(num_classes=CFG.num_classes, dtype=jnp.float32).apply(
        _sub(variables, "glancer"), jnp.asarray(x), False,
        method=MobileNetV2.features)
    with torch.no_grad():
        got_map, got_pooled = model.glancer.features(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got_map.permute(0, 2, 3, 1), fmap)
    _close(got_pooled, pooled)


def test_resnet50_features(models):
    variables, model = models
    x = np.random.RandomState(1).randn(3, 32, 32, 3).astype(np.float32)
    fmap, pooled = resnet50(num_classes=CFG.num_classes, dtype=jnp.float32).apply(
        _sub(variables, "focuser"), jnp.asarray(x), False,
        method=lambda m, v, train: m.features(v, train))
    with torch.no_grad():
        got_map, got_pooled = model.focuser.features(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got_map.permute(0, 2, 3, 1), fmap)
    _close(got_pooled, pooled)


def test_gru_scan_time(models):
    variables, model = models
    rs = np.random.RandomState(2)
    h0 = rs.randn(2, CFG.policy_hidden).astype(np.float32)
    xs = rs.randn(3, 2, 1024).astype(np.float32)
    cell = GRUCell(hidden_size=CFG.policy_hidden, in_features=1024,
                   dtype=jnp.float32)
    want_h, want_hs = cell.apply(
        {"params": variables["params"]["policy"]["gru"]},
        jnp.asarray(h0), jnp.asarray(xs), method=GRUCell.scan_time)
    with torch.no_grad():
        got_h, got_hs = model.policy.gru.scan_time(
            torch.from_numpy(h0), torch.from_numpy(xs))
    _close(got_h, want_h)
    _close(got_hs, want_hs)


def test_actor_critic_rollout_states(models):
    variables, model = models
    # (T, B, 2, 2, 1280): the 2x2 glance map of a 64^2 glance
    fm = np.random.RandomState(4).rand(2, 3, 2, 2, 1280).astype(np.float32)
    ac = ActorCritic(action_dim=CFG.action_dim, hidden_dim=CFG.policy_hidden,
                     dtype=jnp.float32)
    want = ac.apply({"params": variables["params"]["policy"]}, jnp.asarray(fm),
                    method=ActorCritic.rollout_states)
    with torch.no_grad():
        got = model.policy.rollout_states(torch.from_numpy(fm))
    for g, w in zip(got, want):
        _close(g, w)


def test_recurrent_classifier(models):
    variables, model = models
    feats = np.random.RandomState(5).randn(2, 3, CFG.fused_dim).astype(np.float32)
    head = RecurrentClassifier(num_classes=CFG.num_classes,
                               hidden_dim=CFG.hidden_dim, in_dim=CFG.fused_dim,
                               dtype=jnp.float32)
    v = {"params": variables["params"]["classifier"]}
    want_logits = head.apply(v, jnp.asarray(feats))
    want_l2, want_hs = head.apply(v, jnp.asarray(feats),
                                  method=RecurrentClassifier.forward_with_hiddens)
    h0 = np.zeros((2, CFG.hidden_dim), np.float32)
    want_h1, want_step = head.apply(v, jnp.asarray(h0), jnp.asarray(feats[:, 0]),
                                    method=RecurrentClassifier.step)
    clf = model.classifier
    with torch.no_grad():
        _close(clf(torch.from_numpy(feats)), want_logits)
        got_l2, got_hs = clf.forward_with_hiddens(torch.from_numpy(feats))
        got_h1, got_step = clf.step(torch.from_numpy(h0),
                                    torch.from_numpy(feats[:, 0]))
    _close(got_l2, want_l2)
    _close(got_hs, want_hs)
    _close(got_h1, want_h1)
    _close(got_step, want_step)


@pytest.mark.parametrize("field,value", [
    ("tsm", True), ("video_div", 2), ("frame_budget", 4),
    ("classifier", "consensus"), ("continuous_policy", True),
    ("policy_bn", True), ("policy_conv", False),
])
def test_config_refuses_unported_families(field, value):
    """Every family of the JAX package's configuration is ported: the
    ActivityNet steps take each field, but the consensus head, which trains
    through train.stages_sthsth; a frame budget (AdaFocus+) also trains
    through train.stages_plus, and the MLP state encoder (``policy_conv``)
    and the sth-sth parts serve and train (tests/test_torch_port_plus*.py,
    tests/test_torch_port_sthsth*.py)."""
    from adafocus_torch.train import stages as tstages
    from adafocus_torch.train import stages_plus as tsplus

    cfg = dataclasses.replace(tgfv.flagship(tiny=True), num_frames=4, **{field: value})
    state = tstages.create_train_state(cfg, 1, device="cpu")
    if field == "classifier":
        with pytest.raises(ValueError, match="stages_sthsth"):
            tstages.make_stage_train_step(state.model, 1, state.optimizer, state.scheduler)
        return
    tstages.make_stage_train_step(state.model, 1, state.optimizer, state.scheduler)
    if field == "frame_budget":
        tsplus.make_plus_train_step(state.model, 1, state.optimizer, state.scheduler)
    elif field == "policy_conv":
        assert state.model.policy.encoder.proj is None
    else:
        with pytest.raises(ValueError, match="frame-budget"):
            tsplus.make_plus_train_step(state.model, 1, state.optimizer, state.scheduler)