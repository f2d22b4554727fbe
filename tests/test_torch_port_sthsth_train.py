"""Port parity for the sth-sth family's training on the CPU: the consensus
head's train-mode dropout, ``forward_random_sthsth``, the per-division
rewards, the continuous policy's sampler, the PPO evaluate pass and update
with the BatchNorm encoder's statistics carried, the TSN optimizer groups
and partial BatchNorm, per-block recomputation, and the stage 1, 2 and 3
steps, each against the JAX package.

The configuration is tests/test_sthsth.py's tiny one (5 classes, 4 glance
and 6 focuser frames, 24^2 frames, 16^2 glance and patches, two video
divisions) with the BatchNorm encoder; weights are flax's, BatchNorm
randomised, bridged (tests/torch_port_common.py); inputs are numpy arrays
from seeds. JAX's draws are injected into the port: its random patch
actions, Gaussian noise, behavior indices and baseline actions from the
step's own key splits; the dropout masks are drawn with numpy and injected
into both, into JAX through ``flax.linen.intercept_methods``.

Tolerances (those of tests/test_torch_port_train.py and
tests/test_torch_port_ppo.py, for the same reasons):

- ``divisional_confidences`` for D = 1, 2, 3: atol 1e-6;
- the head's train-mode output, float32: atol 1e-5;
- ``forward_random_sthsth``'s logits, float32: atol = rtol = 1e-3;
- the continuous sample, its logprob and the entropy: atol 1e-6;
- ``evaluate_episode`` (continuous, BatchNorm encoder), float32: 1e-5,
  and the encoder's running statistics 1e-6;
- ``ppo_update`` in float64 over two epochs: each policy tensor's update
  within 1e-6 of its largest, the running statistics within 1e-6;
- the stage-1 and stage-3 steps in float64 (TSN groups and partial
  BatchNorm on and off): each tensor's update within 1e-5 of its largest,
  running statistics 1e-9 relative, a tensor JAX leaves bit-identical;
- the stage-2 step in float64 (continuous and discrete, BatchNorm
  encoder): the policy's update within 1e-6 of JAX's as a whole, the
  encoder's running statistics 1e-6, ``ppo/ratio_mean`` equal to 1 within
  1e-12;
- each focuser tensor's optimizer group: JAX's label of its counterpart;
- ``remat`` on against off: losses, gradients and running statistics
  identical.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adafocus_torch.models import classifiers as tclassifiers
from adafocus_torch.models import gfv_sthsth as tsth
from adafocus_torch.models import policy as tpolicy
from adafocus_torch.models.layers import training
from adafocus_torch.ppo import core as tppo
from adafocus_torch.train import optim as toptim
from adafocus_torch.train import stages as tstages
from adafocus_torch.train import stages_sthsth as tss
from adafocus_torch.weights import _convert_leaf, _flatten, gfv_state_dict_from_flax
from adafocus_tpu.models import classifiers as jclassifiers
from adafocus_tpu.models import gfv_sthsth as jsth
from adafocus_tpu.models import policy as jpolicy
from adafocus_tpu.models.gfv import GFV
from adafocus_tpu.ops.patch import pad_for_extraction, random_patch_actions
from adafocus_tpu.ppo import core as jppo
from adafocus_tpu.train import optim as joptim
from adafocus_tpu.train import stages_sthsth as jss
from adafocus_tpu.train.stages import TrainState, _rollout_time_major
from tests.test_torch_port_sthsth import STH
from tests.test_torch_port_train import _dropout_interceptor
from tests.test_torch_port_train import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.torch_port_common import (
    abstract_variables, port_config, port_model, randomize_bn, snapshot,
)

SEED = 4
B = 2
OPT = dict(epochs=2, steps_per_epoch=4)
# the discrete variant of STH
STH_DISCRETE = dataclasses.replace(STH, continuous_policy=False)


def _batch(cfg, b, seed, dtype=np.float32):
    """A sth-sth batch, JAX's (focuser frames padded) and the port's."""
    rs = np.random.RandomState(seed)
    tf, s, g = cfg.t_focuser, cfg.image_size, cfg.glance_size
    frames = rs.randn(b, tf, s, s, 3).astype(dtype)
    small = rs.randn(b, cfg.num_frames, g, g, 3).astype(dtype)
    labels = rs.randint(0, cfg.num_classes, b).astype(np.int32)
    flat = pad_for_extraction(jnp.asarray(frames.reshape(b * tf, s, s, 3)))
    jbatch = {"frames_flat": flat.reshape((b, tf) + flat.shape[1:]),
              "frames_small": jnp.asarray(small), "labels": jnp.asarray(labels)}
    tbatch = {"frames": torch.from_numpy(frames), "frames_small": torch.from_numpy(small),
              "labels": torch.from_numpy(labels).long()}
    return jbatch, tbatch


def _keep(cfg, b, seed):
    return np.random.RandomState(seed).uniform(0, 1, (b, cfg.t_focuser, 2048)) < 1 - cfg.dropout


# ---------------------------------------------------------------------------
# The head, the forward, the rewards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("video_div", [1, 2, 3])
def test_divisional_confidences_match_jax(video_div):
    rs = np.random.RandomState(video_div)
    b, tf, c = 3, 6, 7
    local, rand = (rs.randn(b, tf, c).astype(np.float32) for _ in range(2))
    glob = rs.randn(b, 4, c).astype(np.float32)
    labels = rs.randint(0, c, b)
    for with_glancer in (True, False):
        want = jsth.divisional_confidences(jnp.asarray(local), jnp.asarray(rand),
                                           jnp.asarray(glob), jnp.asarray(labels), video_div,
                                           with_glancer)
        got = tsth.divisional_confidences(torch.from_numpy(local), torch.from_numpy(rand),
                                          torch.from_numpy(glob), torch.from_numpy(labels),
                                          video_div, with_glancer)
        for g, w in zip(got, want):
            assert g.shape == (b, video_div) and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_consensus_head_dropout_matches_jax():
    """The repaired head: train-mode dropout from an injected mask gives
    JAX's output; from a generator it draws its own mask (and without
    either it raises); eval mode is the identity."""
    rs = np.random.RandomState(SEED)
    feats = rs.randn(2, 6, 32).astype(np.float32)
    keep = rs.uniform(0, 1, feats.shape) < 0.5
    head = jclassifiers.ConsensusHead(num_classes=5, dropout_rate=0.5)
    variables = head.init(jax.random.key(0), jnp.asarray(feats))
    with fnn.intercept_methods(_dropout_interceptor(jnp.asarray(keep))):
        want = head.apply(variables, jnp.asarray(feats), True)
    want_eval = head.apply(variables, jnp.asarray(feats), False)
    port = tclassifiers.ConsensusHead(32, 5, 0.5)
    sd = gfv_state_dict_from_flax({"h": jax.tree.map(np.asarray, variables["params"])}, {})
    port.load_state_dict({k[2:]: v for k, v in sd.items()})
    x = torch.from_numpy(feats)
    with torch.no_grad():
        port.train()
        np.testing.assert_allclose(port(x, torch.from_numpy(keep)).numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
        a = port(x, generator=torch.Generator().manual_seed(1))
        assert torch.equal(a, port(x, generator=torch.Generator().manual_seed(1)))
        with pytest.raises(ValueError, match="generator"):
            port(x)
        port.eval()
        np.testing.assert_allclose(port(x).numpy(), np.asarray(want_eval), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def sth_pair():
    jmodel, variables = abstract_variables(STH, seed=SEED)
    return jmodel, variables


def test_forward_random_sthsth_matches_jax(sth_pair):
    """float32, focuser and head in train mode, JAX's random actions and the
    same dropout mask: logits atol = rtol = 1e-3."""
    jmodel, variables = sth_pair
    jbatch, tbatch = _batch(STH, B, SEED + 1)
    rng = jax.random.key(7)
    a_key, d_key = jax.random.split(rng)
    keep = _keep(STH, B, SEED + 2)

    @jax.jit
    def forward(variables, frames, small, keep):
        with fnn.intercept_methods(_dropout_interceptor(keep)):
            return jsth.forward_random_sthsth(jmodel, variables, frames, small, a_key,
                                              train=True, mutable=["batch_stats"],
                                              rngs={"dropout": d_key})[0]

    want = forward(variables, jbatch["frames_flat"], jbatch["frames_small"], jnp.asarray(keep))
    actions = np.array(random_patch_actions(jax.random.split(a_key)[0], (B, STH.t_focuser)))
    model = port_model(STH, variables)
    got = tsth.forward_random_sthsth(model, tbatch["frames"], tbatch["frames_small"], None,
                                     actions=torch.from_numpy(actions),
                                     keep=torch.from_numpy(keep))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-3, rtol=1e-3)
    # without ``actions`` and ``keep`` both come from the generator
    gen = torch.Generator().manual_seed(0)
    assert torch.isfinite(tsth.forward_random_sthsth(model, tbatch["frames"],
                                                     tbatch["frames_small"], gen)).all()


# ---------------------------------------------------------------------------
# The continuous policy and PPO with the BatchNorm encoder
# ---------------------------------------------------------------------------


def test_sample_continuous_matches_jax():
    rs = np.random.RandomState(SEED)
    t, b, std = 3, 5, 0.25
    mean = rs.uniform(0, 1, (t, b, 2)).astype(np.float32)
    mean[0, 0] = (0.02, 0.99)     # near the edges: most draws there clamp
    key = jax.random.key(11)
    actions, idx, logp = jpolicy.sample_rollout(jnp.asarray(mean), key, "sample", True, 4, std)
    keys = jax.random.split(key, t)
    noise = np.stack([np.asarray(jax.random.normal(k, (b, 2))) for k in keys])
    got_a, got_idx, got_lp = tpolicy.sample_rollout(torch.from_numpy(mean), "sample", 4, None,
                                                    True, std, torch.from_numpy(noise))
    assert ((np.asarray(actions) == 0) | (np.asarray(actions) == 1)).any()
    np.testing.assert_allclose(got_a.numpy(), np.asarray(actions), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(logp), atol=1e-6, rtol=0)
    assert not got_idx.any() and got_lp.dtype == torch.float32
    # the logprob is that of the clamped action
    np.testing.assert_allclose(
        got_lp.numpy(), np.asarray(jpolicy.gaussian_logprob(actions, jnp.asarray(mean), std)),
        atol=1e-6, rtol=0)
    assert abs(tpolicy.gaussian_entropy(std) - jpolicy.gaussian_entropy(std)) <= 1e-6
    # from a generator: a draw in [0, 1] that the same seed repeats
    gen = lambda: torch.Generator().manual_seed(3)   # noqa: E731
    a1, lp1 = tpolicy.sample_continuous(torch.from_numpy(mean), std, gen())
    a2, _ = tpolicy.sample_continuous(torch.from_numpy(mean), std, gen())
    assert torch.equal(a1, a2) and a1.min() >= 0 and a1.max() <= 1 and torch.isfinite(lp1).all()


def _policy_pair(cfg, seed, dtype=np.float32):
    """JAX's ActorCritic of ``cfg`` alone, its {'params', 'batch_stats'}
    (BatchNorm random) as numpy in ``dtype``, and the port's policy with the
    same weights."""
    policy = jppo.make_policy(cfg)
    stacked = jnp.zeros((1, 1, 1, 1, 1280 * cfg.num_frames // cfg.video_div))
    pv = randomize_bn(policy.init(jax.random.key(seed), stacked, method=policy.rollout_states),
                      seed)
    pv = jax.tree.map(lambda a: np.asarray(a, dtype), pv)
    port = tpolicy.ActorCritic(
        stacked.shape[-1], (1, 1), action_dim=cfg.action_dim, hidden_dim=cfg.policy_hidden,
        encoder_channels=cfg.policy_channels, continuous=cfg.continuous_policy,
        encoder_bn=cfg.policy_bn, action_std=cfg.action_std).to(torch.from_numpy(
            np.zeros(0, dtype)).dtype)
    sd = gfv_state_dict_from_flax({"p": pv["params"]}, {"p": pv["batch_stats"]},
                                  port.encoder.fc.weight.dtype)
    port.load_state_dict({k[2:]: v for k, v in sd.items()})
    return policy, pv, port.eval()


def _episode(cfg, d, b, seed, dtype=np.float32):
    """Division maps (D, B, gh, gw, C') and clamped continuous actions."""
    rs = np.random.RandomState(seed)
    g = 1
    c = 1280 * cfg.num_frames // cfg.video_div
    fmaps = rs.randn(d, b, g, g, c).astype(dtype)
    actions = np.clip(rs.uniform(-0.2, 1.2, (d, b, 2)), 0, 1).astype(dtype)
    return fmaps, actions


def test_evaluate_episode_continuous_bn_matches_jax():
    """float32, train-mode BatchNorm encoder: logprob, value and entropy
    1e-5; the encoder's running statistics after the pass 1e-6."""
    policy, pv, port = _policy_pair(STH, SEED)
    fmaps, actions = _episode(STH, 2, 3, SEED)
    (*want, upd) = jppo.evaluate_episode(policy, pv, jnp.asarray(fmaps), jnp.asarray(actions),
                                         mutable=["batch_stats"])
    with torch.no_grad(), training(port):
        got = tppo.evaluate_episode(port, torch.from_numpy(fmaps), torch.from_numpy(actions))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    stats = upd["batch_stats"]["encoder"]["bn"]
    np.testing.assert_allclose(port.encoder.bn.running_mean.numpy(), np.asarray(stats["mean"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.encoder.bn.running_var.numpy(), np.asarray(stats["var"]),
                               atol=1e-6, rtol=1e-6)
    assert not port.training


def _rel_update(got_new, got_old, want_new, want_old):
    want = want_new - want_old
    return float(((got_new - got_old) - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("continuous", [True, False], ids=["continuous", "discrete"])
def test_ppo_update_carries_bn_stats_like_jax(continuous):
    """float64, two epochs: the second evaluate pass reads the first's
    statistics and the update's; every policy tensor's update within 1e-6
    of its largest, the encoder's running statistics within 1e-6."""
    cfg = dataclasses.replace(STH if continuous else STH_DISCRETE, dtype=jnp.float64)
    d, b = 2, 3
    with jax.enable_x64(True):
        policy, pv, port = _policy_pair(cfg, SEED, np.float64)
        fmaps, actions = _episode(cfg, d, b, SEED + 3, np.float64)
        if not continuous:
            actions = np.random.RandomState(SEED).randint(0, cfg.action_dim, (d, b))
        (old_lp, _, _, _) = jppo.evaluate_episode(policy, pv, jnp.asarray(fmaps),
                                                  jnp.asarray(actions), mutable=["batch_stats"])
        rs = np.random.RandomState(SEED + 4)
        returns = np.asarray(jppo.discounted_returns(jnp.asarray(rs.randn(d, b)), 0.7))
        memory = {"fmaps": fmaps, "actions": actions, "old_logprob": np.asarray(old_lp),
                  "returns": returns}
        pcfg = jppo.PPOConfig(k_epochs=2)
        state, want_m, want_stats = jax.jit(
            lambda s, st, m: jppo.ppo_update(policy, s, st, m, pcfg))(
            jppo.ppo_init(pv["params"], pcfg), pv["batch_stats"], jax.tree.map(jnp.asarray, memory))
        want = gfv_state_dict_from_flax(
            {"policy": jax.tree.map(np.asarray, state.params)},
            {"policy": jax.tree.map(np.asarray, want_stats)}, torch.float64)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    learner = tppo.ppo_init(port, tppo.PPOConfig(k_epochs=2))
    tmem = {k: torch.tensor(v) for k, v in memory.items()}
    if not continuous:
        tmem["actions"] = tmem["actions"].long()
    got_m = tppo.ppo_update(learner, tmem)
    assert not port.training
    for key, p in port.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        w = want["policy." + key]
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(p.numpy(), w.numpy(), atol=1e-6, rtol=0, err_msg=key)
        else:
            assert _rel_update(p, before[key], w, before[key]) <= 1e-6, key
    assert abs(float(got_m["ppo/ratio_mean"]) - float(want_m["ppo/ratio_mean"])) <= 1e-6


# ---------------------------------------------------------------------------
# The optimizer's groups, partial BatchNorm, remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tsn,partial_bn", [(True, False), (True, True), (False, True)])
def test_focuser_groups_match_jax_labels(sth_pair, tsn, partial_bn):
    """Every focuser tensor's optimizer group (or 'frozen') is JAX's label
    of its bridged counterpart; each group's lr and weight decay are
    backbone_lr and weight_decay times JAX's multipliers."""
    _, variables = sth_pair
    params = variables["params"]["focuser"]
    if tsn:
        jlabels = joptim.tsn_param_labels(params, partial_bn=partial_bn)
    else:
        jlabels = joptim._label_partial_bn(params, "backbone")
    want = {".".join(_convert_leaf(path, np.zeros((1, 1)))[0]): label
            for path, label in _flatten(jlabels).items()}
    model = port_model(STH, variables)
    cfg = toptim.OptimConfig(tsn_policies=tsn, weight_decay=5e-4)
    opt, _ = toptim.make_stage_optimizer(model, 1, cfg, partial_bn=partial_bn)
    group_of = {id(p): g["name"] for g in opt.param_groups for p in g["params"]}
    got = {name: group_of.get(id(p), "frozen") for name, p in model.focuser.named_parameters()}
    assert got == {k: v.item() if hasattr(v, "item") else v for k, v in want.items()}
    for name, p in model.focuser.named_parameters():
        assert p.requires_grad == (got[name] != "frozen"), name
    for g in opt.param_groups:
        if g["name"].startswith("tsn_"):
            lr_mult, _, decay_mult = joptim._TSN_GROUPS[g["name"][4:]]   # RGB
            assert g["lr"] == pytest.approx(cfg.backbone_lr * lr_mult, rel=1e-12)
            assert g["weight_decay"] == pytest.approx(cfg.weight_decay * decay_mult, rel=1e-12)


def test_partial_bn_runs_block_bn_on_running_stats():
    model = tstages.GFV(port_config(dataclasses.replace(STH, partial_bn=True)), device="cpu")
    model.focus(torch.zeros(12, 16, 16, 3), train=True)
    assert model.focuser.training and model.focuser.stem.bn.training
    assert not any(getattr(model.focuser, n).training for n in model.focuser.block_names)
    model.focus(torch.zeros(12, 16, 16, 3))
    assert not model.focuser.stem.bn.training


def test_remat_matches_plain_step():
    """One stage-1 step with per-block recomputation of both backbones
    against one without, float32, the same weights, batch, actions and
    dropout mask: losses, every gradient and every running statistic
    identical (the recomputation does not advance a statistic again)."""
    jbatch, tbatch = _batch(STH, B, SEED + 5)
    actions = torch.rand((B, STH.t_focuser, 2), generator=torch.Generator().manual_seed(1))
    keep = torch.from_numpy(_keep(STH, B, SEED + 6))
    results = []
    for remat in (False, True):
        cfg = port_config(dataclasses.replace(STH, remat=remat))
        state = tstages.create_train_state(cfg, 1, device="cpu",
                                           generator=torch.Generator().manual_seed(2))
        assert state.model.focuser.remat == remat and state.model.glancer.remat == remat
        step = tss.make_sthsth_train_step(state.model, 1, state.optimizer, state.scheduler)
        # the glancer is frozen in stage 1: run it under autograd too, so
        # that its recomputation is exercised as well
        state.model.glancer.requires_grad_(True)
        fmap, _ = state.model.glance(tbatch["frames_small"], True)
        fmap.square().mean().backward()
        state.model.glancer.requires_grad_(False)
        loss = step(tbatch, None, actions, keep)["loss"]
        grads = {n: p.grad.clone() for n, p in state.model.named_parameters()
                 if p.grad is not None}
        results.append((float(loss), grads, snapshot(state.model)))
    (l0, g0, s0), (l1, g1, s1) = results
    assert l0 == l1
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_sthsth_steps_refuse_other_stages_and_families(sth_pair):
    """Stage 0 of the family raises, as JAX's does; the ActivityNet steps
    refuse a consensus-head model and the sth-sth steps a GRU-head one."""
    jmodel, variables = sth_pair
    model = port_model(STH, variables)
    opt, sched = toptim.make_stage_optimizer(model, 1, toptim.OptimConfig())
    with pytest.raises(ValueError, match="no stage 0"):
        tss.make_sthsth_train_step(model, 0, opt, sched)
    with pytest.raises(ValueError):
        jss.make_sthsth_train_step(jmodel, 0, None)
    with pytest.raises(ValueError, match="stages_sthsth"):
        tstages.make_stage_train_step(model, 1, opt, sched)
    actnet = tstages.create_train_state(tstages.GFVConfig(
        num_classes=10, num_frames=2, image_size=24, glance_size=16, patch_size=16,
        action_dim=4, hidden_dim=16, policy_hidden=16, dtype=torch.float32), 1, device="cpu")
    with pytest.raises(ValueError, match="consensus"):
        tss.make_sthsth_train_step(actnet.model, 1, actnet.optimizer, actnet.scheduler)


def test_sthsth_eval_step_matches_jax(sth_pair):
    """The eval step: ``inference_sthsth``'s logits (1e-3) and top-1/top-5."""
    jmodel, variables = sth_pair
    jbatch, tbatch = _batch(STH, B, SEED + 9)
    jstate = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                        opt_state=None, step=jnp.zeros((), jnp.int32))
    want, want_m = jax.jit(jss.make_sthsth_eval_step(jmodel))(jstate, jbatch, jax.random.key(0))
    got, got_m = tss.make_sthsth_eval_step(port_model(STH, variables))(tbatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-3)
    assert got.shape == (B, STH.num_classes)


def test_sthsth_stage1_warm_starts_from_actnet_stage0():
    """The recipe's warm start of sth-sth stage 1 from an ActivityNet
    stage-0 checkpoint (``load_stage_components``): every glancer and
    focuser tensor whose shape agrees is loaded, the heads of another class
    count (10 against 5) keep their fresh weights, and the consensus head
    and the policy, which stage 1 does not inherit, stay fresh."""
    from adafocus_torch.models import gfv as tgfv
    from adafocus_torch.train import checkpoint as tckpt

    actnet = tstages.create_train_state(tgfv.flagship(tiny=True), 0, device="cpu",
                                        generator=torch.Generator().manual_seed(1))
    tree = tckpt._to_saveable(actnet)
    state = tstages.create_train_state(port_config(STH), 1, device="cpu",
                                       generator=torch.Generator().manual_seed(2))
    fresh = snapshot(state.model)
    tckpt.load_stage_components(state, tree, 1)
    after = snapshot(state.model)
    heads = {"glancer.classifier.weight", "glancer.classifier.bias", "focuser.fc.weight",
             "focuser.fc.bias"}
    for key, value in after.items():
        comp, rest = key.split(".", 1)
        if comp in ("glancer", "focuser") and key not in heads:
            assert torch.equal(value, tree["components"][comp][rest]), key
        else:
            assert torch.equal(value, fresh[key]), key
