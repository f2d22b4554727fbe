"""Port parity for AdaFocus+'s modules and forward (models/gfv_plus.py),
the linear head and the MLP state encoder, against the JAX package on the
CPU in float32.

The configuration is tests/test_plus.py's tiny one (T=6, K=3, selector
width 8); weights are flax's, bridged (tests/torch_port_common.py). JAX's
draws are injected into the port: the Gumbel uniforms (``minval=1e-20``),
the random frames' noise and the random patch actions, each from the key
JAX's ``forward_plus`` gives it.

Tolerances:

- frame indices equal (each case first asserts a margin above 1e-4
  between the K-th and the (K+1)-th value the top-K ranks, so that rounding
  cannot flip it), ties broken toward the lower index as ``lax.top_k``;
- the straight-through mask exactly the hard 0/1 mask, its gradient within
  1e-6;
- frame scores and the selector rollout's logprob, value and entropy within
  atol 1e-5;
- logits within atol = rtol = 1e-3 with equal frame indices and patch
  offsets (float32 through two backbones and two GRUs, summed in another
  order), the same for the linear head and the MLP encoder's forward.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adafocus_torch import benchmark as tbenchmark
from adafocus_torch.models import gfv as tgfv
from adafocus_torch.models import gfv_plus as tplus
from adafocus_torch.models import policy as tpolicy
from adafocus_torch.ops.patch import patch_offsets as tpatch_offsets
from adafocus_tpu.models import gfv_plus as jplus
from adafocus_tpu.models.gfv import GFV, GFVConfig, forward_random, inference
from adafocus_tpu.models.policy import StateEncoder
from adafocus_tpu.ops.patch import patch_offsets, random_patch_actions
from tests.torch_port_common import abstract_variables, port_model, train_batch

TOL = 1e-3
SEED = 4
B = 2
# tests/test_plus.py's tiny_cfg
TINY_PLUS = GFVConfig(
    num_classes=5, num_frames=6, image_size=24, glance_size=16, patch_size=16,
    action_dim=4, hidden_dim=16, policy_hidden=16, frame_budget=3, selector_hidden=8,
    dtype=jnp.float32,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _margin(values: np.ndarray, k: int) -> float:
    """The least gap between the K-th and (K+1)-th largest value of a row."""
    top = -np.sort(-values, axis=-1)
    return float((top[..., k - 1] - top[..., k]).min())


# ---------------------------------------------------------------------------
# top-K, the straight-through mask, gather and scatter
# ---------------------------------------------------------------------------

_TIES = {
    "issue_row": (np.array([[1, 3, 3, 2, 3, 0]], np.float32), 2),
    # 0.1234, 0.1235 and 0.1236 round to one bf16 value
    "bf16_scores": (np.array([[0.1234, 0.5, 0.1235, 0.1236, -1.0, 0.5, 0.1234, 0.0]],
                             np.float32).astype(jnp.bfloat16).astype(np.float32), 4),
    "all_equal": (np.zeros((2, 16), np.float32), 8),
    "few_levels": (np.random.RandomState(0).randint(0, 3, (4, 16)).astype(np.float32), 8),
}


@pytest.mark.parametrize("case", sorted(_TIES))
def test_top_k_ties_match_lax(case):
    scores, k = _TIES[case]
    want = np.sort(np.asarray(jax.lax.top_k(jnp.asarray(scores), k)[1]), axis=-1)
    jidx, _ = jplus.select_topk(jnp.asarray(scores), k, jax.random.key(0), mode="top")
    np.testing.assert_array_equal(np.asarray(jidx), want)
    idx, mask = tplus.select_topk(torch.from_numpy(scores), k, "top")
    np.testing.assert_array_equal(idx.numpy(), want)
    assert torch.equal(mask, torch.zeros_like(mask).scatter(1, idx, 1.0))
    rand = tplus.random_frame_selection(*scores.shape, k, noise=torch.from_numpy(scores))
    np.testing.assert_array_equal(rand.numpy(), want)


def test_select_topk_sample_matches_jax():
    scores = np.random.RandomState(1).randn(3, 16).astype(np.float32)
    for seed in range(5):
        key = jax.random.key(seed)
        u = np.asarray(jax.random.uniform(key, scores.shape, minval=1e-20, maxval=1.0))
        assert _margin(scores - np.log(-np.log(u)), 5) > 1e-4
        want, _ = jplus.select_topk(jnp.asarray(scores), 5, key, mode="sample")
        got, _ = tplus.select_topk(torch.from_numpy(scores), 5, "sample", uniforms=_t(u))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the JAX package's random frames from its key's noise
    key = jax.random.key(9)
    noise = np.asarray(jax.random.uniform(key, (3, 16)))
    want = jplus.random_frame_selection(key, 3, 16, 5)
    got = tplus.random_frame_selection(3, 16, 5, noise=_t(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # drawn from a generator: K distinct frames in time order
    got = tplus.random_frame_selection(3, 16, 5, torch.Generator().manual_seed(0))
    assert (got.diff(dim=-1) > 0).all()


def test_straight_through_mask_matches_jax():
    rs = np.random.RandomState(2)
    scores = rs.randn(2, 6).astype(np.float32)
    weight = rs.randn(2, 6).astype(np.float32)

    def jloss(s):
        _, mask = jplus.select_topk(s, 3, jax.random.key(0), mode="top")
        return jnp.sum(mask * weight)

    jmask = jplus.select_topk(jnp.asarray(scores), 3, jax.random.key(0), mode="top")[1]
    want = np.asarray(jax.grad(jloss)(jnp.asarray(scores)))
    s = torch.from_numpy(scores).requires_grad_()
    idx, mask = tplus.select_topk(s, 3, "top")
    hard = torch.zeros(2, 6).scatter(1, idx, 1.0)
    assert torch.equal(mask.detach(), hard)        # exactly 0 and 1
    np.testing.assert_array_equal(mask.detach().numpy(), np.asarray(jmask))
    (got,) = torch.autograd.grad((mask * torch.from_numpy(weight)).sum(), s)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    sig = torch.sigmoid(torch.from_numpy(scores))
    np.testing.assert_allclose(got.numpy(), (sig * (1 - sig)).numpy() * weight, atol=1e-6)


def test_gather_scatter_match_jax():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 6, 4, 5).astype(np.float32)
    idx = np.array([[0, 2, 5], [1, 3, 4]], np.int32)
    feats = rs.randn(2, 3, 7).astype(np.float32)
    np.testing.assert_array_equal(
        tplus.gather_frames(_t(x), _t(idx).long()).numpy(),
        np.asarray(jplus.gather_frames(jnp.asarray(x), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        tplus.scatter_frames(_t(feats), _t(idx).long(), 6).numpy(),
        np.asarray(jplus.scatter_frames(jnp.asarray(feats), jnp.asarray(idx), 6)))


# ---------------------------------------------------------------------------
# the selectors and the forward, on bridged weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plus_models():
    """{plus_rl: (cfg, flax GFV, variables, port GFV, JAX batch, port batch)}."""
    out = {}
    for rl in (False, True):
        cfg = dataclasses.replace(TINY_PLUS, plus_rl=rl)
        jmodel, variables = abstract_variables(cfg, seed=SEED)
        out[rl] = (cfg, jmodel, variables, port_model(cfg, variables)) \
            + train_batch(cfg, B, SEED + 1)
    return out


def test_frame_selector_matches_jax(plus_models):
    cfg, jmodel, variables, model, _, _ = plus_models[False]
    pooled = np.random.RandomState(5).randn(B, cfg.num_frames, 1280).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(pooled), method=GFV.frame_scores)
    with torch.no_grad():
        got = model.frame_scores(_t(pooled))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["sample", "top"])
def test_selector_rollout_matches_jax(plus_models, mode):
    """'sample': the port replays JAX's sampled picks; 'top': the port picks
    greedily itself. logprob, value and entropy (B, K) within 1e-5."""
    cfg, jmodel, variables, model, _, _ = plus_models[True]
    pooled = np.random.RandomState(6).randn(4, cfg.num_frames, 1280).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(pooled), jax.random.key(7), mode,
                        method=GFV.select_rollout)
    actions = _t(want["idx"]).long() if mode == "sample" else None
    with torch.no_grad():
        got = model.select_rollout(_t(pooled), mode, actions=actions)
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
    for key in ("logprob", "value", "entropy"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5,
                                   rtol=0, err_msg=key)
    # the picks of one row are distinct frames
    assert all(len(set(r)) == cfg.frame_budget for r in got["idx"].tolist())


@pytest.mark.parametrize("rl", [False, True], ids=["st", "rl"])
def test_inference_plus_matches_jax(plus_models, rl):
    """``inference_plus``: the top-K frames (the selector's greedy rollout
    with ``plus_rl``), the greedy patch policy on them, one focus on B*K
    patches. Frame indices and patch offsets equal, logits within 1e-3;
    the bench's forward of a frame-budget model is this one. (The
    train-mode forward, Gumbel top-K or random frames and random patches, is
    held in float64 by tests/test_torch_port_plus_train.py's steps.)"""
    cfg, jmodel, variables, model, jbatch, tbatch = plus_models[rl]
    k = cfg.frame_budget
    rng = jax.random.key(11)
    _, a_key, _ = jax.random.split(rng, 3)
    small = jbatch["frames_small"]
    @jax.jit     # one program, where eagerly each op compiles at each shape
    def reference(variables, flat, small, rng):
        want = jplus.inference_plus(jmodel, variables, flat, small, rng)
        _, aux = jplus.forward_plus(jmodel, variables, flat, small, rng,
                                    train=False, patch_mode="policy")
        fmap, pooled = jmodel.apply(variables, small, False, method=GFV.glance)
        scores = None if rl else jmodel.apply(variables, pooled, method=GFV.frame_scores)
        fsel = jplus.gather_frames(fmap, aux["frame_idx"])
        jactions = jmodel.apply(variables, fsel, a_key, "greedy", False,
                                method=GFV.policy_rollout)["actions"]
        return want, aux, scores, jactions

    want, aux, scores, jactions = reference(variables, jbatch["frames_flat"], small, rng)
    if not rl:
        assert _margin(np.asarray(scores), k) > 1e-4
    got = tplus.inference_plus(model, tbatch["frames"], tbatch["frames_small"], device="cpu")
    with torch.inference_mode():
        _, taux = tplus.forward_plus(model, tbatch["frames"], tbatch["frames_small"],
                                     train=False, patch_mode="policy")
    np.testing.assert_array_equal(taux["frame_idx"].numpy(), np.asarray(aux["frame_idx"]))
    np.testing.assert_array_equal(
        tpatch_offsets(taux["actions"], cfg.image_size, cfg.patch_size).numpy(),
        np.asarray(patch_offsets(jactions, cfg.image_size, cfg.patch_size)))
    assert got.shape == (B, cfg.num_frames, cfg.num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    fn = tbenchmark.inference_fn(model, fused="on")
    assert torch.equal(fn(tbatch["frames"], tbatch["frames_small"]), got)
    if not torch.cuda.is_available():   # on the CPU only when asked
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tplus.inference_plus(model, tbatch["frames"], tbatch["frames_small"])


# ---------------------------------------------------------------------------
# the linear head and the MLP state encoder
# ---------------------------------------------------------------------------

_TINY = GFVConfig(num_classes=5, num_frames=3, image_size=24, glance_size=16, patch_size=16,
                  action_dim=4, hidden_dim=16, policy_hidden=16, dtype=jnp.float32)


def test_linear_head_matches_jax():
    """``LinearClassifier`` (per-frame FC, log of the mean softmax clipped at
    1e-12) alone, through ``forward_random`` (injected actions) and through
    ``inference``, within 1e-3. (Train mode: the float64 stage-1 step of
    tests/test_torch_port_plus_train.py.)"""
    cfg = dataclasses.replace(_TINY, classifier="linear")
    jmodel, variables = abstract_variables(cfg, seed=SEED)
    model = port_model(cfg, variables)
    assert isinstance(model.classifier, tgfv.LinearClassifier)
    jbatch, tbatch = train_batch(cfg, B, SEED + 2)
    # the head alone, on features whose softmax underflows the clip
    feats = np.random.RandomState(8).randn(B, 3, cfg.glance_dim + cfg.focus_dim) * 40
    feats = feats.astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(feats), method=GFV.classify_linear)
    with torch.no_grad():
        got = model.classify_linear(_t(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert float(got.min()) >= np.log(1e-12) - 1e-3
    key = jax.random.key(3)
    a_key, _ = jax.random.split(key)
    actions = np.asarray(random_patch_actions(a_key, (B, cfg.num_frames)))
    want = forward_random(jmodel, variables, jbatch["frames_flat"], jbatch["frames_small"],
                          key, train=False)
    with torch.no_grad():
        got = tgfv.forward_random(model, tbatch["frames"], tbatch["frames_small"], None,
                                  train=False, actions=_t(actions))
    assert got.shape == (B, cfg.num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    want = inference(jmodel, variables, jbatch["frames_flat"], jbatch["frames_small"], key)
    got = tgfv.inference(model, tbatch["frames"], tbatch["frames_small"], device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_mlp_state_encoder_matches_jax():
    """``StateEncoder(use_conv=False)``: the mean over the map, Dense, ReLU;
    alone (1e-5) and inside the greedy deployment forward (equal anchors,
    logits within 1e-3)."""
    fmap = np.random.RandomState(9).randn(5, 2, 3, 1280).astype(np.float32)
    enc = StateEncoder(use_conv=False, dtype=jnp.float32)
    params = enc.init(jax.random.key(0), jnp.asarray(fmap))
    want = enc.apply(params, jnp.asarray(fmap))
    port = tpolicy.StateEncoder(1280, (2, 3), use_conv=False)
    port.fc.weight.data = _t(params["params"]["fc"]["kernel"]).T.contiguous()
    port.fc.bias.data = _t(params["params"]["fc"]["bias"])
    assert port.proj is None and sum(p.numel() for p in port.parameters()) == 1281 * 1024
    with torch.no_grad():
        np.testing.assert_allclose(port(_t(fmap)).numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    cfg = dataclasses.replace(_TINY, policy_conv=False)
    jmodel, variables = abstract_variables(cfg, seed=SEED)
    model = port_model(cfg, variables)
    jbatch, tbatch = train_batch(cfg, B, SEED + 3)
    key = jax.random.key(0)
    want = jax.jit(partial(inference, jmodel))(variables, jbatch["frames_flat"],
                                               jbatch["frames_small"], key)
    got = tgfv.inference(model, tbatch["frames"], tbatch["frames_small"], device="cpu")
    jroll = jax.jit(lambda v, small: jmodel.apply(
        v, jmodel.apply(v, small, False, method=GFV.glance)[0], key, "greedy", False,
        method=GFV.policy_rollout))(variables, jbatch["frames_small"])
    with torch.inference_mode():
        roll = model.policy_rollout(model.glance(tbatch["frames_small"])[0])
    np.testing.assert_array_equal(roll["action_idx"].numpy(), np.asarray(jroll["action_idx"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
