"""The port's data-parallel steps (``adafocus_torch.parallel``) over two gloo
ranks on the CPU, against the JAX package's steps lifted onto a two-device
mesh (``parallel/mesh.py shard_train_step`` on ``make_mesh(2)``), in
float64.

For each step factory, one step from the same carried weights (flax's tree
from ``abstract_variables``, bridged) on the same global batch of 4 videos,
2 a replica: ActivityNet stage 1 and stage 2 (reward 'random', two PPO
epochs), the sth-sth stage 1 and stage 2 (the continuous policy with the
BatchNorm encoder), AdaFocus+ stage 1 (the ST selector) and its joint
stage 2. Each replica's draws are the ones JAX's step takes from the rng
with the replica's index folded in, computed here and injected into that
rank (the sth-sth head's dropout mask is drawn with numpy and injected into
both, into JAX through the batch). The two ranks run in one process tree
(tests/torch_port_parallel_workers.py, which imports no JAX), started once
the draws are taken; meanwhile JAX's references compile, half of them in a
second interpreter (tracing holds the GIL).

Tolerances, those of the per-process tests of each step (measured in
brackets):

- the supervised steps (tests/test_torch_port_train.py): loss rtol 1e-6
  (equal), top-1/top-5 equal; each tensor's update within 1e-5 of
  max|JAX update| of that tensor (at most 1.4e-7); running statistics
  within 1e-9 relative;
- the PPO steps (tests/test_torch_port_ppo.py, _sthsth_ppo.py and
  _plus_train.py): the metrics rtol 1e-5 (atol 1e-8); the learner's update
  as a whole within 1e-4 of JAX's (1.9e-5 for two epochs of the
  ActivityNet policy, 2.1e-6 joint, 4.8e-8 sth-sth) over the elements
  whose averaged gradient exceeds 1e-6 of its module's largest: Adam's
  first step, lr * g / (|g| + 1e-8), turns the float32 rounding of a
  gradient element near zero into a fraction of lr in both packages (both
  compute the PPO loss in float32); the sth-sth encoder's running
  statistics atol 1e-6 (2.2e-16);
- everywhere: a tensor JAX leaves unchanged (every frozen component)
  bit-identical, and the two ranks' weights bit-identical.

Port only: the cross-replica ``discounted_returns`` against JAX's under
``shard_map`` (1e-6; 2.2e-16), and the two-rank ``ppo_update`` against one
process's on the whole episode (1e-6; 2.2e-15), the counterpart of
tests/test_parallel.py:67.
"""

import concurrent.futures
import dataclasses
import functools
import os
import signal
import subprocess
import sys
from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from adafocus_torch.models import gfv as tgfv
from adafocus_tpu.models.gfv import GFV
from adafocus_tpu.models.gfv_plus import SelectorActorCritic, gather_frames
from adafocus_tpu.ops.patch import random_patch_actions
from adafocus_tpu.parallel.mesh import make_mesh, shard_train_step
from adafocus_tpu.ppo import core as jppo
from adafocus_tpu.train import optim as joptim
from adafocus_tpu.train import stages as jstages
from adafocus_tpu.train import stages_plus as jsplus
from adafocus_tpu.train import stages_sthsth as jss
from tests import torch_port_parallel_workers as workers
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.test_torch_port_plus_train import TINY_PLUS
from tests.test_torch_port_sthsth import STH
from tests.test_torch_port_sthsth_train import _batch as sthsth_batch
from tests.test_torch_port_sthsth_train import _keep
from tests.test_torch_port_train import _dropout_interceptor
from tests.torch_port_common import (
    TRAIN_CFG, abstract_variables, port_config, removed_after, state_dict_from_jax, train_batch,
)

B = 4                          # the global batch, B // 2 a replica
SEED = 13
OPT = dict(epochs=2, steps_per_epoch=4)
PPO = dict(k_epochs=2)
WORKER_TIMEOUT = 400           # seconds; a hang fails the test
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# case: (factory, JAX config, seed, key)
CASES = {
    "actnet-stage1": ("stage1", TRAIN_CFG, SEED, 101),
    "actnet-stage2": ("stage2", TRAIN_CFG, SEED, 102),
    "sthsth-stage1": ("sthsth1", STH, SEED + 1, 103),
    "sthsth-stage2-bn": ("sthsth2", STH, SEED + 1, 104),
    "plus-stage1": ("plus1", TINY_PLUS, SEED + 2, 105),
    "plus-joint-stage2": ("joint2", dataclasses.replace(TINY_PLUS, plus_rl=True), SEED + 3, 106),
}
_FROZEN = {"stage1": ("glancer", "policy"), "sthsth1": ("glancer", "policy"),
           "plus1": ("glancer", "policy")}


def _f64(cfg):
    return dataclasses.replace(cfg, dtype=jnp.float64)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rows(x, r: int, n: int):
    return x[r * n:(r + 1) * n]


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(JAX config, flax GFV, float64 variables, JAX batch, port batch)."""
    factory, cfg, seed, _ = CASES[name]
    cfg = _f64(cfg)
    jmodel, variables = _weights(cfg, seed)
    if factory.startswith("sthsth"):
        jbatch, tbatch = sthsth_batch(cfg, B, seed + 1, np.float64)
    else:
        jbatch, tbatch = train_batch(cfg, B, seed + 1, np.float64)
    if factory == "sthsth1":
        keep = _keep(cfg, B, seed + 2)
        jbatch = {**jbatch, "keep": jnp.asarray(keep)}
        tbatch = {**tbatch, "keep": torch.from_numpy(keep)}
    return cfg, jmodel, variables, jbatch, tbatch


def _replica_draws(name, cfg, jmodel, variables, jbatch):
    """Each replica's draws, as JAX's step takes them from its folded key,
    in the keyword arguments of the port's step."""
    factory, _, _, key = CASES[name]
    n = B // 2
    t, k = cfg.num_frames, cfg.frame_budget
    behavior = jax.jit(partial(_stage2_behavior, cfg, jmodel))
    picks = jax.jit(partial(_joint_picks, cfg, jmodel))
    out = []
    for r in range(2):
        rng = jax.random.fold_in(jax.random.key(key), r)
        small = _rows(jbatch["frames_small"], r, n)
        if factory == "stage1":
            a_key, _ = jax.random.split(rng)
            out.append({"actions": _t(random_patch_actions(a_key, (n, t)))})
        elif factory == "stage2":
            roll_key, base_key = jax.random.split(rng)
            idx = behavior(variables, small, roll_key)
            out.append({"behavior_idx": _t(idx).long(),
                        "baseline_actions": _t(random_patch_actions(base_key, (n, t)))})
        elif factory == "sthsth1":
            a_key = jax.random.split(rng)[0]
            actions = random_patch_actions(jax.random.split(a_key)[0], (n, cfg.t_focuser))
            out.append({"actions": _t(actions), "keep": _t(_rows(jbatch["keep"], r, n))})
        elif factory == "sthsth2":
            roll_key, base_key = jax.random.split(rng)
            noise = np.stack([np.asarray(jax.random.normal(kk, (n, 2)))
                              for kk in jax.random.split(roll_key, cfg.video_div)])
            out.append({"behavior": _t(noise), "baseline_actions": _t(
                random_patch_actions(base_key, (n, cfg.video_div)))})
        elif factory == "plus1":
            a_key, _ = jax.random.split(rng)
            sel_key, patch_key, _ = jax.random.split(a_key, 3)
            out.append({"uniforms": _t(jax.random.uniform(sel_key, (n, t), minval=1e-20,
                                                          maxval=1.0)),
                        "actions": _t(random_patch_actions(patch_key, (n, k)))})
        else:
            out.append({"draws": _joint_draws(cfg, picks(variables, small, *jax.random.split(
                rng, 4)[:2]), small.shape[0], rng)})
    return out


def _stage2_behavior(cfg, jmodel, variables, small, key):
    fmap, _ = jmodel.apply(variables, small, False, method=GFV.glance)
    return jstages._rollout_time_major(jppo.make_policy(cfg),
                                       {"params": variables["params"]["policy"]},
                                       jnp.swapaxes(fmap, 0, 1), key, cfg)["store"]


def _joint_draws(cfg, picks, b, rng):
    """The joint step's draws from its key (tests/test_torch_port_plus_train.py
    ``_joint_draws`` at this replica's batch of ``b``): the selector's and
    the policy's sampled ``picks`` (``_joint_picks``), the baseline's
    frames and patch actions."""
    _, _, base_f_key, base_a_key = jax.random.split(rng, 4)
    idx, spatial = picks
    t, k = cfg.num_frames, cfg.frame_budget
    return {"select": _t(idx).long(), "spatial": _t(spatial).long(),
            "base_idx": _t(jax.random.randint(base_f_key, (b, k), 0, t)).long(),
            "base_actions": _t(random_patch_actions(base_a_key, (b, k)))}


def _joint_picks(cfg, jmodel, variables, small, sel_key, spat_key):
    params = variables["params"]
    fmap, pooled = jmodel.apply(variables, small, False, method=GFV.glance)
    selector = SelectorActorCritic(hidden_dim=cfg.selector_hidden, in_dim=cfg.glance_dim,
                                   dtype=cfg.dtype)
    idx = selector.apply({"params": params["selector_ac"]}, pooled, cfg.frame_budget, sel_key,
                         "sample", method=SelectorActorCritic.rollout)["idx"]
    fmaps_tb = jnp.swapaxes(gather_frames(fmap, idx), 0, 1)
    spatial = jstages._rollout_time_major(jppo.make_policy(cfg), {"params": params["policy"]},
                                          fmaps_tb, spat_key, cfg)["store"]
    return idx, spatial


def _jax_step(name, cfg, jmodel, variables, jbatch):
    """JAX's step of ``name`` on the two-device mesh: (the tensors of the
    state dict that it moved, its new values; the metrics)."""
    factory, _, _, key = CASES[name]
    with jax.enable_x64(True):
        params, stats = variables["params"], variables["batch_stats"]
        state = jstages.TrainState(params=params, batch_stats=stats, opt_state=None,
                                   step=jnp.zeros((), jnp.int32))
        if factory in _FROZEN:
            tx = joptim.make_stage_optimizer(1, joptim.OptimConfig(**OPT))
            state = state.replace(opt_state=tx.init(params))
            make = {"stage1": jstages.make_stage_train_step,
                    "sthsth1": jss.make_sthsth_train_step,
                    "plus1": jsplus.make_plus_train_step}[factory]
            step = make(jmodel, 1, tx, axis_name="data")
        else:
            pcfg = jppo.PPOConfig(**PPO) if factory == "stage2" else jppo.PPOConfig()
            learner = ({"policy": params["policy"], "selector_ac": params["selector_ac"]}
                       if factory == "joint2" else params["policy"])
            state = state.replace(ppo=jppo.ppo_init(learner, pcfg))
            make = {"stage2": jstages.make_stage2_step,
                    "sthsth2": jss.make_sthsth_stage2_step,
                    "joint2": jsplus.make_plus_stage2_joint_step}[factory]
            step = make(jmodel, pcfg, axis_name="data")
        if factory == "sthsth1":
            inner = step

            def step(state, batch, rng):
                batch = dict(batch)
                keep = batch.pop("keep")
                with fnn.intercept_methods(_dropout_interceptor(keep)):
                    return inner(state, batch, rng)

        new, metrics = shard_train_step(step, make_mesh(2), donate_state=False)(
            state, jbatch, jax.random.key(key))
        j0 = state_dict_from_jax(variables, torch.float64)
        j1 = state_dict_from_jax({"params": new.params, "batch_stats": new.batch_stats},
                                 torch.float64)
        return ({k: v for k, v in j1.items() if not torch.equal(v, j0[k])},
                {k: float(v) for k, v in metrics.items()})


def _ppo_update_case():
    """A tiny policy and a stored episode (T=2, B=8, float64 weights)."""
    cfg = dataclasses.replace(port_config(_f64(TRAIN_CFG)), dtype=torch.float64)
    model = tgfv.GFV(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED),
                     param_dtype=torch.float64)
    g = torch.Generator().manual_seed(SEED + 1)
    t = cfg.num_frames
    memory = {"fmaps": torch.randn((t, B, 1, 1, 1280), generator=g, dtype=torch.float64),
              "actions": torch.randint(0, cfg.action_dim, (t, B), generator=g),
              "old_logprob": -torch.rand((t, B), generator=g) - 1.0,
              "returns": torch.randn((t, B), generator=g).float()}
    return {"cfg": cfg, "policy": workers._snapshot(model.policy), "memory": memory,
            "ppo": PPO}


# the cases whose JAX steps a second interpreter traces and compiles
# (``_main``), beside the fixture's own: tracing holds the GIL
SECOND = ("actnet-stage1", "sthsth-stage1", "plus-stage1")


def _start(args):
    return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(proc, what):
    try:
        out, _ = proc.communicate(timeout=WORKER_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{what} did not finish in {WORKER_TIMEOUT} s:\n{out}")
    assert proc.returncode == 0, f"{what} failed (rc {proc.returncode}):\n{out}"


@functools.lru_cache(maxsize=None)
def _weights(cfg, seed):
    """(flax GFV, float64 numpy variables) of ``abstract_variables``."""
    jmodel, variables = abstract_variables(cfg, seed)
    return jmodel, jax.tree.map(lambda a: np.asarray(a, np.float64), variables)


def _reference(name):
    with jax.enable_x64(True):
        return _jax_step(name, *_setup(name)[:4])


def _draws(name):
    with jax.enable_x64(True):
        setup = _setup(name)
        return setup, _replica_draws(name, *setup[:4])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's JAX reference and both ranks' results, the returns and
    the PPO update's, all in memory: their directory is removed once they
    are loaded."""
    path = str(tmp_path_factory.mktemp("parallel"))
    with removed_after(path):
        return _runs(path)


def _runs(path):
    """``runs`` through ``path``. A second interpreter computes JAX's
    ``SECOND`` steps; here the other JAX steps compile on threads while the
    draws are taken, and then while the two ranks run."""
    second = _start(["tests.test_torch_port_parallel", path, *SECOND])
    procs = [(second, "JAX's second interpreter")]
    try:
        with concurrent.futures.ThreadPoolExecutor(len(CASES)) as pool:
            cases, weights = {}, {}
            for name, (setup, replica_draws) in zip(CASES, pool.map(_draws, CASES)):
                cfg, _, variables, _, tbatch = setup
                factory, jcfg, seed, _ = CASES[name]
                # the cases of one configuration and seed share their weights,
                # under the first one's name
                key = next(n for n, c in CASES.items() if c[1:3] == (jcfg, seed))
                if key not in weights:
                    weights[key] = state_dict_from_jax(variables, torch.float64)
                tcfg = dataclasses.replace(port_config(cfg), dtype=torch.float64)
                cases[name] = {"factory": factory, "cfg": tcfg, "draws": replica_draws,
                               "weights": key,
                               "batch": {k: v for k, v in tbatch.items() if k != "keep"},
                               "optim": OPT, "ppo": PPO if factory == "stage2" else {}}
            rewards = np.random.RandomState(SEED).randn(4, B)
            upd = _ppo_update_case()
            torch.save({"cases": cases, "weights": weights,
                        "returns": {"rewards": torch.from_numpy(rewards), "gamma": 0.7},
                        "ppo_update": upd}, os.path.join(path, "cases.pt"))
            procs.append((_start(["tests.torch_port_parallel_workers", "steps", path]),
                          "the two ranks"))
            mine = [name for name in CASES if name not in SECOND]
            jax_futures = {name: pool.submit(_reference, name) for name in mine}
            with jax.enable_x64(True):
                want_returns = np.asarray(jax.jit(shard_map(
                    lambda r: jppo.discounted_returns(r, 0.7, axis_name="data"),
                    mesh=make_mesh(2), in_specs=P(None, "data"), out_specs=P(None, "data")))(
                    jnp.asarray(rewards)))
            one_rank = workers.one_rank_ppo_update(upd)
            jax_out = {name: f.result() for name, f in jax_futures.items()}
    finally:
        for proc, what in procs:
            _wait(proc, what)
    # both ranks have exited: nothing reads the cases any longer
    os.remove(os.path.join(path, "cases.pt"))
    for name in SECOND:
        jax_out[name] = torch.load(os.path.join(path, f"{name}.jax.pt"), weights_only=False)
    ranks = {name: [torch.load(os.path.join(path, f"{name}.rank{r}.pt"), weights_only=False)
                    for r in range(2)] for name in CASES}
    shared = [torch.load(os.path.join(path, f"shared.rank{r}.pt"), weights_only=False)
              for r in range(2)]
    j0 = {name: weights[cases[name]["weights"]] for name in CASES}
    return {"jax": jax_out, "j0": j0, "ranks": ranks, "returns": (want_returns, shared),
            "ppo_update": (upd["policy"], one_rank)}


def _rel(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_step_matches_jax_mesh(runs, name):
    """One data-parallel step of each factory against JAX's on a
    two-device mesh; see the module's tolerances."""
    factory = CASES[name][0]
    j0 = runs["j0"][name]
    moved_by_jax, want_m = runs["jax"][name]
    j1 = {**j0, **moved_by_jax}
    got, other = runs["ranks"][name]
    assert got["digest"] == other["digest"], "the replicas' weights differ"
    assert got["metrics"] == other["metrics"], "the replicas' averaged metrics differ"
    p1 = {**j0, **got["moved"]}
    got_m = got["metrics"]
    assert got_m.keys() == want_m.keys()
    keys = [k for k in j0 if not k.endswith("num_batches_tracked")]
    moved = {k for k in keys if not torch.equal(j1[k], j0[k])}
    for key in keys:
        if key not in moved:
            assert torch.equal(p1[key], j0[key]), f"{key} moved; JAX leaves it"
    if factory in _FROZEN:
        np.testing.assert_allclose(got_m["loss"], want_m["loss"], rtol=1e-6)
        assert (got_m["top1"], got_m["top5"]) == (want_m["top1"], want_m["top5"])
        for key in moved:
            if key.endswith(("running_mean", "running_var")):
                assert _rel(p1[key], j1[key]) <= 1e-9, key
            else:
                want = j1[key] - j0[key]
                err = ((p1[key] - j0[key]) - want).abs().max() / want.abs().max()
                assert err <= 1e-5, (key, float(err))
        assert not {k.split(".")[0] for k in moved} & set(_FROZEN[factory])
        return
    for key, want in want_m.items():
        np.testing.assert_allclose(got_m[key], want, rtol=1e-5, atol=1e-8, err_msg=key)
    learner = ("policy.", "selector_ac.")
    grads = got["grads"]
    assert set(grads) == {k for k in j0 if k.startswith(learner)
                          and not k.endswith(("running_mean", "running_var",
                                              "num_batches_tracked"))}
    # the elements whose gradient is resolved: above 1e-6 of its module's
    # largest (tests/test_torch_port_plus_train.py)
    scale = {m: max(float(g.abs().max()) for k, g in grads.items() if k.startswith(m))
             for m in learner if any(k.startswith(m) for k in grads)}
    keys = sorted(grads)
    resolved = torch.cat([(grads[k].abs() > 1e-6 * scale[k.split(".")[0] + "."]).flatten()
                          for k in keys])
    got_u = torch.cat([(p1[k] - j0[k]).flatten() for k in keys])[resolved]
    want_u = torch.cat([(j1[k] - j0[k]).flatten() for k in keys])[resolved]
    assert _rel(got_u, want_u) <= 1e-4, _rel(got_u, want_u)
    stats = [k for k in moved if k.endswith(("running_mean", "running_var"))]
    assert bool(stats) == (factory == "sthsth2")
    for key in stats:
        np.testing.assert_allclose(p1[key].numpy(), j1[key].numpy(), atol=1e-6, rtol=0)
    assert all(k.startswith(learner) for k in moved)


def test_cross_replica_returns_match_jax(runs):
    """``discounted_returns`` over two ranks, each normalising its half of
    the batch with the global moments, against JAX's under ``shard_map``."""
    want, shared = runs["returns"]
    got = torch.cat([s["returns"] for s in shared], dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_two_rank_ppo_update_matches_one_rank(runs):
    """Two epochs of ``ppo_update``, each rank on its half of the episode,
    against one process on the whole of it: the replicas bit-identical,
    the update within 1e-6 of the one-process update as a whole (float64
    weights, float32 loss)."""
    _, shared = runs["returns"]
    before, want = runs["ppo_update"]
    assert shared[0]["digest"] == shared[1]["digest"]
    got = shared[0]["policy"]
    got_u = torch.cat([(got[k] - before[k]).flatten() for k in sorted(before)])
    want_u = torch.cat([(want[k] - before[k]).flatten() for k in sorted(before)])
    assert want_u.abs().max() > 0
    assert _rel(got_u, want_u) <= 1e-6, _rel(got_u, want_u)


def _main(argv):
    """``python -m tests.test_torch_port_parallel DIR CASE...``: JAX's mesh
    steps of the cases, on threads, each to DIR/<case>.jax.pt. The parent's
    environment gives the 8 CPU devices (tests/conftest.py)."""
    jax.config.update("jax_platforms", "cpu")
    path, names = argv[0], argv[1:]
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for name, out in zip(names, pool.map(_reference, names)):
            torch.save(out, os.path.join(path, f"{name}.jax.pt"))


if __name__ == "__main__":
    _main(sys.argv[1:])
