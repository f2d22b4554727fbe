"""The slice as a whole, against the JAX package's CLI on the CPU.

The JAX train CLI runs stage 1 on the tiny miniact set
(``benchmarks/miniact_harness.py``'s tiny profile) in-process; its
checkpoint crosses to a port checkpoint through
``gfv_state_dict_from_flax``; both evaluate CLIs then agree with
``eval_policy`` center and oracle (top-1/top-5 equal, mAP within 1e-3), and
the learned policy's logits agree within 1e-3 (float32, the tolerance of
tests/test_torch_port_gfv.py). The JAX CLIs' ``create_train_state`` is
``tests/torch_port_common.abstract_state`` here: the package's structure,
values from a seed, without the jitted init's compile. (A file of its own:
the JAX CLI's compiles take most of its minute on the CPU.)
"""

import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from adafocus_torch import config as tconfig
from adafocus_torch.cli import common as tcommon
from adafocus_torch.cli import evaluate as tevaluate
from adafocus_torch.models import gfv as tgfv
from adafocus_torch.train import checkpoint as tckpt
from adafocus_torch.train.stages import TrainState, make_eval_step
from adafocus_torch.weights import gfv_state_dict_from_flax
from adafocus_tpu import config as jconfig
from adafocus_tpu.cli import common as jcommon
from adafocus_tpu.cli import evaluate as jevaluate
from adafocus_tpu.cli import train as jtrain
from adafocus_tpu.train import checkpoint as jckpt
from tests.test_torch_port_cli import tiny_miniact
from tests.test_torch_port_data import make_miniact
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.torch_port_common import abstract_state, no_init

TOL = 1e-3


@pytest.fixture(scope="module")
def miniact_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("miniact"))
    make_miniact(root)
    return root


# ---------------------------------------------------------------------------

def _port_checkpoint_from_jax(jdir: str, tdir: str, cfg) -> None:
    """The JAX CLI's best checkpoint -> a port checkpoint, through numpy and
    ``gfv_state_dict_from_flax``."""
    tree = jckpt.load_checkpoint(jdir, best=True) or jckpt.load_checkpoint(jdir)
    sd = gfv_state_dict_from_flax(jax.tree.map(np.asarray, tree["params"]),
                                  jax.tree.map(np.asarray, tree["batch_stats"]))
    with no_init():
        model = tgfv.GFV(cfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(sd)
    meta = tree["meta"]
    tckpt.save_checkpoint(tdir, TrainState(model, None, None), int(meta["epoch"]),
                          float(meta["acc"]), float(meta["best_acc"]))


@pytest.fixture(scope="module")
def jax_stage1(miniact_root):
    """The JAX train CLI's stage 1 (one epoch) on the tiny miniact set, and
    its checkpoint carried over to the port's format; both removed after
    the module's tests (a checkpoint of the tiny configuration is about
    190 MB)."""
    with tempfile.TemporaryDirectory() as out:
        yield _stage1_checkpoints(miniact_root, out)


def _stage1_checkpoints(miniact_root: str, out: str):
    jdir, tdir = os.path.join(out, "jax"), os.path.join(out, "port")
    args = tiny_miniact(miniact_root) + ["run.stage=1", "run.epochs=1", f"run.ckpt_dir={jdir}"]
    # the tests' JAX runs on 8 virtual CPU devices (tests/conftest.py); the
    # CLI would shard its batch of 4 over them, so it is shown one device,
    # as the run the harness makes in a process of its own sees
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "device_count", lambda *a: 1)
        mp.setattr(jtrain, "create_train_state", abstract_state)
        jtrain.main(args)
    _port_checkpoint_from_jax(jdir, tdir, tconfig.load_config(None, args).model)
    return jdir, tdir


@pytest.mark.parametrize("policy", ["center", "oracle"])
def test_evaluate_clis_agree(jax_stage1, miniact_root, policy, tmp_path, monkeypatch):
    jdir, tdir = jax_stage1
    monkeypatch.setattr(jevaluate, "create_train_state", abstract_state)
    args = tiny_miniact(miniact_root) + [
        f"run.eval_policy={policy}", f"run.oracle_gt={miniact_root}/gt.npz"]
    want = jevaluate.main(args + [f"run.resume={jdir}", f"run.ckpt_dir={tmp_path / 'j'}"])
    got = tevaluate.main(args + [f"run.resume={tdir}", f"run.ckpt_dir={tmp_path / 't'}"])
    assert got["top1"] == want["top1"] and got["top5"] == want["top5"], (got, want)
    assert abs(got["mAP"] - want["mAP"]) <= TOL, (got, want)


def test_learned_logits_agree(jax_stage1, miniact_root):
    """The learned (greedy) policy's eval logits on the first val batch,
    each package from its own loader, batch prep and checkpoint."""
    from adafocus_tpu.models.gfv import inference

    jdir, tdir = jax_stage1
    args = tiny_miniact(miniact_root)
    jcfg, tcfg = jconfig.load_config(None, args), tconfig.load_config(None, args)
    tree = jckpt.load_checkpoint(jdir, best=True)
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    jraw = next(iter(jcommon.build_loader(jcfg, train=False)))
    jbatch, _, _ = jcommon.make_batch_prep(jcfg, train=False)(jraw, jax.random.key(0))
    want = jax.jit(lambda v, f, s: inference(jcommon.build_model(jcfg), v, f, s,
                                             jax.random.key(0)))(
        variables, jbatch["frames_flat"], jbatch["frames_small"])
    cpu = torch.device("cpu")
    model = tgfv.GFV(tcfg.model, device="cpu", param_dtype=torch.float32)
    ttree = tckpt.load_checkpoint(tdir)
    for name in tckpt.COMPONENTS:
        getattr(model, name).load_state_dict(ttree["components"][name])
    traw = next(iter(tcommon.build_loader(tcfg, train=False, device=cpu)))
    np.testing.assert_array_equal(traw["frames"], jraw["frames"])
    tbatch, _, _ = tcommon.make_batch_prep(tcfg, train=False, device=cpu)(traw)
    got, _ = make_eval_step(model)(tbatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
