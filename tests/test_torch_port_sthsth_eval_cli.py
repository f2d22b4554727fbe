"""The sth-sth family's evaluate CLI on a carried checkpoint, against the JAX
package's, on the CPU.

The JAX train CLI runs the family's stage 1 (one epoch) on the tiny miniact
set in float32 with the overrides of tests/test_torch_port_sthsth_cli.py
(the continuous BatchNorm-encoder policy among them); its checkpoint
crosses to a port checkpoint through ``gfv_state_dict_from_flax``. (The
JAX CLIs' ``create_train_state`` is ``tests/torch_port_common.abstract_state``:
the package's structure, values from a seed, nothing compiled.) Both
evaluate CLIs then run with ``eval_policy`` learned, random, center and
oracle (one action a video division; the oracle's the mean of the
division's ground-truth targets where present). For 'random' the port is
given JAX's draws (each batch's key from the CLI's eval stream). Top-1 and
top-5 equal, mAP within 1e-3, as tests/test_torch_port_slice.py holds the
ActivityNet family's.
"""

import tempfile

import jax
import numpy as np
import pytest
import torch

from adafocus_torch.cli import evaluate as tevaluate
from adafocus_tpu import config as jconfig
from adafocus_tpu.cli import evaluate as jevaluate
from adafocus_tpu.cli import train as jtrain
from adafocus_tpu.ops.patch import random_patch_actions
from adafocus_torch import config as tconfig
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.test_torch_port_slice import _port_checkpoint_from_jax
from tests.torch_port_common import abstract_state
from tests.test_torch_port_sthsth_cli import miniact_root, sthsth_args  # noqa: F401 (a fixture)

TOL = 1e-3


@pytest.fixture(scope="module")
def jax_stage1(miniact_root):  # noqa: F811
    """The JAX train CLI's sth-sth stage 1 and its checkpoint carried to
    the port's format; both removed after the module's tests."""
    with tempfile.TemporaryDirectory() as out:
        jdir, tdir = f"{out}/jax", f"{out}/port"
        args = sthsth_args(miniact_root) + ["run.stage=1", "run.epochs=1",
                                            f"run.ckpt_dir={jdir}"]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "device_count", lambda *a: 1)
            mp.setattr(jtrain, "create_train_state", abstract_state)
            jtrain.main(args)
        _port_checkpoint_from_jax(jdir, tdir, tconfig.load_config(None, args).model)
        yield jdir, tdir


@pytest.mark.parametrize("policy", ["learned", "random", "center", "oracle"])
def test_sthsth_evaluate_clis_agree(jax_stage1, miniact_root, policy, tmp_path,  # noqa: F811
                                    monkeypatch):
    jdir, tdir = jax_stage1
    monkeypatch.setattr(jevaluate, "create_train_state", abstract_state)
    args = sthsth_args(miniact_root) + [
        f"run.eval_policy={policy}", f"run.oracle_gt={miniact_root}/gt.npz"]
    want = jevaluate.main(args + [f"run.resume={jdir}", f"run.ckpt_dir={tmp_path / 'j'}"])
    if policy == "random":
        cfg = jconfig.load_config(None, args)
        stream = jax.random.fold_in(jax.random.key(cfg.run.seed), 0x7FFFFFFF)
        drawn = []

        def jax_random_actions(shape, generator, device):
            key = jax.random.fold_in(stream, len(drawn))
            drawn.append(shape)
            return torch.from_numpy(np.array(random_patch_actions(key, shape))).to(device)

        monkeypatch.setattr(tevaluate, "random_patch_actions", jax_random_actions)
    got = tevaluate.main(args + [f"run.resume={tdir}", f"run.ckpt_dir={tmp_path / 't'}"])
    if policy == "random":
        assert drawn and all(s[1] == 2 for s in drawn)   # one action a division
    assert got["top1"] == want["top1"] and got["top5"] == want["top5"], (got, want)
    assert abs(got["mAP"] - want["mAP"]) <= TOL, (got, want)
