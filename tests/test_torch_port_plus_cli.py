"""AdaFocus+ through the port's CLI (``model.frame_budget=K``, with and
without ``model.plus_rl=true``) on the CPU, and against the JAX package's
evaluate CLI on a carried checkpoint.

- ``cli.train.build_steps`` takes the JAX CLI's routes: stages 1 and 3 the
  plus step, stage 2 the joint step with ``plus_rl`` and the base stage 2
  over all T frames without, stage 0 the base step; the eval step is the
  plus eval step in every stage.
- The port's train CLI runs stages 1 -> 2 -> 3 and evaluate on synthetic
  clips (``run.platform=cpu``); every checkpoint holds the selector, and
  the components a stage does not train stay as its warm start loaded
  them, the ST ``selector`` in stage 2 and ``selector_ac`` in stage 3
  among them.
- The policy overrides (``run.eval_policy``) exit for a frame-budget model,
  as the JAX package's do; ``run.quantize=int8`` evaluates the int8
  forward (``inference_q8_plus``).
- A JAX checkpoint of a frame-budget model (weights from a seeded
  generator, ``tests/torch_port_common.abstract_variables``) crosses to a
  port checkpoint through the weight bridge; both evaluate CLIs then give
  equal top-1 and top-5 and mAP within 1e-3 on the same synthetic clips.
"""

import os
import pathlib
import tempfile

import jax
import numpy as np
import pytest
import torch

from adafocus_torch import config as tconfig
from adafocus_torch.cli import evaluate as tevaluate
from adafocus_torch.cli import train as ttrain
from adafocus_torch.train import checkpoint as tckpt
from adafocus_torch.train.stages import TrainState as TTrainState
from adafocus_tpu import config as jconfig
from adafocus_tpu.cli import evaluate as jevaluate
from adafocus_tpu.train import checkpoint as jckpt
from adafocus_tpu.train.stages import TrainState
from tests.test_torch_port_data import TINY_MODEL
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.torch_port_common import abstract_variables, port_model

TOL = 1e-3
SYNTH = TINY_MODEL + ["run.platform=cpu", "run.synthetic_data=true",
                      "run.synthetic_videos=8", "run.print_freq=100", "run.epochs=1"]
PLUS = {"st": ["model.frame_budget=2"],
        "rl": ["model.frame_budget=2", "model.plus_rl=true"]}


@pytest.fixture
def ckpt_root():
    """A directory for a test's checkpoints, removed when the test ends (a
    checkpoint of the tiny configuration is about 190 MB)."""
    with tempfile.TemporaryDirectory() as d:
        yield pathlib.Path(d)


def _maker(fn) -> str:
    """The step maker whose closure ``fn`` is (its qualified name's head)."""
    inner = fn.__closure__[0].cell_contents if fn.__name__ == "<lambda>" else fn
    return inner.__qualname__.split(".")[0]


# (variant, stage) -> the train step's maker
_ROUTES = {("st", 0): "make_stage_train_step", ("st", 1): "make_plus_train_step",
           ("st", 2): "make_stage2_step", ("st", 3): "make_plus_train_step",
           ("rl", 1): "make_plus_train_step", ("rl", 2): "make_plus_stage2_joint_step",
           ("rl", 3): "make_plus_train_step"}


@pytest.mark.parametrize("variant,stage", sorted(_ROUTES), ids=lambda v: str(v))
def test_build_steps_routes_frame_budget(variant, stage):
    cfg = tconfig.load_config(None, SYNTH + PLUS[variant] + [f"run.stage={stage}"])
    state, _, _ = ttrain.build_state(cfg, 2, torch.device("cpu"), log=lambda msg: None)
    train, evaluate = ttrain.build_steps(cfg, state)
    assert _maker(train) == _ROUTES[variant, stage]
    assert _maker(evaluate) == "make_plus_eval_step"
    assert hasattr(state.model, "selector_ac" if variant == "rl" else "selector")


@pytest.mark.parametrize("variant", ["st", "rl"])
def test_port_cli_plus_trains_every_stage_and_evaluates(variant, ckpt_root):
    """Stages 1 -> 2 -> 3 through the port's train CLI, each warm-started
    from the one before, then evaluate: every checkpoint holds the selector
    (``selector_ac`` with ``plus_rl``), and what a stage does not train is
    its warm start's, bit for bit."""
    base = SYNTH + PLUS[variant]
    selector = "selector_ac" if variant == "rl" else "selector"
    # components a stage leaves as it loaded them (the ST selector trains in
    # stages 1 and 3, selector_ac in stage 2)
    frozen = {2: ("glancer", "focuser", "classifier") + (() if variant == "rl" else ("selector",)),
              3: ("glancer", "policy") + (("selector_ac",) if variant == "rl" else ())}
    prev = None
    for stage in (1, 2, 3):
        ck = str(ckpt_root / f"s{stage}")
        args = base + [f"run.stage={stage}", f"run.ckpt_dir={ck}"]
        if prev:
            args.append(f"run.warm_start={prev}")
        out = ttrain.main(args)
        assert out["epochs"][0]["steps"] == 2 and np.isfinite(out["best_acc"])
        tree = tckpt.load_checkpoint(ck)
        assert selector in tree["components"]
        if prev:
            before = tckpt.load_checkpoint(prev, best=True) or tckpt.load_checkpoint(prev)
            for comp in frozen[stage]:
                for k, v in getattr(out["state"].model, comp).state_dict().items():
                    assert torch.equal(v, before["components"][comp][k]), (stage, comp, k)
        prev = ck
    res = tevaluate.main(base + [f"run.resume={prev}", f"run.ckpt_dir={ckpt_root / 'ev'}"])
    assert set(res) == {"top1", "top5", "mAP"} and 0.0 <= res["mAP"] <= 1.0
    with pytest.raises(SystemExit, match="AdaFocus"):
        tevaluate.main(base + [f"run.resume={prev}", f"run.ckpt_dir={ckpt_root / 'ev'}",
                               "run.eval_policy=random"])
    res = tevaluate.main(base + [f"run.resume={prev}", f"run.ckpt_dir={ckpt_root / 'ev8'}",
                                 "run.quantize=int8"])
    assert set(res) == {"top1", "top5", "mAP"} and 0.0 <= res["mAP"] <= 1.0


@pytest.mark.parametrize("variant", ["st", "rl"])
def test_evaluate_clis_agree_on_carried_checkpoint(variant, ckpt_root, monkeypatch):
    args = SYNTH + PLUS[variant]
    jcfg, tcfg = jconfig.load_config(None, args), tconfig.load_config(None, args)
    jmodel, variables = abstract_variables(jcfg.model, seed=3)
    jdir, tdir = str(ckpt_root / "jax"), str(ckpt_root / "port")
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=None, step=np.int32(0))
    jckpt.save_checkpoint(jdir, state, 0, 0.5, 0.5)
    tree = jax.tree.map(np.asarray, jckpt.load_checkpoint(jdir))
    model = port_model(jcfg.model, {"params": tree["params"],
                                    "batch_stats": tree["batch_stats"]})
    tckpt.save_checkpoint(tdir, TTrainState(model, None, None), 0, 0.5, 0.5)
    assert tcfg.model.frame_budget == 2
    # the JAX CLI's fresh state is replaced by the checkpoint's weights: make
    # it without compiling the full-depth init
    monkeypatch.setattr(jevaluate, "create_train_state", lambda m, key: state)
    want = jevaluate.main(args + [f"run.resume={jdir}", f"run.ckpt_dir={ckpt_root / 'j'}"])
    got = tevaluate.main(args + [f"run.resume={tdir}", f"run.ckpt_dir={ckpt_root / 't'}"])
    assert got["top1"] == want["top1"] and got["top5"] == want["top5"], (got, want)
    assert abs(got["mAP"] - want["mAP"]) <= TOL, (got, want)
    assert os.path.exists(ckpt_root / "t" / "evaluate.log")
