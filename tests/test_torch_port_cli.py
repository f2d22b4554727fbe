"""The port's configuration, checkpoints and CLI, against the JAX package on
the CPU. The slice as a whole against the JAX CLI: tests/test_torch_port_slice.py
(evaluate) and tests/test_torch_port_train_cli.py (train).

- ``adafocus_torch.config`` gives the JAX package's values for
  ``configs/actnet_default.yaml`` plus overrides, field by field.
- Checkpoints: the round trip; a full resume through the CLI (epoch,
  ``LambdaLR`` count, SGD momentum, per-batch draws) lands on the same
  weights as an unbroken run; the stage warm start loads exactly
  ``STAGE_LOADS`` and keeps the fresh tensors whose shape disagrees.
- The port's train CLI runs stages 0 -> 1 -> 2 -> 3 and evaluate end to end
  on the CPU with ``run.platform=cpu``; without it and without a GPU both
  raise.
"""

import dataclasses
import os
import pathlib
import signal
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from adafocus_torch import config as tconfig
from adafocus_torch.cli import common as tcommon
from adafocus_torch.cli import evaluate as tevaluate
from adafocus_torch.cli import train as ttrain
from adafocus_torch.train import checkpoint as tckpt
from adafocus_torch.train.stages import create_train_state
from adafocus_tpu import config as jconfig
from tests.test_torch_port_data import TINY_MODEL, make_miniact
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)

SYNTH = TINY_MODEL + ["run.platform=cpu", "run.synthetic_data=true",
                      "run.synthetic_videos=8", "run.print_freq=100"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def miniact_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("miniact"))
    make_miniact(root)
    return root


@pytest.fixture
def ckpt_root():
    """A directory for a test's checkpoints, removed when the test ends: one
    checkpoint of the tiny configuration (full-depth backbones) is about
    190 MB, and pytest keeps the last runs' ``tmp_path`` directories."""
    with tempfile.TemporaryDirectory() as d:
        yield pathlib.Path(d)


def tiny_miniact(root: str):
    """benchmarks/miniact_harness.py's tiny profile (shared overrides)."""
    return TINY_MODEL + ["run.platform=cpu", "run.dataset=miniact",
                         f"run.data_root={root}", "loader.cache=host",
                         "run.print_freq=100"]


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def test_config_fields_equal_jax():
    over = ["run.stage=2", "model.dtype=float32", "model.num_classes=50",
            "optim.lr_steps=(5,7)", "ppo.reward_mode=prev", "loader.cache=device",
            "loader.batch_size=32", "augment.eval_crops=full_res", "run.family=actnet",
            "model.remat=false"]
    path = "configs/actnet_default.yaml"
    jcfg, tcfg = jconfig.load_config(path, over), tconfig.load_config(path, over)
    dtypes = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    compared = 0
    for section in ("run", "model", "optim", "ppo", "loader", "augment"):
        jsub, tsub = getattr(jcfg, section), getattr(tcfg, section)
        jfields = {f.name for f in dataclasses.fields(jsub)}
        for f in dataclasses.fields(tsub):
            assert f.name in jfields, f"{section}.{f.name} is not a field of JAX's config"
            want, got = getattr(jsub, f.name), getattr(tsub, f.name)
            if isinstance(got, torch.dtype):
                got, want = dtypes[got], np.dtype(want).name
            assert got == want, (section, f.name, got, want)
            compared += 1
        # every field of the JAX package's configuration is the port's
        assert not jfields - {f.name for f in dataclasses.fields(tsub)}, section
    assert compared > 80
    assert tcfg.model.dtype == torch.float32 and tcfg.loader.num_segments == 16
    assert "[model]" in tconfig.echo(tcfg)


@pytest.mark.parametrize("override,item", [
    ("model.frame_budget=4", 11), ("model.plus_rl=true", 11), ("model.selector_hidden=128", 11),
    ("model.classifier=linear", 10)])
def test_config_refuses_unported_keys(override, item):
    """The keys once refused as unported (ROADMAP items 10 and 11, both
    ported now) load as the JAX package loads them and reach the model: a
    frame budget builds the ST selector, ``plus_rl`` the selector
    actor-critic, ``selector_hidden`` their GRU's width, ``linear`` the
    linear head."""
    from adafocus_torch.models import classifiers as tclassifiers
    from adafocus_torch.models.gfv import GFV
    from adafocus_tpu import config as jcfg_mod

    over = TINY_MODEL + [override] + ([] if "frame_budget" in override or item == 10
                                      else ["model.frame_budget=4"])
    tcfg, jcfg = tconfig.load_config(None, over), jcfg_mod.load_config(None, over)
    name = override.split("=")[0].split(".")[1]
    assert getattr(tcfg.model, name) == getattr(jcfg.model, name)
    model = GFV(tcfg.model, device="cpu")
    if item == 10:
        assert isinstance(model.classifier, tclassifiers.LinearClassifier)
        return
    head = model.selector_ac if tcfg.model.plus_rl else model.selector
    assert head.gru.hidden_size == tcfg.model.selector_hidden
    assert hasattr(model, "selector") != tcfg.model.plus_rl


@pytest.mark.parametrize("override,item", [
    ("model.classifier=linear", 10), ("run.host_devices=4", 12), ("run.multihost=true", 12),
    ("run.platform=tpu", 12), ("run.quantize=int8", 14)])
def test_cli_refuses_unported_paths(override, item, tmp_path, monkeypatch):
    """The paths once refused as unported, each ported now: the linear head
    (item 10) trains a stage-1 epoch through the CLI; int8 serving (item
    14a) evaluates: it calibrates, prepares its int8 weights and reports
    top-1/5 and mAP; several devices (item 12) train a stage-1 epoch over
    four CPU ranks (a process tree of its own, killed after a time limit),
    rank 0 logging and writing the checkpoints; several hosts (item 12)
    raise a clear error without a coordinator or torchrun's environment.
    ``run.platform=tpu`` raises: the port runs on GPUs and the CPU."""
    args = SYNTH + [f"run.ckpt_dir={tmp_path}", override]
    if item == 10:
        from adafocus_torch.models import classifiers as tclassifiers

        out = ttrain.main(args + ["run.stage=1", "run.epochs=1"])
        assert isinstance(out["state"].model.classifier, tclassifiers.LinearClassifier)
        assert out["epochs"][0]["steps"] == 2 and np.isfinite(out["best_acc"])
        return
    if item == 14:
        res = tevaluate.main(args)
        assert set(res) == {"top1", "top5", "mAP"} and 0.0 <= res["mAP"] <= 1.0
        assert "int8 PTQ: prepared" in (tmp_path / "evaluate.log").read_text()
        return
    if override == "run.host_devices=4":
        proc = subprocess.Popen(
            [sys.executable, "-m", "adafocus_torch.cli.train", *args, "run.stage=1",
             "run.epochs=1"], cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"},
            start_new_session=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            out, _ = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
        assert proc.returncode == 0, out[-4000:]
        log = (tmp_path / "training.log").read_text()
        assert log.count("data-parallel over 4 ranks (gloo)") == 1
        assert "epoch 0: 2 steps" in log and log.count("checkpoint saved") == 1
        assert (tmp_path / "checkpoint.pt").exists() and (tmp_path / "model_best.pt").exists()
        return
    if override == "run.multihost=true":
        for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(var, raising=False)
        with pytest.raises(ValueError, match="run.multihost=true: no rendezvous"):
            ttrain.main(args)
        return
    with pytest.raises(NotImplementedError, match="run.platform=tpu"):
        ttrain.main(args)


def test_cli_needs_the_gpu_unless_asked(tmp_path):
    """Without run.platform=cpu both CLIs run on the GPU, and raise without
    one; nothing falls back to the CPU."""
    args = [a for a in SYNTH if a != "run.platform=cpu"] + [f"run.ckpt_dir={tmp_path}"]
    if torch.cuda.is_available():
        assert tcommon.select_device(tconfig.load_config(None, args).run).type == "cuda"
        return
    for main in (ttrain.main, tevaluate.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    opt = state.optimizer or state.ppo.optimizer
    for i, (p, s) in enumerate(opt.state.items()):
        for k, v in s.items():
            out[f"opt.{i}.{k}"] = v
    return out


def _assert_states_equal(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def _tiny_cfg(num_classes: int = 4):
    return tconfig.load_config(None, TINY_MODEL + [f"model.num_classes={num_classes}"]).model


@pytest.mark.parametrize("stage", [1, 2])
def test_checkpoint_round_trip(stage, ckpt_root):
    cfg = _tiny_cfg()
    state = create_train_state(cfg, stage, device="cpu",
                               generator=torch.Generator().manual_seed(1))
    b, t = 2, cfg.num_frames
    batch = {"frames": torch.randn(b, t, 32, 32, 3), "frames_small": torch.randn(b, t, 16, 16, 3),
             "labels": torch.tensor([1, 3])}
    step = ttrain.build_steps(dataclasses.replace(
        tconfig.load_config(None, TINY_MODEL), run=tconfig.RunConfig(stage=stage)), state)[0]
    step(batch, torch.Generator().manual_seed(2))
    tckpt.save_checkpoint(str(ckpt_root), state, epoch=3, acc=0.5, best_acc=0.75, is_best=True)
    assert sorted(os.listdir(ckpt_root)) == ["checkpoint.pt", "model_best.pt"]
    tree = tckpt.load_checkpoint(str(ckpt_root))
    assert tree["meta"] == {"epoch": 3, "acc": 0.5, "best_acc": 0.75}
    assert tckpt.best_acc_of(tree) == 0.75
    fresh = create_train_state(cfg, stage, device="cpu",
                               generator=torch.Generator().manual_seed(9))
    tckpt.restore_train_state(fresh, tree)
    _assert_states_equal(state, fresh)
    if stage == 1:
        assert fresh.scheduler.last_epoch == state.scheduler.last_epoch == 1
        assert fresh.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"]
    else:
        assert fresh.ppo.step == state.ppo.step == 1
    assert tckpt.load_checkpoint(str(ckpt_root / "absent")) is None


def test_warm_start_loads_exactly_stage_loads(ckpt_root):
    """A stage-1 checkpoint of a 5-class model warm-starts a 4-class stage 2:
    the glancer, focuser and classifier load, except their class heads,
    whose shapes disagree and stay fresh; the policy stays fresh."""
    src = create_train_state(_tiny_cfg(5), 1, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    for p in src.model.parameters():
        p.data.add_(1.0)   # every tensor off its fresh value
    tckpt.save_checkpoint(str(ckpt_root), src, 0, 0.1, 0.1)
    tree = tckpt.load_checkpoint(str(ckpt_root))
    dst = create_train_state(_tiny_cfg(4), 2, device="cpu",
                             generator=torch.Generator().manual_seed(2))
    fresh = {k: v.clone() for k, v in dst.model.state_dict().items()}
    tckpt.load_stage_components(dst, tree, 2)
    loaded = kept = 0
    for key, value in dst.model.state_dict().items():
        comp, rest = key.split(".", 1)
        ck = tree["components"][comp][rest]
        if comp in tckpt.STAGE_LOADS[2] and ck.shape == value.shape:
            assert torch.equal(value, ck), key
            loaded += 1
        else:
            assert torch.equal(value, fresh[key]), key
            kept += comp != "policy"
    assert loaded > 100 and kept >= 4   # the three class heads' weights and biases


def test_resume_continues_the_run(ckpt_root, monkeypatch):
    """Stage 1 for two epochs, against the same run killed after its first
    epoch's checkpoint and resumed: the same weights, momentum and schedule
    count, bit for bit."""
    common = SYNTH + ["run.stage=1", "run.epochs=2"]
    whole = ttrain.main(common + [f"run.ckpt_dir={ckpt_root / 'whole'}"])

    class Killed(Exception):
        pass

    save = tckpt.save_checkpoint

    def save_then_die(*args, **kwargs):
        save(*args, **kwargs)
        raise Killed

    monkeypatch.setattr(tckpt, "save_checkpoint", save_then_die)
    with pytest.raises(Killed):
        ttrain.main(common + [f"run.ckpt_dir={ckpt_root / 'part'}"])
    monkeypatch.setattr(tckpt, "save_checkpoint", save)
    tree = tckpt.load_checkpoint(str(ckpt_root / "part"))
    assert tree["meta"]["epoch"] == 0 and tree["scheduler"]["last_epoch"] == 2
    resumed = ttrain.main(common + [f"run.ckpt_dir={ckpt_root / 'part'}",
                                    f"run.resume={ckpt_root / 'part'}"])
    assert [e["epoch"] for e in resumed["epochs"]] == [1]
    _assert_states_equal(whole["state"], resumed["state"])
    assert resumed["state"].scheduler.last_epoch == 4


def test_port_cli_trains_every_stage_and_evaluates(miniact_root, ckpt_root):
    """Stages 0 -> 1 -> 2 -> 3 through the port's train CLI on the tiny
    miniact set, each warm-started from the one before, then evaluate with
    the learned and the random policy; the frozen components stay as the
    warm start left them."""
    base = tiny_miniact(miniact_root) + ["run.epochs=1"]
    prev = None
    for stage in range(4):
        ck = str(ckpt_root / f"s{stage}")
        args = base + [f"run.stage={stage}", f"run.ckpt_dir={ck}"]
        if prev:
            args.append(f"run.warm_start={prev}")
        out = ttrain.main(args)
        assert out["epochs"][0]["steps"] == 6 and out["host_frame_bytes"] > 0
        assert os.path.exists(os.path.join(ck, "checkpoint.pt"))
        if prev and stage >= 2:
            # every component stage 2 (3) does not train is the previous
            # stage's checkpoint's, bit for bit
            tree = tckpt.load_checkpoint(prev, best=True) or tckpt.load_checkpoint(prev)
            frozen = {2: ("glancer", "focuser", "classifier"),
                      3: ("glancer", "focuser", "policy")}[stage]
            for comp in frozen:
                for k, v in getattr(out["state"].model, comp).state_dict().items():
                    assert torch.equal(v, tree["components"][comp][k]), (stage, comp, k)
        prev = ck
    # center and oracle: test_evaluate_clis_agree
    for policy in ("learned", "random"):
        res = tevaluate.main(tiny_miniact(miniact_root) + [
            f"run.resume={prev}", f"run.ckpt_dir={ckpt_root / 'ev'}", f"run.eval_policy={policy}",
            "run.visualize_patches=2"])
        assert set(res) == {"top1", "top5", "mAP"} and 0.0 <= res["mAP"] <= 1.0
    assert os.path.exists(ckpt_root / "ev" / "patches.png")
