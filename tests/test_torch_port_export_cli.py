"""The port's export CLI (adafocus_torch/cli/export.py) on the CPU, the
counterpart of tests/test_cli.py's export step: a tiny checkpoint that the
port's train CLI writes (stage 1, one epoch of synthetic clips), exported
with ``--batch 2 run.platform=cpu`` in bf16 and with ``run.quantize=int8
run.quantize_batches=1``. Each run says ``exported {mode} artifact`` on
stdout and in ``export.log``, writes more than 1e6 bytes, and the reloaded
artifact serves the eager forward of the same checkpoint within atol =
rtol = 1e-5 (int8: on scales calibrated from the same validation batch,
``calibrate_from_loader``). Without ``run.platform=cpu`` and with no GPU
it raises; an unknown ``run.quantize`` exits.
"""

import os
import pathlib
import tempfile

import numpy as np
import pytest
import torch

from adafocus_torch import serving as tserving
from adafocus_torch.benchmark import inference_fn, make_data
from adafocus_torch.cli import common as tcommon
from adafocus_torch.cli import evaluate as tevaluate
from adafocus_torch.cli import export as texport
from adafocus_torch.cli import train as ttrain
from adafocus_torch.config import load_config
from adafocus_torch.models import quant_inference as tqi
from adafocus_torch.train import checkpoint as tckpt
from tests.test_torch_port_data import TINY_MODEL
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)

SYNTH = TINY_MODEL + ["run.platform=cpu", "run.synthetic_data=true",
                      "run.synthetic_videos=8", "run.print_freq=100", "run.epochs=1"]


@pytest.fixture(scope="module")
def checkpoint():
    """A stage-1 checkpoint of the tiny configuration from the port's train
    CLI, removed when the module ends (about 190 MB)."""
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "s1")
        ttrain.main(SYNTH + ["run.stage=1", f"run.ckpt_dir={ck}"])
        yield pathlib.Path(d), ck


def _eager(args, mode):
    """The eager forward of the checkpoint the CLI exported, as the CLI
    builds and (int8) calibrates it."""
    cfg = load_config(None, args)
    model = tcommon.build_model(cfg, torch.device("cpu"))
    tckpt.load_components(model, tckpt.load_checkpoint(cfg.run.resume))
    if mode == "bf16":
        return cfg, inference_fn(model)
    loader = tcommon.build_loader(cfg, train=False, device=torch.device("cpu"))
    prep = tcommon.make_batch_prep(cfg, train=False, device=torch.device("cpu"))
    scales = tevaluate.calibrate_from_loader(model, loader, prep, cfg, 1)
    qw = tqi.prepare_q8(model, scales)
    forward = tqi.family_q8(cfg.model)
    return cfg, lambda f, s: forward(model, scales, f, s, device="cpu", qw=qw)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_export_cli_serves_the_checkpoint(mode, checkpoint, capsys):
    root, ck = checkpoint
    path = str(root / f"{mode}.pt2")
    args = SYNTH + [f"run.resume={ck}", f"run.ckpt_dir={root / ('ex' + mode)}"]
    if mode == "int8":
        args += ["run.quantize=int8", "run.quantize_batches=1"]
    assert texport.main(["--path", path, "--batch", "2"] + args) == path
    out = capsys.readouterr().out
    assert f"exported {mode} artifact: {path}" in out and "device=cpu" in out
    with open(root / ("ex" + mode) / "export.log") as f:
        assert f"exported {mode} artifact" in f.read()
    assert os.path.getsize(path) > 1e6

    cfg, eager = _eager(args, mode)
    data = make_data(cfg.model, 2, device="cpu", seed=3)
    got = tserving.load_exported(path)(data["frames"], data["frames_small"])
    want = eager(data["frames"], data["frames_small"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_export_cli_refusals(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="run.quantize"):
        texport.main(["--path", str(tmp_path / "m.pt2")] + SYNTH
                     + [f"run.ckpt_dir={tmp_path}", "run.quantize=int4"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    no_cpu = [a for a in SYNTH if a != "run.platform=cpu"]
    with pytest.raises(RuntimeError, match="run.platform=cpu"):
        texport.main(["--path", str(tmp_path / "m.pt2")] + no_cpu + [f"run.ckpt_dir={tmp_path}"])
