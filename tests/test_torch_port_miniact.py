"""The mini-ActivityNet recipe's pieces on the CPU: the port's dataset
generator against the JAX package's, and ``port_miniact.py``, the runner of
the recipe through the port's CLIs.

- ``adafocus_torch.data.miniact`` writes the same bytes as
  ``adafocus_tpu.data.miniact``: every frame, both split files, ``meta.json``
  and ``gt.npz``, for the JAX harness's tiny profile and at the flagship
  profile's 256^2 canvas and 16 frames (four videos, one a class: the
  fewest classes that give a video its three distractors), both through
  the module's command line.
- ``port_miniact.py --tiny --platform cpu --phases dataset,base,int8``
  writes every key of those phases, each finite, and each of its
  subprocesses ran a module of ``adafocus_torch``.
- Without a GPU and without ``--platform cpu`` it exits non-zero and runs
  nothing.
"""

import json
import math
import os
import subprocess
import sys

import pytest

from adafocus_torch.data import miniact as tminiact
from adafocus_tpu.data import miniact as jminiact
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.torch_port_common import scratch_path  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_GEN = ["--classes", "4", "--train-per-class", "6", "--val-per-class", "3",
            "--frames", "4", "--canvas", "64"]
FLAGSHIP_CANVAS_GEN = ["--classes", "4", "--train-per-class", "1", "--val-per-class", "0",
                       "--frames", "16", "--canvas", "256"]
RUNNER_TIMEOUT = 600


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


@pytest.mark.parametrize("gen", [TINY_GEN, FLAGSHIP_CANVAS_GEN], ids=["tiny", "flagship_canvas"])
def test_generated_dataset_is_byte_identical(gen, scratch_path):
    want, got = scratch_path / "jax", scratch_path / "port"
    jminiact.main(["--root", str(want)] + gen)
    tminiact.main(["--root", str(got)] + gen)
    files = _files(want)
    n_videos = int(gen[1]) * (int(gen[3]) + int(gen[5]))
    frames = int(gen[7])
    assert len([f for f in files if f.endswith(".jpg")]) == n_videos * frames
    assert {"train_split.txt", "val_split.txt", "meta.json", "gt.npz"} <= set(files)
    assert _files(got) == files
    for name in files:
        assert (want / name).read_bytes() == (got / name).read_bytes(), name


def _runner(args, cwd):
    return subprocess.run([sys.executable, os.path.join(ROOT, "port_miniact.py"), *args],
                          cwd=cwd, capture_output=True, text=True, timeout=RUNNER_TIMEOUT,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})


def test_runner_tiny_on_cpu(scratch_path):
    """Stages 0 -> 3 and both int8 evaluations of the tiny profile; the
    best top-1 of each stage and the int8 rows finite."""
    results = scratch_path / "results.json"
    proc = _runner(["--tiny", "--platform", "cpu", "--phases", "dataset,base,int8",
                    "--dataset", str(scratch_path / "data"),
                    "--workdir", str(scratch_path / "work"), "--results", str(results)],
                   scratch_path)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    res = json.loads(results.read_text())
    for key in ("train/s0", "train/s1", "train/s2", "train/s3"):
        assert math.isfinite(res[key]) and 0.0 <= res[key] <= 1.0, key
    for key in ("eval/int8", "eval/int8_heads"):
        assert set(res[key]) == {"top1", "top5", "mAP"}, key
        assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in res[key].values()), key
    runs = res["runs"]
    assert set(runs) == {"dataset", "train_s0", "train_s1", "train_s2", "train_s3",
                         "eval_eval/int8", "eval_eval/int8_heads"}
    assert all(r["module"].startswith("adafocus_torch.") and r["seconds"] > 0
               for r in runs.values()), runs
    commands = [ln for ln in proc.stdout.splitlines() if ln.startswith("  $ ")]
    assert len(commands) == len(runs)
    assert all(ln.startswith("  $ python -m adafocus_torch.") for ln in commands), commands
    assert res["device"] == "cpu"
    assert set(res["phase_seconds"]) == {"dataset", "base", "int8"}


def test_runner_needs_the_gpu_unless_asked(scratch_path):
    """On a machine without a GPU the runner refuses unless --platform cpu,
    before it writes a dataset or a result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; the refusal is for machines without one")
    proc = _runner(["--tiny", "--dataset", str(scratch_path / "data"),
                    "--workdir", str(scratch_path / "work"),
                    "--results", str(scratch_path / "results.json")], scratch_path)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--platform cpu" in proc.stderr
    assert not (scratch_path / "data").exists() and not (scratch_path / "results.json").exists()


def _port_miniact():
    """``port_miniact.py`` as a module, loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("port_miniact",
                                                  os.path.join(ROOT, "port_miniact.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_parse_curve_reads_every_validation():
    out = ("epoch 0: 38 steps\n  * val: top1=0.0200 top5=0.0975 mAP=0.0372\n"
           "  * checkpoint saved\nepoch 1: 38 steps\n  * val: top1=0.5650 top5=0.9600 mAP=0.6661\n")
    curve = _port_miniact().parse_curve(out)
    assert curve == {"top1": [0.02, 0.565], "top5": [0.0975, 0.96], "mAP": [0.0372, 0.6661]}
    assert _port_miniact().parse_curve("  * val: top1=0.5000 top5=1.0000\n") == \
        {"top1": [0.5], "top5": [1.0]}


def test_merge_adds_new_keys_only_and_the_spread(scratch_path):
    """``--merge``: another call's keys that the results lack are added with
    their runs' seconds; no key the results have changes (nor ``device``);
    the stage-0 spread is computed over every seed's row."""
    mod = _port_miniact()
    mine, other = scratch_path / "mine.json", scratch_path / "other.json"
    base = {"runs": {"dataset": {"seconds": 1.0}}, "device": "card A", "train/s0": 0.62,
            "s0seeds/bfloat16@1": {"best_top1": 0.6, "first_epoch_ge_0.5": 18, "curve": {}}}
    mine.write_text(json.dumps(base))
    other.write_text(json.dumps({
        "runs": {"dataset": {"seconds": 2.0}, "train_s0seed_bfloat16_2": {"seconds": 3.0}},
        "device": "card B", "train/s0": 0.9, "phase_seconds": {"s0seeds": 4.0},
        "s0seeds/bfloat16@2": {"best_top1": 0.9, "first_epoch_ge_0.5": 12, "curve": {}},
        "s0seeds/bfloat16@3": {"best_top1": 0.3, "first_epoch_ge_0.5": None, "curve": {}}}))
    assert mod.main(["--results", str(mine), "--merge", str(other)]) == 0
    got = json.loads(mine.read_text())
    for key in ("device", "train/s0", "s0seeds/bfloat16@1"):
        assert got[key] == base[key], key
    assert "phase_seconds" not in got
    assert got["runs"] == {"dataset": {"seconds": 1.0}, "train_s0seed_bfloat16_2": {"seconds": 3.0}}
    spread = got["s0seeds/bfloat16"]
    assert spread["n_seeds"] == 3 and spread["n_never"] == 1
    assert math.isclose(spread["best_top1"], 0.6) and math.isclose(spread["first_epoch_ge_0.5"], 15)
    assert math.isclose(spread["best_top1_std"], math.sqrt(0.06))
    assert spread["per_seed_first_epoch_ge_0.5"] == {"1": 18, "2": 12, "3": None}
