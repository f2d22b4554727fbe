"""The port's train CLI over several processes on the CPU (gloo), and the
data-parallel dry run.

- ``run.host_devices=2``, stage 3, float64 (the workers' ``cli64``), one
  epoch, against the same run in one process: each rank trains on its rows
  of the global batch the one process forms, so the classifier's update
  (the only component stage 3 trains; the frozen backbones run in eval
  mode) agrees within 1e-6 relative as a whole (float64 rounding of the
  averaged gradient); every rank validates the whole set, so mAP and
  top-1/5 are equal; rank 0 alone logs and writes the checkpoint pair.
- ``run.multihost=true``, two processes joined at a ``file://`` coordinator,
  one stage-1 epoch (the counterpart of tests/test_multihost.py:122): both
  exit 0, their train and validation record shards are disjoint and cover
  the set, their final weights are bit-identical and their (gathered)
  validation results equal.
- ``python -m adafocus_torch.parallel.dryrun --ranks 2 --platform cpu``
  exits 0.

Every run is a process tree of its own, started together at the module's
start with ``PYTHONHASHSEED=0`` (the synthetic frames hash the record's
path, which Python salts per process) and one torch thread a process, and
killed if it outlives ``TIMEOUT``.
"""

import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from tests.test_torch_port_data import TINY_MODEL, one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.torch_port_common import removed_after

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 400
SYNTH = TINY_MODEL + ["run.platform=cpu", "run.synthetic_data=true", "run.print_freq=100",
                      "run.epochs=1"]
VIDEOS = 8


def _start(args, log):
    env = {**os.environ, "PYTHONHASHSEED": "0", "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                            start_new_session=True, stdout=log, stderr=subprocess.STDOUT)


def _finish(proc, log_path):
    """(exit code, output); kills the process tree at ``TIMEOUT``."""
    try:
        proc.wait(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    with open(log_path) as f:
        return proc.returncode, f.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(directory, {job: (exit code, output)}); the directory, with the
    runs' checkpoints and results, is removed after the module's tests."""
    tmp = tmp_path_factory.mktemp("parallel_cli")
    with removed_after(tmp):
        yield _runs(tmp)


def _runs(tmp):
    worker = ["-m", "tests.torch_port_parallel_workers"]
    stage3 = SYNTH + ["run.stage=3", "model.dtype=float64", f"run.synthetic_videos={VIDEOS}"]
    stage1 = SYNTH + ["run.stage=1", f"run.synthetic_videos={VIDEOS}"]
    jobs = {
        "ranks": worker + ["cli64", str(tmp), "2", *stage3, f"run.ckpt_dir={tmp / 'ranks'}"],
        "one": worker + ["cli64", str(tmp / "one"), "1", *stage3,
                         f"run.ckpt_dir={tmp / 'one'}"],
        **{f"host{i}": worker + ["multihost", str(tmp / f"host{i}"), *stage1,
                                 f"run.ckpt_dir={tmp / 'hosts'}", "run.multihost=true",
                                 f"run.coordinator=file://{tmp / 'rendezvous'}",
                                 "run.num_processes=2", f"run.process_id={i}"]
           for i in range(2)},
        "dryrun": ["-m", "adafocus_torch.parallel.dryrun", "--ranks", "2", "--platform", "cpu"],
    }
    for d in ("one", "host0", "host1"):
        (tmp / d).mkdir()
    procs = {}
    for name, args in jobs.items():
        with open(tmp / f"{name}.log", "w") as log:
            procs[name] = _start(args, log)
    done = {name: _finish(p, tmp / f"{name}.log") for name, p in procs.items()}
    return tmp, done


def _ok(done, name):
    rc, out = done[name]
    assert rc == 0, f"{name} exited {rc}:\n{out[-4000:]}"
    return out


def test_host_devices_matches_one_process(runs):
    tmp, done = runs
    _ok(done, "ranks"), _ok(done, "one")
    ranks = torch.load(tmp / "result.pt", weights_only=False)
    one = torch.load(tmp / "one" / "result.pt", weights_only=False)
    assert ranks["val"] == one["val"] and len(one["val"]) == 1
    assert set(one["val"][0]) == {"top1", "top5", "mAP"}
    assert [e["steps"] for e in ranks["epochs"]] == [e["steps"] for e in one["epochs"]] == [2]
    assert ranks["epochs"][0]["videos"] == one["epochs"][0]["videos"] == VIDEOS
    init, got, want = one["initial"], ranks["final"], one["final"]
    for key in init:
        assert torch.equal(ranks["initial"][key], init[key]), key
    got_u = torch.cat([(got[k] - init[k]).flatten() for k in init])
    want_u = torch.cat([(want[k] - init[k]).flatten() for k in init])
    assert want_u.abs().max() > 0
    assert float((got_u - want_u).norm() / want_u.norm()) <= 1e-6


def test_host_devices_rank0_logs_and_checkpoints(runs):
    tmp, done = runs
    _ok(done, "ranks")
    assert sorted(os.listdir(tmp / "ranks")) == ["checkpoint.pt", "model_best.pt",
                                                 "training.log"]
    log = (tmp / "ranks" / "training.log").read_text()
    assert log.count("data-parallel over 2 ranks (gloo), each training on its rows") == 1
    assert log.count("checkpoint saved") == 1 and log.count("done. best acc") == 1


def test_multihost_two_processes(runs):
    tmp, done = runs
    for i in range(2):
        _ok(done, f"host{i}")
    res = [json.loads((tmp / f"host{i}" / "result.json").read_text()) for i in range(2)]
    for split in ("train", "val"):
        a, b = (set(r["shards"][split]) for r in res)
        assert a and b and not a & b, split
        assert a | b == {f"synthetic{i}" for i in range(VIDEOS)}, split
    assert res[0]["digest"] == res[1]["digest"]
    assert res[0]["best_acc"] == res[1]["best_acc"]
    log = (tmp / "hosts" / "training.log").read_text()
    assert log.count("each reading its record shard") == 1
    assert os.path.exists(tmp / "hosts" / "checkpoint.pt")


def test_dryrun_two_cpu_ranks(runs):
    _, done = runs
    out = _ok(done, "dryrun")
    assert "dryrun --ranks 2 --platform cpu ok: five data-parallel steps" in out
