"""The port's tooling against the JAX package's, on the CPU: trace
attribution (adafocus_torch/utils/profiling.py), the FLOP counter
(adafocus_torch/ops/flops.py) and the device lock
(adafocus_torch/utils/device_lock.py).

- ``_group_key`` on tests/test_profiling.py's cases; ``op_breakdown`` and
  ``top_ops`` on a trace written by hand in torch.profiler's Chrome format
  (device kernels, copies and memsets counted; the host's operators,
  runtime calls and annotations and the device's annotation lane skipped);
  ``trace()`` around a CPU function writes a file that ``_find_trace_file``
  finds; ``StepTimer`` counts.
- ``flops`` of a batched matmul equals JAX's ``xla_flops``, 2·B·M·N·K; on the
  tiny GFV forward its ratio to JAX's count is the one ``ops/flops.py``
  states, within 10%.
- The device lock's protocol as tests/test_utils_aux.py holds JAX's, plus
  the divergences the port must not copy: a pid <= 0 is not a live holder,
  and ``device_lock`` never overwrites a live holder's lock.
"""

import gzip
import json
import os
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adafocus_torch.benchmark import inference_fn, make_data
from adafocus_torch.models import gfv as tgfv
from adafocus_torch.ops import flops as tflops
from adafocus_torch.utils import device_lock as tlock
from adafocus_torch.utils import profiling as tprof
from adafocus_tpu import benchmark as jbench
from adafocus_tpu.ops import flops as jflops
from adafocus_tpu.utils.profiling import _group_key as jgroup_key
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.torch_port_common import TINY, abstract_variables, port_config

# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

GROUP_CASES = ["fusion.123", "my_op.4.clone", "copy", "jit_glance/fusion.7",
               "jit_focus/fusion.3", "jit_fn/region/op.12",
               "void patch_kernel<__nv_bfloat16>(PatchArgs)", "Memcpy DtoD (Device -> Device)"]


@pytest.mark.parametrize("name", GROUP_CASES)
def test_group_key_matches_jax(name):
    assert tprof._group_key(name) == jgroup_key(name)


def _event(cat, name, ts, dur, pid=0, tid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def _hand_trace() -> dict:
    """A torch.profiler Chrome trace: one forward's host lane (an operator,
    its runtime launches, an annotation) and its device lane (kernels, a
    copy, a memset, the annotation's device projection)."""
    host, dev = 4242, 0
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": host, "args": {"name": "python3"}},
        {"ph": "M", "name": "process_name", "pid": dev, "args": {"name": "GPU 0"}},
        _event("user_annotation", "extract", 0, 500, pid=host, tid=1),
        _event("cpu_op", "aten::conv2d", 10, 300, pid=host, tid=1),
        _event("cuda_runtime", "cudaLaunchKernel", 20, 5, pid=host, tid=1, correlation=1),
        _event("gpu_user_annotation", "extract", 30, 900, pid=dev),
        _event("kernel", "void patch_kernel<__nv_bfloat16>(PatchArgs)", 40, 48.5, pid=dev,
               correlation=1),
        _event("kernel", "void patch_kernel<__nv_bfloat16>(PatchArgs)", 140, 51.5, pid=dev,
               correlation=2),
        _event("kernel", "fusion.3", 200, 90, pid=dev),
        _event("kernel", "fusion.12", 300, 250, pid=dev),
        _event("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 600, 20, pid=dev),
        _event("gpu_memset", "Memset (Device)", 650, 2, pid=dev),
        {"ph": "i", "cat": "kernel", "name": "instant", "pid": dev, "ts": 700},
    ]}


@pytest.mark.parametrize("gz", [False, True])
def test_op_breakdown_and_top_ops_on_a_hand_written_trace(tmp_path, gz):
    path = tmp_path / "sub" / ("host_1.123.pt.trace.json" + (".gz" if gz else ""))
    path.parent.mkdir()
    with (gzip.open if gz else open)(path, "wt") as f:
        json.dump(_hand_trace(), f)
    (tmp_path / "notes.json").write_text("{}")   # not a trace
    assert tprof._find_trace_file(str(tmp_path)) == str(path)
    raw = tprof.op_breakdown(str(tmp_path))
    assert raw == {"void patch_kernel<__nv_bfloat16>(PatchArgs)": (0.1, 2),
                   "fusion.3": (0.09, 1), "fusion.12": (0.25, 1),
                   "Memcpy DtoD (Device -> Device)": (0.02, 1), "Memset (Device)": (0.002, 1)}
    top = tprof.top_ops(str(tmp_path), n=2)
    assert [(name, n) for name, _, n in top] == [
        ("fusion", 2), ("void patch_kernel<__nv_bfloat16>(PatchArgs)", 2)]
    assert [ms for _, ms, _ in top] == pytest.approx([0.34, 0.1])
    rows = tprof.top_ops(str(path), n=10, group=False)
    assert [r[0] for r in rows][:3] == ["fusion.12", "void patch_kernel<__nv_bfloat16>(PatchArgs)",
                                        "fusion.3"] and len(rows) == 5
    assert sum(r[1] for r in rows) == pytest.approx(0.462)
    assert [e["ts"] for e in tprof.device_events(tprof.load_trace(str(path)))] == \
        [40, 140, 200, 300, 600, 650]


def test_trace_writes_a_findable_trace(tmp_path):
    a = torch.randn(64, 64)
    with tprof.trace(str(tmp_path)) as prof:
        (a @ a).relu_()
    assert prof is not None
    path = tprof._find_trace_file(str(tmp_path))
    assert re.fullmatch(r".+_\d+\.\d+\.pt\.trace\.json", os.path.basename(path))
    names = {e.get("name") for e in tprof.load_trace(str(tmp_path))}
    assert "aten::mm" in names and "aten::relu_" in names
    assert tprof.op_breakdown(str(tmp_path)) == {}   # no device on the CPU
    with tprof.trace(str(tmp_path), "named.json"):
        a.sum()
    assert any(e.get("name") == "aten::sum"
               for e in tprof.load_trace(str(tmp_path / "named.json")))


def test_step_timer():
    t = tprof.StepTimer()
    t.data_ready()
    t.step_done({"loss": torch.zeros(()), "parts": [torch.ones(2), 3.0]})
    t.data_ready()
    t.step_done()
    assert t.count == 2 and t.step_time >= 0 and t.data_time >= 0
    assert "ms/step" in t.summary()


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------


def test_flops_of_a_matmul_match_xla():
    a = np.zeros((8, 64, 32), np.float32)
    b = np.zeros((8, 32, 16), np.float32)
    want = 2 * 8 * 64 * 32 * 16
    got = tflops.flops(torch.bmm, torch.from_numpy(a), torch.from_numpy(b))
    assert got == want == jflops.xla_flops(lambda x, y: jnp.einsum("bij,bjk->bik", x, y),
                                           jnp.asarray(a), jnp.asarray(b))
    assert tflops.gflops_per_video(torch.bmm, 8, torch.from_numpy(a),
                                   torch.from_numpy(b)) == want / 8 / 1e9


def test_flops_of_the_tiny_forward_against_xla():
    """The ratio that ``ops/flops.py``'s docstring states, within 10%."""
    stated = float(re.search(r"counts\s+([\d.]+) times JAX's count",
                             tflops.__doc__).group(1))
    b = 2
    model = tgfv.GFV(port_config(TINY), device="cpu")
    data = make_data(model.cfg, b, device="cpu")
    port = tflops.flops(inference_fn(model, "off"), data["frames"], data["frames_small"])
    jmodel, variables = abstract_variables(TINY)   # the count needs shapes only
    jdata = jbench.make_data(TINY, b)
    xla = jflops.xla_flops(jbench._inference_fn(jmodel, fused="off"), variables["params"],
                           variables["batch_stats"], jdata["frames_flat"],
                           jdata["frames_small"], jax.random.key(1))
    ratio = port / xla
    assert abs(ratio / stated - 1) <= 0.1, ratio


# ---------------------------------------------------------------------------
# the device lock
# ---------------------------------------------------------------------------


def _write_lock(path, pid, note="train"):
    with open(path, "w") as f:
        json.dump({"pid": pid, "note": note}, f)


def test_device_lock_advisory_protocol(tmp_path):
    """JAX's protocol: wait for a live holder, treat a dead or corrupt lock
    as free, clean up on exit."""
    path = str(tmp_path / "gpu.lock")
    assert tlock.wait_for_device(path=path, timeout_secs=0.1, poll_secs=0.01)
    with tlock.device_lock(note="train", path=path):
        assert tlock._holder(path) == (os.getpid(), "train")
        t0 = time.time()
        assert not tlock.wait_for_device(path=path, timeout_secs=0.3, poll_secs=0.05)
        assert time.time() - t0 >= 0.3
    assert not os.path.exists(path)
    _write_lock(path, 2 ** 22 + 12345, "crashed")
    assert tlock.wait_for_device(path=path, timeout_secs=5, poll_secs=0.01)
    with open(path, "w") as f:
        f.write("not json")
    assert tlock.wait_for_device(path=path, timeout_secs=5, poll_secs=0.01)
    with tlock.device_lock(note="after a crash", path=path):   # a stale lock is broken
        assert tlock._holder(path) == (os.getpid(), "after a crash")
    assert not os.path.exists(path)


@pytest.mark.parametrize("pid", [0, -1])
def test_device_lock_pid_not_positive_is_free(tmp_path, pid):
    """JAX's lock takes pid 0 or -1 for a live holder (``os.kill`` probes a
    process group); the port's does not."""
    path = str(tmp_path / "gpu.lock")
    _write_lock(path, pid)
    assert tlock._holder(path) is None
    assert tlock.wait_for_device(path=path, timeout_secs=5, poll_secs=0.01)


def test_device_lock_waits_for_a_live_holder(tmp_path, monkeypatch):
    """JAX's ``device_lock`` overwrites a live holder's lock; the port's
    raises with the holder's pid and note, leaves the lock as it was, and
    takes it once the holder has gone."""
    path = str(tmp_path / "gpu.lock")
    holder = os.getppid()   # a live process
    _write_lock(path, holder, "bench sweep")
    with pytest.raises(TimeoutError, match=rf"pid {holder} \('bench sweep'\)"):
        with tlock.device_lock(note="train", path=path, timeout_secs=0.2, poll_secs=0.02):
            pass
    assert tlock._holder(path) == (holder, "bench sweep")
    monkeypatch.setenv("ADAFOCUS_BENCH_WAIT_SECS", "0.1")   # the default timeout
    assert not tlock.wait_for_device(path=path, poll_secs=0.02)
    releaser = threading.Timer(0.2, os.remove, (path,))
    releaser.start()
    try:
        with tlock.device_lock(note="train", path=path, timeout_secs=10, poll_secs=0.02):
            assert tlock._holder(path) == (os.getpid(), "train")
    finally:
        releaser.join(timeout=10)
    assert not releaser.is_alive() and not os.path.exists(path)
