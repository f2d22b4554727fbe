"""The port's tooling against the JAX package's, on the CPU: trace
attribution (adafocus_torch/utils/profiling.py), the FLOP counter
(adafocus_torch/ops/flops.py) and the device lock
(adafocus_torch/utils/device_lock.py).

- ``_group_key`` on tests/test_profiling.py's cases; ``op_breakdown`` and
  ``top_ops`` on a trace written by hand in torch.profiler's Chrome format
  (device kernels, copies and memsets counted; the host's operators,
  runtime calls and annotations and the device's annotation lane skipped);
  ``trace()`` around a CPU function writes a file that ``_find_trace_file``
  finds.
- The device-time helper: ``device_ms`` and ``per_call_ms`` give None on
  the CPU's profiler events (host operators only), live (``as_trace_events``)
  or written; ``per_call_ms`` sums the kernel spans of a trace of N calls
  and divides by N, the host's lanes, the annotations and the gaps left
  out, and gives None where spans went missing (a name's count that is not
  a multiple of N, or not N times its count in a one-call profile);
  ``host_bound`` is True exactly where events exceed the
  device time by more than 1.5x.
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


def test_device_time_of_cpu_profiler_events_is_none(tmp_path):
    """On the CPU the profiler records host operators only: no device time,
    from a live profile (``as_trace_events``) or from its written trace."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(32, 32)
    assert tprof.device_ms(lambda: a @ a, iters=3) is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            a @ a
    live = tprof.as_trace_events(prof.events())
    assert [e["name"] for e in live].count("aten::mm") == 3
    assert {e["cat"] for e in live} == {"cpu_op"} and tprof.per_call_ms(live, 3) is None
    with tprof.trace(str(tmp_path), "cpu.json"):
        for _ in range(3):
            a @ a
    events = tprof.load_trace(str(tmp_path / "cpu.json"))
    assert any(e.get("name") == "aten::mm" for e in events)
    assert tprof.per_call_ms(events, 3) is None


def _calls_trace(calls: int, kernel_us, launch_us: float, names=None) -> list:
    """A trace of ``calls`` calls: each an operator whose runtime launches,
    ``launch_us`` apart, start one kernel of each duration of ``kernel_us``
    on the device (named by ``names``, default all ``conv_kernel``), and an
    annotation range over the call on both lanes."""
    host, dev, events, corr = 4242, 0, [], 0
    for c in range(calls):
        t0 = c * 1000
        events.append(_event("user_annotation", "call", t0, 900, pid=host, tid=1))
        events.append(_event("gpu_user_annotation", "call", t0 + 5, 800, pid=dev))
        events.append(_event("cpu_op", "adafocus_torch::int8_conv", t0 + 1, 800, pid=host,
                             tid=1))
        for i, dur in enumerate(kernel_us):
            corr += 1
            ts = t0 + 10 + i * launch_us
            events.append(_event("cuda_runtime", "cudaLaunchKernel", ts, 3, pid=host, tid=1,
                                 correlation=corr))
            events.append(_event("kernel", names[i] if names else "conv_kernel", ts + 4,
                                 dur, pid=dev, correlation=corr))
    return events


@pytest.mark.parametrize("calls,kernel_us", [(1, (7.5,)), (20, (2.25,)), (3, (40.0, 1.5))],
                         ids=["one", "many", "split_k"])
def test_per_call_ms_sums_the_kernel_spans_a_call(calls, kernel_us):
    """The device's spans (kernels, copies, memsets) summed and divided by
    the calls, in ms; the host's operators, launches and annotations and the
    device's annotation lane left out, as are the gaps between spans."""
    events = _calls_trace(calls, kernel_us, launch_us=100.0)
    assert tprof.per_call_ms(events, calls) == pytest.approx(sum(kernel_us) / 1e3)
    # the hand-written trace: kernels 48.5 + 51.5 + 90 + 250, a copy 20, a memset 2 (us),
    # one call's; its names' counts (2, 1, 1, 1, 1) are no two or three calls' alike
    assert tprof.per_call_ms(_hand_trace()["traceEvents"], 1) == pytest.approx(0.462)
    assert tprof.per_call_ms(_hand_trace()["traceEvents"], 2) is None
    assert tprof.per_call_ms(_hand_trace()["traceEvents"], 3) is None


def test_per_call_ms_refuses_a_trace_that_lost_spans():
    """A profile that kept some calls' spans and lost others' (the device's
    timestamps past the host's capture window) is no measurement: None,
    where a plain sum would read a shorter call."""
    events = _calls_trace(20, (1330.0,), launch_us=100.0)
    kernels = [i for i, e in enumerate(events) if e["cat"] == "kernel"]
    assert tprof.per_call_ms(events, 20) == pytest.approx(1.33)
    late_lost = [e for i, e in enumerate(events) if i not in kernels[-7:]]
    assert tprof.per_call_ms(late_lost, 20) is None
    two_a_call = _calls_trace(4, (40.0, 1.5), launch_us=100.0)
    one_lost = [e for e in two_a_call if not (e["cat"] == "kernel" and e["dur"] == 1.5
                                              and e["ts"] > 3000)]
    assert tprof.per_call_ms(one_lost, 4) is None


def _last_calls_lost(calls: int, lost: int, names) -> list:
    """A trace of ``calls`` calls of two kernels (40 and 1.5 us, named by
    ``names``) whose last ``lost`` calls' device spans went missing."""
    events = _calls_trace(calls, (40.0, 1.5), launch_us=100.0, names=names)
    return [e for e in events if not (e["cat"] == "kernel" and e["ts"] >= (calls - lost) * 1000)]


@pytest.mark.parametrize("names", [("conv_kernel", "splitk_finish"), ("conv_kernel",) * 2],
                         ids=["two_names", "one_name"])
def test_per_call_ms_refuses_whole_calls_lost(names):
    """Two spans a call, the last half of the calls lost: a span count that
    is still a multiple of the calls. Refused where the two kernels differ
    by name (each name's count is no multiple), and, where they share one,
    against a one-call profile (``reference``): its count a call times the
    calls. The whole trace is accepted against the same reference."""
    calls = 20
    reference = _calls_trace(1, (40.0, 1.5), launch_us=100.0, names=names)
    whole = _calls_trace(calls, (40.0, 1.5), launch_us=100.0, names=names)
    lost = _last_calls_lost(calls, calls // 2, names)
    assert len(tprof.device_events(lost)) == calls
    assert tprof.per_call_ms(whole, calls, reference) == pytest.approx(0.0415)
    assert tprof.per_call_ms(lost, calls, reference) is None
    if names[0] != names[1]:
        assert tprof.per_call_ms(lost, calls) is None
    else:   # without the reference, indistinguishable from one span a call
        assert tprof.per_call_ms(lost, calls) == pytest.approx(0.0415 / 2)
    other = _calls_trace(1, (40.0,), launch_us=100.0, names=("dw_kernel",))
    assert tprof.per_call_ms(whole, calls, other) is None


@pytest.mark.parametrize("events,device,want", [
    (0.0669, 0.0257, True), (0.75, 0.5, False), (0.7501, 0.5, True), (3.977, 0.5, True),
    (22.6, 22.4, False), (0.1, None, None)],
    ids=["patch_n512", "at_1.5x", "above_1.5x", "int8_heads", "fused_blocks", "unmeasured"])
def test_host_bound_follows_the_1_5x_rule(events, device, want):
    assert tprof.HOST_BOUND_RATIO == 1.5
    assert tprof.host_bound(events, device) is want


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
