"""The trace arithmetic on a hand-written trace: the window, the device's
busy time and idle share, spans attributed to the host's ranges by launch
correlation, the patch kernel's roofline share, the breakdown."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from perfbench import common, peaks, tracing  # noqa: E402


def _ann(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _kernel(name, corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def trace():
    """Two requests (host ranges at 0 and 100 us), each a glance kernel, a
    patch kernel and a focus kernel; the device idles 10 us before each
    kernel of the second request but its first; a kernel whose launch the
    trace lacks follows the focus kernel of request 2."""
    ev = [_ann("request", 0, 60), _ann("glance", 0, 20), _ann("focus", 30, 20),
          _ann("request", 100, 60), _ann("glance", 100, 20), _ann("focus", 130, 20),
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 150, "dur": 40}]
    ev += [_launch(1, 5), _launch(2, 25), _launch(3, 35), _launch(4, 105), _launch(5, 125),
           _launch(6, 135)]
    ev += [_kernel("void glance_conv<bf16>", 1, 10, 30), _kernel("void patch_kernel<short>", 2, 40, 4),
           _kernel("void focus_conv", 3, 44, 20),
           _kernel("void glance_conv<bf16>", 4, 110, 30), _kernel("void patch_kernel<short>", 5, 150, 4),
           _kernel("void focus_conv", 6, 164, 20), _kernel("void focus_tail", 999, 194, 6)]
    return ev


def test_record():
    rec = tracing.record(trace(), ("request", "glance", "focus"), "request")
    assert rec["window_us"] == 200            # from the first request to the last kernel's end
    assert rec["busy_us"] == 54 + 30 + 4 + 20 + 6
    assert rec["range_busy_us"] == {"glance": 60, "request": 8, "focus": 46}
    assert sorted(rec["kernels"]["void patch_kernel<short>"]) == [4, 4]
    ops = dict(rec["breakdown"]["device_ops"])
    assert ops["glance_conv<bf16>"] == pytest.approx(60e-6)   # the name shortened
    assert tracing.short("void at::native::(anonymous namespace)::k<float>(float)") == \
        "at::native::k<float>(float)"
    gaps = dict(rec["breakdown"]["idle_gaps"])
    # 0-10 (request 1's glance range), 64-110 (no host range open), 140-150
    # (request 2's focus range), 154-164 and 184-194 (aten::copy_)
    assert gaps == pytest.approx({"glance": 10e-6, "idle": 46e-6, "focus": 10e-6,
                                  "aten::copy_": 20e-6})
    assert sum(gaps.values()) == pytest.approx((200 - rec["busy_us"]) / 1e6)


def test_metrics_read_the_record():
    rec = tracing.record(trace(), ("request", "glance", "focus"), "request")
    rec.update(requests=2, videos=128, batch=64, precision="bfloat16", patch=1e6,
               flops_per_video=3.5e10, pace_us=250.0, pace_units=2)
    read = {m: common.metric_reader(m) for m in
            ("idle_share.serve", "glance_ms.serve", "focus_ms.serve", "patch_roofline.serve",
             "mfu.serve")}
    # busy 114 us over 2 requests against an untraced pace of 125 us a request
    assert read["idle_share.serve"](rec) == pytest.approx(100 * (1 - 57 / 125))
    assert read["glance_ms.serve"](rec) == pytest.approx(0.030)
    assert read["focus_ms.serve"](rec) == pytest.approx(0.023)
    bound_us = 1e6 / peaks.BYTES_PER_S * 1e6
    assert read["patch_roofline.serve"](rec) == pytest.approx(100 * 2 * bound_us / 8)
    # the bound counts the requests' work, not the kernel's launches
    split = dict(rec, kernels={"void patch_kernel<short>": [2, 2, 2, 2]})
    assert read["patch_roofline.serve"](split) == pytest.approx(100 * 2 * bound_us / 8)
    assert read["mfu.serve"](rec) == pytest.approx(
        100 * 3.5e10 * 128 / 250e-6 / peaks.FLOPS["bfloat16"])


def test_train_metrics_read_the_untraced_pace():
    rec = {"steps": 4, "busy_us": 360.0, "window_us": 700.0, "pace_us": 400.0,
           "pace_units": 4, "batch": 64, "precision": "bfloat16", "flops_per_video": 8e10}
    read = {m: common.metric_reader(m) for m in ("idle_share.train", "mfu.train")}
    # 90 us busy a step against 100 us a step untraced; the traced window is not read
    assert read["idle_share.train"](rec) == pytest.approx(10.0)
    assert read["mfu.train"](rec) == pytest.approx(
        100 * 8e10 * 4 * 64 / 400e-6 / peaks.FLOPS["bfloat16"])


def test_union():
    assert tracing.union_us([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20


def test_int8_roofline_reads_the_int8_kernels():
    from perfbench import judge

    rec = {"requests": 2, "int8_bound_us": 30.0,
           "kernels": {"int8k::conv_kernel<128, 2>(int8k::ConvArgs)": [40.0, 40.0],
                       "void int8k::splitk_finish(int const*, int)": [5.0],
                       "int8k::dw_kernel<16, 9>(int8k::DwArgs)": [15.0],
                       "void conv_kernel_of_a_library(int)": [7.0],
                       "sm90_xmma_fprop_implicit_gemm_bf16": [100.0]}}
    assert common.metric_reader("int8_roofline.serve")(rec) == pytest.approx(100 * 60 / 100)
    cfg = common.load_json(os.path.join(common.HERE, "configs", "actnet-flagship.json"))
    units = judge.int8_units(cfg, 64)
    assert len(units) == 86 + 17          # the int8 forward's int8_conv and int8_dwconv launches
    assert judge.int8_bound_us(cfg, 64) == pytest.approx(sum(
        max(b / peaks.BYTES_PER_S, o / peaks.FLOPS["int8"]) for b, o in units) * 1e6)
