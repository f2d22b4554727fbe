"""The int8 units with the requantize fused into their epilogue
(``ops.quant.int8_unit``, the backbones of models/quant_inference.py)
against the JAX package's unfused composition, on the CPU.

- Each fused option of the plain versions (int8 codes at the consumer's
  scale, the compute-dtype output, both; a residual added with and without
  ReLU after it; an input in the compute dtype quantized on load) against
  JAX's unit as its backbones compose it: ``quantize_act``, ``int8_conv``,
  the activation, the cast to the compute dtype, the residual add (ResNet's
  ``relu(b + res)`` in float32, MobileNetV2's ``h + b`` in the compute
  dtype, after b is rounded to it), ``quantize_act`` of the result; 1x1,
  3x3 and depthwise units at strides 1 and 2, float32 and bf16. Codes and
  compute-dtype outputs are equal: both round the same values at the same
  points (JAX's epilogue is an FMA under ``jit``, the plain version a
  float64 multiply-add rounded once, which differs only by a double
  rounding; none occurs here).
- Shift and quantize commute: the codes of a shifted tensor are the shift
  of its codes (the shift moves values and fills zeros, code 0).
- Both int8 backbones call ``quantize_act`` no time, and give the codes and
  outputs of the unfused composition (each unit's input quantized by
  ``quantize_act``, its output in the compute dtype, the residual added
  apart) exactly, TSM included.
- ``int8_dense``'s split-K plan (``plan_int8_conv``: slices of the depth
  whose exact int32 sums are added in slice order before one epilogue)
  gives the single-pass output exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adafocus_torch.models import gfv as tgfv
from adafocus_torch.models import quant_inference as tqi
from adafocus_torch.models.tsm import temporal_shift
from adafocus_torch.ops import quant as tq
from adafocus_tpu.models.tsm import temporal_shift as jtemporal_shift
from adafocus_tpu.ops import quant as jq
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)

X_SCALE = 0.063           # the unit's input scale: |x| <= 8 spans the codes
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
ACT = {"1x1": ("relu6", lambda y: jnp.clip(y, 0.0, 6.0)),
       "3x3": ("relu", jax.nn.relu), "dw": ("relu6", lambda y: jnp.clip(y, 0.0, 6.0))}
# (kh, Cin, Cout, groups) a kind; Cin 16 and 24 are the expand units' depths
KINDS = {"1x1": (1, 24, 40), "1x1_k16": (1, 16, 64), "3x3": (3, 32, 48), "dw": (3, 32, 32)}


def _t(a: np.ndarray, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _jax_units(x_q, x_in, kernel, w_scale, bias, res, out_scale, stride, groups, act, dtype):
    """JAX's units on codes x_q and on x_in quantized on load: {variant:
    (compute-dtype output, codes at out_scale)}; with ``res`` also the
    residual units (no activation before the add), MobileNetV2's ``h + b``
    and ResNet's ``relu(b + res)``. The unit (product, FMA epilogue,
    activation, cast) runs under ``jit`` as JAX's forward runs it; the steps
    between units run op by op, each rounding where the backbones' code
    rounds (under one ``jit`` XLA:CPU may keep b's float32 excess precision
    through the bf16 add, which the program does not ask for)."""
    @jax.jit
    def units(q, x, k):
        def unit(a, fn):
            y = jq.int8_conv(a, jq.QConv(k, w_scale, bias, jnp.float32(X_SCALE)), stride,
                             groups)
            return (y if fn is None else fn(y)).astype(dtype)

        return unit(q, act), unit(jq.quantize_act(x, X_SCALE), act), unit(q, None)

    y_codes, y_load, b = units(x_q, x_in, kernel)
    out = {"codes": y_codes, "load": y_load}
    if res is not None:
        out["add"] = b + res
        out["add_relu"] = jax.nn.relu(b.astype(jnp.float32)
                                      + res.astype(jnp.float32)).astype(dtype)
    return {k: (v, jq.quantize_act(v, out_scale)) for k, v in out.items()}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kind", list(KINDS))
def test_fused_unit_matches_jax_composition(kind, stride, dtype):
    tdt, jdt = DTYPES[dtype]
    kh, cin, cout = KINDS[kind]
    act_name, act_fn = ACT[kind.split("_")[0]]
    depthwise = kind == "dw"
    groups = cin if depthwise else 1
    rs = np.random.RandomState(kh * 100 + cin + stride)
    n, size = 2, 13 if stride == 2 else 10
    x_q = rs.randint(-127, 128, (n, size, size, cin)).astype(np.int8)
    x_in = (rs.randn(n, size, size, cin) * 2.5).astype(np.float32)
    kq = rs.randint(-127, 128, (cout, 1 if depthwise else cin, kh, kh)).astype(np.int8)
    w_scale = (rs.uniform(0.5, 1.5, cout) * 2e-3).astype(np.float32)
    bias = (rs.randn(cout) * 0.3).astype(np.float32)
    ho = (size + 2 * ((kh - 1) // 2) - kh) // stride + 1
    res = None if depthwise else (rs.randn(n, ho, ho, cout) * 2).astype(np.float32)
    hwio = jnp.asarray(kq.transpose(2, 3, 1, 0))
    jres = None if res is None else jnp.asarray(res).astype(jdt)

    def fn(scale):
        return _jax_units(x_q, jnp.asarray(x_in).astype(jdt), hwio, w_scale, bias, jres,
                          jnp.float32(scale), stride, groups, act_fn, jdt)

    probe = fn(1.0)
    out_scale = np.float32(np.abs(np.asarray(probe["codes"][0], np.float32)).max() / 110)
    want = fn(out_scale)

    unit = tq.prepare_qconv(tq.QConv(_t(kq), _t(w_scale), _t(bias), torch.tensor(X_SCALE)),
                            depthwise=depthwise)
    inputs = {"codes": (_t(x_q), act_name, None, False),
              "load": (_t(x_in, tdt), act_name, None, False)}
    if res is not None:
        r = _t(res, tdt)
        inputs["add"] = (_t(x_q), None, r, False)
        inputs["add_relu"] = (_t(x_q), None, r, True)
    assert set(inputs) == set(want)
    s = torch.tensor(out_scale)
    for variant, (x, act, residual, relu) in inputs.items():
        y_want, q_want = (np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
                          for v in want[variant])
        for out_scale_t, keep in ((s, False), (None, True), (s, True)):
            y, q = tq.int8_unit(x, unit, stride, groups, act, tdt, out_scale=out_scale_t,
                                keep=keep, residual=residual, res_relu=relu)
            assert (y is None) == (not keep) and (q is None) == (out_scale_t is None)
            if y is not None:
                assert y.dtype == tdt
                np.testing.assert_array_equal(y.float().numpy(), y_want, err_msg=variant)
            if q is not None:
                assert q.dtype == torch.int8
                np.testing.assert_array_equal(q.numpy(), q_want, err_msg=variant)
        assert np.abs(q_want.astype(int)).max() >= 32, variant   # the codes span a range


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_codes_of_shift_are_shift_of_codes(dtype):
    tdt, jdt = DTYPES[dtype]
    rs = np.random.RandomState(3)
    x = (rs.randn(6, 5, 4, 24) * 3).astype(np.float32)
    s = torch.tensor(0.05)
    xt = _t(x, tdt)
    shifted_codes = tq.quantize_act(temporal_shift(xt, 3), s)
    np.testing.assert_array_equal(shifted_codes.numpy(),
                                  temporal_shift(tq.quantize_act(xt, s), 3).numpy())
    np.testing.assert_array_equal(
        shifted_codes.numpy(),
        np.asarray(jq.quantize_act(jtemporal_shift(jnp.asarray(x).astype(jdt), 3), 0.05)))


@pytest.mark.parametrize("tsm", [False, True], ids=["plain", "tsm"])
@pytest.mark.parametrize("kind", ["mbv2", "resnet"])
def test_backbone_fused_equals_unfused(kind, tsm, monkeypatch):
    """No ``quantize_act`` inside a fused int8 backbone; its codes (seen
    through ``code_tap``), map and pooled features equal the unfused
    composition's bit for bit."""
    cfg = tgfv.flagship(tiny=True)
    model = tgfv.GFV(cfg, device="cpu")
    module = model.glancer if kind == "mbv2" else model.focuser
    size = cfg.glance_size if kind == "mbv2" else cfg.patch_size
    n_frames = 2 if tsm else 0
    gen = torch.Generator().manual_seed(11)
    batches = [torch.randn((4, size, size, 3), generator=gen) for _ in range(2)]
    scales = tqi.calibrate_backbone(kind, module, batches, n_frames, torch.float32)
    calls, taps = [], []
    real = tqi.quantize_act
    monkeypatch.setattr(tqi, "quantize_act", lambda *a: calls.append(1) or real(*a))
    fn = tqi._mbv2_backbone if kind == "mbv2" else tqi._resnet_backbone
    with torch.inference_mode():
        fmap, pooled = tqi._run_backbone(kind, module, batches[0], scales, n_frames)
        assert calls == []
        monkeypatch.setattr(tqi, "code_tap", lambda name, q: taps.append((name, q)))
        tqi._run_backbone(kind, module, batches[0], scales, n_frames)
        unfused = tqi._UnfusedRunner(scales, torch.float32)
        want_map, want_pooled = fn(module, batches[0], unfused, n_frames)
    assert [n for n, _ in taps] == [n for n, _ in unfused.codes] and len(taps) == len(scales)
    for (name, got), (_, want) in zip(taps, unfused.codes):
        assert torch.equal(got, want), name
    assert torch.equal(fmap, want_map) and torch.equal(pooled, want_pooled)


def _split_k_dense(x_q, unit, splits):
    """The split-K plan's plain version: the depth cut into ``splits`` slices
    of whole depth steps as the kernel cuts it, each slice's exact int32
    sums, added in slice order, then the one epilogue."""
    bk = 16 * unit.packed.shape[2]
    ksteps = unit.packed.shape[1]
    per = -(-ksteps // splits)
    w = unit.kernel_q.double()
    acc = torch.zeros((x_q.shape[0], w.shape[0]), dtype=torch.int64)
    for s in range(0, ksteps, per):
        k0, k1 = s * bk, min((s + per) * bk, w.shape[1])
        acc += (x_q[:, k0:k1].double() @ w[:, k0:k1].t()).long()
    return tq.epilogue_reference(acc.double(), unit.rescale, unit.bias, None, torch.float32)


@pytest.mark.parametrize("m", [1, 7, 64])
def test_dense_split_k_equals_single_pass(m):
    rs = np.random.RandomState(m)
    k, n = 1280, 200
    unit = tq.prepare_qconv(tq.QConv(
        _t(rs.randint(-127, 128, (n, k)).astype(np.int8)),
        _t((rs.uniform(0.5, 1.5, n) * 1e-3).astype(np.float32)),
        _t(rs.randn(n).astype(np.float32)), torch.tensor(0.02)))
    nc, splits = tq.plan_int8_conv(m, unit.packed.shape[0], unit.packed.shape[1])
    assert nc == 1 and splits > 1
    x = _t(rs.randint(-127, 128, (m, k)).astype(np.int8))
    assert torch.equal(_split_k_dense(x, unit, splits), tq.int8_dense(x, unit))
