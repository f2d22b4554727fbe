"""The port's int8 PTQ serving (ops/quant.py, models/quant_inference.py)
against the JAX package's on the CPU, float32 models.

- Primitives: ``quantize_weight`` (codes and scales, conv, depthwise and
  dense layouts), ``quantize_act`` (per tensor and per channel),
  ``FRAME_SCALE`` and ``quantize_frames`` are exactly JAX's. ``int8_conv``
  (1x1, 3x3 at strides 1 and 2, depthwise at strides 1 and 2, Cin = 24, the
  1x1 stride-2 downsample) and ``int8_dense`` (M = 1 and 5) give JAX's int32
  accumulators exactly and its float32 outputs within 1 ulp: JAX's epilogue
  is one fused multiply-add on XLA:CPU under ``jit``, as its forward runs it
  (eagerly XLA rounds the product and the sum apart: 27% of the 1x1 case's
  outputs then differ from the FMA, some by 171 ulp near zero), the port's
  plain version a float64 multiply-add rounded once, which differs from an
  FMA only by a double rounding (none was seen here: every output equal).
- Calibration: ``calibrate_gfv`` gives JAX's scales under the same names,
  with and without heads, within 1e-5 relative; a head point's
  per-channel vector within 1e-5 of its largest channel's scale, since a
  channel far below the largest carries the float32 rounding of its
  neighbours' sums (measured: ``cls/fc``'s channel at 1.05e-4, 75 times
  under the vector's largest, 1.01e-5 apart relative to itself, 2e-7
  relative to the largest).
- Backbones: each backbone in int8 with JAX's scales carried across
  (``weights.quant_scales_from_jax``): pooled features within 1e-3 of the
  largest (measured 0 to 2e-6 at these sizes; the share of int8 codes that
  differ between the packages is printed, measured 0 to 1e-4: an
  activation within float32 rounding of a rounding boundary).
- Prepared weights: ``prepare_q8`` makes the same entries as JAX's; their
  int8 codes equal but where the two packages' BatchNorm folds put a weight
  across a rounding boundary (XLA:CPU's ``rsqrt`` is neither exact nor
  ``1 / sqrt``, torch's is ``1 / sqrt``; they differ in 35% of values by an
  ulp): measured 10 of 25.7 million codes, held at a share of 1e-5; weight
  scales and folded biases within 1e-6 relative.
- End to end: ``inference_q8`` (ActivityNet), ``inference_q8_sthsth`` (the
  continuous BatchNorm-encoder policy, TSM, consensus) and
  ``inference_q8_plus`` (the ST selector and ``plus_rl``), in modes
  ``int8`` and ``int8+heads``, on int8 transport frames, from JAX's weights,
  scales and prepared weights (``q8_cache_from_jax``), the models in
  float64: the greedy actions equal (the continuous ones within 1e-5, with
  equal patch offsets) and the logits within atol = rtol = 1e-3, the
  forward's tolerance (tests/test_torch_port_gfv.py). Measured: ``int8``
  within 3e-7, ``int8+heads`` equal. Why float64 and the carried weights:
  an activation within float32 rounding of a rounding boundary takes the
  other int8 code in the other package, and in these tiny backbones (1x1
  maps from layer3 on) one such flip cascades. In float32 with each
  package's own fold, the ActivityNet logits differed by 1.2e-2; with the
  carried weights but in float32, 10 of the 12 cases held 1e-3 and
  ``plus_st`` differed by 4.3e-3 through one code flipped by the two
  packages' float32 stem convolutions. The stems and the float heads are
  float64 here, which leaves no such flip; the int8 products and their
  float32 epilogues are the same either way.
- ``prepare_q8``'s cache gives the uncached output exactly; the int8
  forwards run on the CPU only when asked (``device="cpu"``); the wrappers
  refuse a grouped conv that is not depthwise. (``time_inference`` in the
  int8 modes on the CPU: tests/test_torch_port_bench.py.)

JAX's forwards are jitted (eagerly they take about 50 s each here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adafocus_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from adafocus_torch.models import quant_inference as tqi
from adafocus_torch.ops import quant as tq
from adafocus_torch.weights import quant_scales_from_jax
from adafocus_tpu.models import gfv as jgfv
from adafocus_tpu.models import quant_inference as jqi
from adafocus_tpu.models.fused_inference import _merge_bn, _subtree
from adafocus_tpu.ops import quant as jq
from adafocus_tpu.ops.fused_blocks import fold_bn as jfold_bn
from adafocus_tpu.ops.patch import pad_for_extraction
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.torch_port_common import TINY, abstract_variables, port_model, port_model64

TOL = 1e-3
BACKBONE_TOL = 1e-3
PREP_RTOL = 1e-6          # weight scales and folded biases: float32 rounding of the fold
PREP_CODE_SHARE = 1e-5    # int8 weight codes an ulp of the fold moves across a boundary

FAMILIES = {
    "actnet": TINY,
    "sthsth": dataclasses.replace(TINY, classifier="consensus", tsm=True, num_frames=2,
                                  num_frames_focuser=4, video_div=2, continuous_policy=True,
                                  policy_bn=True),
    "plus_st": dataclasses.replace(TINY, num_frames=4, frame_budget=2, selector_hidden=8),
    "plus_rl": dataclasses.replace(TINY, num_frames=4, frame_budget=2, selector_hidden=8,
                                   plus_rl=True),
}
JAX_FORWARD = {"actnet": jqi.inference_q8, "sthsth": jqi.inference_q8_sthsth,
               "plus_st": jqi.inference_q8_plus, "plus_rl": jqi.inference_q8_plus}


def _normalized(rs, shape):
    """ImageNet-normalized pixels of uniform raw values, the frames' range."""
    return ((rs.uniform(size=shape) - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (1, 1, 24, 40), (3, 3, 1, 32), (20, 12)],
                         ids=["conv3x3", "conv1x1", "depthwise", "dense"])
def test_quantize_weight_matches_jax(shape):
    rs = np.random.RandomState(0)
    k = (rs.randn(*shape) * np.linspace(0.05, 3.0, shape[-1])).astype(np.float32)
    kq, ws = jq.quantize_weight(jnp.asarray(k))
    # the port's layouts: (Cout, Cin, kh, kw) and (out, in)
    port = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
    tkq, tws = tq.quantize_weight(torch.from_numpy(np.ascontiguousarray(port)))
    want = np.asarray(kq).transpose(3, 2, 0, 1) if k.ndim == 4 else np.asarray(kq).T
    assert tkq.dtype == torch.int8
    np.testing.assert_array_equal(tkq.numpy(), want)
    np.testing.assert_array_equal(tws.numpy(), np.asarray(ws))


def test_quantize_act_and_frames_match_jax():
    rs = np.random.RandomState(1)
    x = (rs.randn(4, 5, 5, 24) * 3).astype(np.float32)
    s = np.float32(0.0371)
    sc = rs.uniform(0.01, 0.1, 24).astype(np.float32)
    for scale in (s, sc):
        np.testing.assert_array_equal(
            tq.quantize_act(torch.from_numpy(x), torch.tensor(scale)).numpy(),
            np.asarray(jq.quantize_act(jnp.asarray(x), jnp.asarray(scale))))
    assert tq.FRAME_SCALE == jq.FRAME_SCALE
    frames = np.concatenate([_normalized(rs, (2, 8, 8, 3)).ravel(),
                             rs.randn(500).astype(np.float32) * 4])   # beyond the range: clamped
    got = tq.quantize_frames(torch.from_numpy(frames))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.quantize_frames(jnp.asarray(frames))))
    np.testing.assert_array_equal(tq.dequantize(got, torch.tensor(s)).numpy(),
                                  np.asarray(jq.dequantize(jnp.asarray(got.numpy()), s)))


def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("k,stride,cin,cout,groups", [
    (1, 1, 32, 48, 1), (3, 1, 16, 24, 1), (3, 2, 16, 24, 1), (3, 1, 32, 32, 32),
    (3, 2, 32, 32, 32), (1, 1, 24, 144, 1), (1, 2, 32, 64, 1)],
    ids=["1x1", "3x3s1", "3x3s2", "dw_s1", "dw_s2", "cin24", "1x1s2"])
def test_int8_conv_matches_jax(k, stride, cin, cout, groups):
    rs = np.random.RandomState(2)
    x_q = rs.randint(-127, 128, (2, 9, 9, cin)).astype(np.int8)
    kernel = rs.randn(k, k, cin // groups, cout).astype(np.float32)
    kq, ws = jq.quantize_weight(jnp.asarray(kernel))
    bias = rs.randn(cout).astype(np.float32)
    s_x = np.float32(0.0213)
    unit = jq.QConv(kq, ws, jnp.asarray(bias), jnp.float32(s_x))
    want = np.asarray(jax.jit(lambda a: jq.int8_conv(a, unit, stride, groups))(jnp.asarray(x_q)))
    acc = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x_q), kq, (stride, stride), [((k - 1) // 2,) * 2] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
        preferred_element_type=jnp.int32))
    tunit = tq.QConv(torch.from_numpy(np.asarray(kq).transpose(3, 2, 0, 1).copy()),
                     torch.from_numpy(np.array(ws)), torch.from_numpy(bias),
                     torch.tensor(s_x))
    tx = torch.from_numpy(x_q)
    got_acc = tq.int8_conv(tx, tunit, stride, groups, out_dtype=torch.int32).numpy()
    np.testing.assert_array_equal(got_acc, acc)
    got = tq.int8_conv(tx, tunit, stride, groups).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert _ulps(got, want).max() <= 1, _ulps(got, want).max()
    print(f"int8_conv k{k} s{stride} groups {groups}: {(got != want).sum()} of {got.size} "
          f"outputs differ by an ulp")
    # the fused activation and store: relu6, then bf16
    got6 = tq.int8_conv(tx, tunit, stride, groups, act="relu6", out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got6.float().numpy(),
                                  torch.from_numpy(np.clip(got, 0, 6)).bfloat16().float().numpy())


@pytest.mark.parametrize("m", [1, 5])
def test_int8_dense_matches_jax(m):
    rs = np.random.RandomState(3)
    x_q = rs.randint(-127, 128, (m, 40)).astype(np.int8)
    kernel = rs.randn(40, 24).astype(np.float32)
    kq, ws = jq.quantize_weight(jnp.asarray(kernel))
    bias = rs.randn(24).astype(np.float32)
    unit = jq.QConv(kq, ws, jnp.asarray(bias), jnp.float32(0.5))
    want = np.asarray(jax.jit(lambda a: jq.int8_dense(a, unit))(jnp.asarray(x_q)))
    tunit = tq.QConv(torch.from_numpy(np.asarray(kq).T.copy()), torch.from_numpy(np.array(ws)),
                     torch.from_numpy(bias), torch.tensor(np.float32(0.5)))
    acc = np.asarray(jnp.dot(jnp.asarray(x_q), kq, preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(
        tq.int8_dense(torch.from_numpy(x_q), tunit, out_dtype=torch.int32).numpy(), acc)
    got = tq.int8_dense(torch.from_numpy(x_q), tunit).numpy()
    assert _ulps(got, want).max() <= 1


def test_grouped_conv_must_be_depthwise():
    unit = tq.QConv(torch.ones((8, 2, 3, 3), dtype=torch.int8), torch.ones(8), torch.zeros(8),
                    torch.tensor(1.0))
    with pytest.raises(ValueError, match="depthwise"):
        tq.int8_conv(torch.zeros((1, 4, 4, 8), dtype=torch.int8), unit, 1, groups=4)


# ---------------------------------------------------------------------------
# one family's models, inputs and JAX's scales
# ---------------------------------------------------------------------------

class Family:
    """One family's JAX and port models on the same weights, its inputs and
    JAX's calibrated scales; ``float64``: both models in float64 (JAX under
    ``jax.enable_x64``, which the caller holds)."""

    def __init__(self, name: str, seed: int = 5, float64: bool = False):
        cfg = self.cfg = FAMILIES[name]
        if float64:
            cfg = self.cfg = dataclasses.replace(cfg, dtype=jnp.float64)
        self.name = name
        self.jmodel, self.variables = abstract_variables(cfg, seed=seed)
        self.model = (port_model64 if float64 else port_model)(cfg, self.variables)
        rs = np.random.RandomState(seed)
        b, tf, t = 2, cfg.t_focuser, cfg.num_frames
        s, g, p = cfg.image_size, cfg.glance_size, cfg.patch_size
        self.frames = _normalized(rs, (b, tf, s, s, 3)).astype(cfg.dtype)
        self.small = _normalized(rs, (b, t, g, g, 3)).astype(cfg.dtype)
        patches = rs.randn(b * tf, p, p, 3).astype(np.float32)
        self.batch = {"frames_small": self.small, "patches": patches}
        self.jscales = jax.tree.map(np.asarray, jqi.calibrate_gfv(
            self.jmodel, self.variables, [self.batch], heads=True))
        flat = pad_for_extraction(jnp.asarray(self.frames.reshape((-1, s, s, 3))))
        self.jflat_q = jq.quantize_frames(flat.reshape((b, tf) + flat.shape[1:]))
        self.jsmall_q = jq.quantize_frames(jnp.asarray(self.small))
        self._jax_qw = None

    def jax_qw(self, heads: bool) -> dict:
        """JAX's prepared weights, ``jax_cache`` under one ``jax.jit`` once
        a family: mode int8's are int8+heads' without the heads'. A float64
        family's caller holds ``jax.enable_x64``."""
        if self._jax_qw is None:
            self._jax_qw = jax.jit(jax_cache)(self.variables, self.jscales)
        return self._jax_qw if heads else {**self._jax_qw, "heads": {}}

    def scales(self, heads: bool):
        """JAX's scales carried across, without the heads' for mode int8."""
        sc = self.jscales if heads else {k: v for k, v in self.jscales.items() if k != "heads"}
        return quant_scales_from_jax(sc)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family64(request):
    with jax.enable_x64(True):
        return Family(request.param, float64=True)


@pytest.fixture(scope="module")
def actnet():
    return Family("actnet", seed=7)


# ---------------------------------------------------------------------------
# calibration and backbones
# ---------------------------------------------------------------------------

def test_calibrate_gfv_matches_jax(actnet):
    batch = {k: torch.from_numpy(v) for k, v in actnet.batch.items()}
    for heads in (False, True):
        got = tqi.calibrate_gfv(actnet.model, [batch], heads=heads)
        want = actnet.jscales if heads else {k: v for k, v in actnet.jscales.items()
                                             if k != "heads"}
        assert set(got) == set(want)
        for group in want:
            assert set(got[group]) == set(want[group]), group
            for name, v in want[group].items():
                # a head point's vector: 1e-5 of its largest channel's scale
                np.testing.assert_allclose(got[group][name].numpy(), v, rtol=1e-5,
                                           atol=1e-5 * np.abs(v).max() if v.ndim else 0,
                                           err_msg=f"{group} {name}")
    assert "stem" not in got["glancer"] and "layer4_2/conv3" in got["focuser"]
    assert got["heads"]["cls/gru/x"].shape == (actnet.cfg.fused_dim,)


def _spy(monkeypatch, module, codes: list):
    real = module.quantize_act

    def spy(x, scale):
        q = real(x, scale)
        codes.append(q)
        return q

    monkeypatch.setattr(module, "quantize_act", spy)


def _tap(monkeypatch, codes: list):
    """The int8 codes each of the port's fused backbone units reads, in the
    order the units run (``quant_inference.code_tap``): its producer's
    epilogue writes them, or the unit quantizes its input on load."""
    monkeypatch.setattr(tqi, "code_tap", lambda name, q: codes.append(q))


@pytest.mark.parametrize("kind", ["mbv2", "resnet"])
def test_backbone_q8_matches_jax(actnet, kind, monkeypatch):
    """Each backbone int8 with JAX's scales: pooled features, and the share
    of int8 codes that differ."""
    cfg = actnet.cfg
    sub, group = ("glancer", "glancer") if kind == "mbv2" else ("focuser", "focuser")
    size = cfg.glance_size if kind == "mbv2" else cfg.patch_size
    x = _normalized(np.random.RandomState(8), (4, size, size, 3))
    jcodes, tcodes = [], []
    _spy(monkeypatch, jqi, jcodes)
    _tap(monkeypatch, tcodes)
    jfn = jqi.mobilenet_features_q8 if kind == "mbv2" else jqi.resnet_features_q8
    want = jax.jit(lambda v, a: (jfn(v, a, actnet.jscales[group]), jcodes))(
        _subtree(actnet.variables, sub), jnp.asarray(x))
    (_, want_pooled), want_codes = want
    tfn = tqi.mobilenet_features_q8 if kind == "mbv2" else tqi.resnet_features_q8
    _, got_pooled = tfn(getattr(actnet.model, sub), torch.from_numpy(x),
                        actnet.scales(False)[group])
    assert len(tcodes) == len(want_codes) > 0
    differ = sum(int((t.numpy() != np.asarray(j)).sum()) for t, j in zip(tcodes, want_codes))
    total = sum(t.numel() for t in tcodes)
    want_pooled = np.asarray(want_pooled)
    rel = np.abs(got_pooled.detach().numpy() - want_pooled).max() / np.abs(want_pooled).max()
    print(f"{kind}: {differ} of {total} int8 codes differ ({differ / total:.2e}); pooled "
          f"max|d|/max {rel:.2e}")
    assert rel <= BACKBONE_TOL


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def jax_cache(v, scales) -> dict:
    """JAX's prepared-weight cache for flax variables ``v`` and scales
    ``scales`` (with 'heads' for int8+heads), each entry made by JAX's own
    code as its ``prepare_q8`` makes it (``fold_bn`` and
    ``quantize_weight`` a backbone unit, ``_HeadRunner._qweight`` a head),
    without the batch-1 forward that drives it there (eager, about a minute
    a family here). Eagerly it compiles each op at each shape (~400
    programs); where the cache only feeds both packages' forwards it runs
    under one ``jax.jit`` (``Family.jax_qw``)."""
    qw = {"glancer": {}, "focuser": {}, "heads": {}}
    for group in ("glancer", "focuser"):
        tree = _merge_bn(v["params"][group], v["batch_stats"].get(group, {}))
        for name in scales[group]:
            unit = tree
            for part in name.split("/"):
                unit = unit[part]
            kernel, bias = jfold_bn(unit["conv"]["kernel"], unit["bn"])
            qw[group][name] = jq.quantize_weight(kernel) + (bias,)
    if "heads" not in scales:
        return qw
    p = v["params"]
    enc, pol = p["policy"]["encoder"], p["policy"]
    kernels = {}   # cache name: (float kernel (in, out), its scale's name)
    if "proj" in enc:
        k = enc["proj"]["kernel"]
        k2 = k.reshape(k.shape[-2], k.shape[-1])
        if "bn" in enc:
            bn = dict(enc["bn"], **v["batch_stats"]["policy"]["encoder"]["bn"])
            k2 = jfold_bn(k2, bn)[0]
        kernels["policy/proj"] = (k2, "policy/proj")
    kernels.update({"policy/fc": (enc["fc"]["kernel"], "policy/fc"),
                    "policy/gru/x": (pol["gru"]["wi"], "policy/gru/x"),
                    "policy/gru/wh": (pol["gru"]["wh"], "policy/gru/h"),
                    "policy/actor": (pol["actor"]["kernel"], "policy/actor"),
                    "policy/critic": (pol["critic"]["kernel"], "policy/critic")})
    cls = p["classifier"]
    if "gru" in cls:
        kernels.update({"cls/gru/x": (cls["gru"]["wi"], "cls/gru/x"),
                        "cls/gru/wh": (cls["gru"]["wh"], "cls/gru/h"),
                        "cls/fc": (cls["fc"]["kernel"], "cls/fc")})
    else:
        kernels.update({"cls/fc": (cls["fc"]["kernel"], "cls/fc"),
                        "glancer/fc": (p["glancer"]["classifier"]["kernel"], "glancer/fc")})
    runner = jqi._HeadRunner(scales["heads"], qw["heads"])
    for name, (kernel, point) in kernels.items():
        # stored here too: under ``jax.jit`` the runner keeps no traced entry
        qw["heads"][name] = runner._qweight(name, jnp.asarray(kernel),
                                            jnp.atleast_1d(scales["heads"][point]))
    return qw


def q8_cache_from_jax(jax_qw, own) -> dict:
    """JAX's prepared-weight cache (numpy leaves: a backbone unit
    ``(kernel_q HWIO, w_scale, bias)``, a head ``(kernel_q (in, out),
    w_scale)``) -> the port's, on the structure of the port's own cache
    ``own``: each entry with JAX's int8 weight, weight scales and, for a
    backbone unit, folded bias, prepared again. A (C, 1, 3, 3) weight is a
    depthwise unit."""
    out = {}
    for group, entries in own.items():
        out[group] = {}
        for name, unit in entries.items():
            leaves = [np.array(v) for v in jax_qw[group][name]]   # writable copies
            kq = leaves[0].transpose(3, 2, 0, 1) if leaves[0].ndim == 4 else leaves[0].T
            fields = {"kernel_q": torch.from_numpy(np.ascontiguousarray(kq)),
                      "w_scale": torch.from_numpy(leaves[1])}
            if len(leaves) == 3:
                fields["bias"] = torch.from_numpy(leaves[2])
            out[group][name] = tq.prepare_qconv(unit._replace(**fields),
                                                depthwise=kq.ndim == 4 and kq.shape[1] == 1)
    return out


def _jax_forward(fam: Family, heads: bool, monkeypatch):
    """JAX's int8 forward (jitted, with its prepared-weight cache, as its
    bench and evaluate CLI serve it), the actions it crops at, and the
    cache."""
    captured = []
    real = jgfv.extract_for_frames

    def spy(frames, actions, *a, **k):
        captured.append(actions)
        return real(frames, actions, *a, **k)

    monkeypatch.setattr(jgfv, "extract_for_frames", spy)
    scales = fam.jscales if heads else {k: v for k, v in fam.jscales.items() if k != "heads"}
    forward = JAX_FORWARD[fam.name]
    qw = fam.jax_qw(heads)
    fn = jax.jit(lambda v, f, s: (forward(fam.jmodel, v, scales, f, s, jax.random.key(0),
                                          qw=qw), captured[-1]))
    logits, actions = fn(fam.variables, fam.jflat_q, fam.jsmall_q)
    return np.asarray(logits), np.asarray(actions), jax.tree.map(np.asarray, qw)


def _port_forward(fam: Family, heads: bool, monkeypatch, qw=None):
    captured = []
    real = tqi.extract_for_frames

    def spy(frames, actions, *a, **k):
        captured.append(actions)
        return real(frames, actions, *a, **k)

    monkeypatch.setattr(tqi, "extract_for_frames", spy)
    logits = tqi.family_q8(fam.model.cfg)(
        fam.model, fam.scales(heads), tq.quantize_frames(torch.from_numpy(fam.frames)),
        tq.quantize_frames(torch.from_numpy(fam.small)), device="cpu", qw=qw)
    return logits.numpy(), captured[-1].numpy()


@pytest.mark.parametrize("heads", [False, True], ids=["int8", "int8+heads"])
def test_inference_q8_matches_jax(family64, heads, monkeypatch):
    """The int8 forward from JAX's weights, scales and prepared weights, the
    float parts in float64."""
    family = family64
    with jax.enable_x64(True):
        want, want_actions, jax_qw = _jax_forward(family, heads, monkeypatch)
    own = tqi.prepare_q8(family.model, family.scales(heads))
    got, got_actions = _port_forward(family, heads, monkeypatch,
                                     qw=q8_cache_from_jax(jax_qw, own))
    cfg = family.cfg
    if cfg.continuous_policy:
        np.testing.assert_allclose(got_actions, want_actions, atol=1e-5, rtol=0)
        span = cfg.image_size - cfg.patch_size
        np.testing.assert_array_equal(np.floor(got_actions * span),
                                      np.floor(want_actions * span))
    else:
        np.testing.assert_array_equal(got_actions, want_actions)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_prepare_q8_matches_jax(actnet):
    """The port's own prepared weights against JAX's: the same entries, the
    int8 codes equal but where the two packages' BatchNorm folds (their
    ``rsqrt``s, an ulp apart in some channels) put a weight on the other
    side of a rounding boundary, the weight scales and folded biases within
    float32 rounding."""
    own = tqi.prepare_q8(actnet.model, actnet.scales(True))
    want = jax.tree.map(np.asarray, jax_cache(actnet.variables, actnet.jscales))
    differ = total = 0
    for group, entries in own.items():
        assert set(entries) == set(want[group]), group
        for name, unit in entries.items():
            kq, ws = want[group][name][:2]
            kq = kq.transpose(3, 2, 0, 1) if kq.ndim == 4 else kq.T
            codes = unit.kernel_q.numpy().astype(int)
            assert np.abs(codes - kq).max() <= 1, name
            differ += int((codes != kq).sum())
            total += kq.size
            np.testing.assert_allclose(unit.w_scale.numpy(), ws, rtol=PREP_RTOL, err_msg=name)
            if group != "heads":
                np.testing.assert_allclose(unit.bias.numpy(), want[group][name][2],
                                           rtol=PREP_RTOL, atol=PREP_RTOL, err_msg=name)
    print(f"prepare_q8: {differ} of {total} int8 weight codes differ from JAX's")
    assert differ <= PREP_CODE_SHARE * total


def test_prepare_q8_cache_matches_uncached(actnet, monkeypatch):
    qw = tqi.prepare_q8(actnet.model, actnet.scales(True))
    assert qw["glancer"] and qw["focuser"] and qw["heads"]
    assert all(isinstance(u, tq.QConv) and u.rescale is not None
               for sub in qw.values() for u in sub.values())
    cached, _ = _port_forward(actnet, True, monkeypatch, qw=qw)
    uncached, _ = _port_forward(actnet, True, monkeypatch)
    np.testing.assert_array_equal(cached, uncached)
    if not torch.cuda.is_available():   # on the CPU only when asked
        frames = tq.quantize_frames(torch.from_numpy(actnet.frames))
        small = tq.quantize_frames(torch.from_numpy(actnet.small))
        for forward in (tqi.inference_q8, tqi.inference_q8_sthsth, tqi.inference_q8_plus):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                forward(actnet.model, actnet.scales(False), frames, small, qw=qw)

