"""Port parity for the fused-block slice (ops/fused_blocks.py,
models/fused_inference.py, ``inference(fused="on")``).

On the CPU the wrappers run their plain versions; these are held, in
float32 on numpy inputs from a seed, against the JAX package's
``fused_inverted_residual`` / ``fused_bottleneck`` in interpret mode and
against the flax modules, at tests/test_fused_blocks.py's shapes: atol 2e-5
and rtol 1e-5, float32 summed in another order. The folded arrays agree
within 1e-6. Whole backbones (N=2, 32^2) agree within atol 5e-4 and rtol
1e-4, the tolerance tests/test_fused_blocks.py holds the JAX path to; the
slice at the tiny configuration with equal greedy indices and logits
within atol = rtol = 1e-3. Weights go through the bridge with random
BatchNorm statistics, so the folded biases are not zero.

The CUDA kernels are held against the plain versions by
tests/test_torch_port_cuda.py (where a GPU is visible) and by chip_smoke.py
at every block shape of the flagship.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adafocus_torch.models import fused_inference as tfi
from adafocus_torch.models import gfv as tgfv
from adafocus_torch.models import mobilenet as tmob
from adafocus_torch.models import resnet as tres
from adafocus_torch.ops import fused_blocks as tfb
from adafocus_torch.weights import gfv_state_dict_from_flax
from adafocus_tpu.models import fused_inference as jfi
from adafocus_tpu.models import mobilenet as jmob
from adafocus_tpu.models import resnet as jres
from adafocus_tpu.models.gfv import GFV, inference
from adafocus_tpu.ops import fused_blocks as jfb
from adafocus_tpu.ops.patch import pad_for_extraction
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.torch_port_common import TINY, abstract_variables, port_model, randomize_bn

BLOCK_TOL = dict(atol=2e-5, rtol=1e-5)
BACKBONE_TOL = dict(atol=5e-4, rtol=1e-4)
SLICE_TOL = 1e-3
FOLD_TOL = 1e-6


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _flax_block(module, x, seed):
    """(variables with random BN, merged {conv, bn} tree for the JAX folds)."""
    vs = randomize_bn(module.init(jax.random.key(0), jnp.asarray(x)), seed)
    return vs, jfi._merge_bn(vs["params"], vs["batch_stats"])


def _load(module, vs):
    module.load_state_dict(gfv_state_dict_from_flax(vs["params"], vs["batch_stats"]))
    return module.eval()


def _same_folds(got, want):
    for name, g, w in zip(got._fields, got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape),
                                       atol=FOLD_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("cin,cout,stride,expand", [
    (8, 8, 1, 6),    # residual
    (8, 12, 1, 6),   # channel change, no residual
    (8, 12, 2, 6),   # stride 2
    (8, 8, 1, 1),    # no expand (block_0_0's kind)
])
def test_inverted_residual_matches_jax(cin, cout, stride, expand):
    x = np.random.RandomState(cin + cout + stride).randn(2, 16, 16, cin).astype(np.float32)
    module = jmob.InvertedResidual(features=cout, strides=stride, expand_ratio=expand)
    vs, merged = _flax_block(module, x, seed=expand)
    with jax.default_matmul_precision("highest"):
        ref = module.apply(vs, jnp.asarray(x))
    jfold = jfb.fold_inv_residual(merged)
    use_res = stride == 1 and cin == cout
    want = jfb.fused_inverted_residual(jnp.asarray(x), jfold, stride=stride,
                                       use_res=use_res, interpret=True)

    block = _load(tmob.InvertedResidual(cin, cout, stride, expand), vs)
    fold = tfb.fold_inv_residual(block)
    _same_folds(fold, jfold)
    got = tfb.fused_inverted_residual(torch.from_numpy(x), fold, stride, use_res)
    assert got.shape == want.shape
    _close(got, want, BLOCK_TOL)
    _close(got, ref, BLOCK_TOL)


@pytest.mark.parametrize("stride,downsample,size,use_res", [
    (1, True, 8, True),
    (1, False, 8, True),
    (2, True, 8, True),
    (2, True, 9, True),    # odd size under stride 2: 9 -> 5
    (1, False, 8, False),  # temporal-shift split: the branch only
])
def test_bottleneck_matches_jax(stride, downsample, size, use_res):
    x = np.random.RandomState(size + stride).randn(2, size, size, 64).astype(np.float32)
    module = jres.Bottleneck(features=16, strides=stride, downsample=downsample)
    vs, merged = _flax_block(module, x, seed=size)
    with jax.default_matmul_precision("highest"):
        ref = module.apply(vs, jnp.asarray(x))
    jfold = jfb.fold_bottleneck(merged)
    want = jfb.fused_bottleneck(jnp.asarray(x), jfold, stride=stride,
                                use_res=use_res, interpret=True)

    block = _load(tres.Bottleneck(64, 16, stride, downsample), vs)
    fold = tfb.fold_bottleneck(block)
    _same_folds(fold, jfold)
    got = tfb.fused_bottleneck(torch.from_numpy(x), fold, stride, use_res)
    assert got.shape == want.shape
    _close(got, want, BLOCK_TOL)
    if not use_res:   # the caller adds the residual and the relu
        got = (got + torch.from_numpy(x)).relu()
    _close(got, ref, BLOCK_TOL)


def test_mobilenet_features_fused_matches_jax():
    x = np.random.RandomState(4).randn(2, 32, 32, 3).astype(np.float32)
    module = jmob.MobileNetV2(num_classes=10)
    vs = randomize_bn(jax.jit(module.init)(jax.random.key(0), jnp.asarray(x)), seed=4)
    want_map, want_pool = jax.jit(partial(jfi.mobilenet_features_fused, interpret=True))(
        vs, jnp.asarray(x))
    glancer = _load(tmob.MobileNetV2(num_classes=10), vs)
    got_map, got_pool = tfi.mobilenet_features_fused(glancer, torch.from_numpy(x))
    _close(got_map, want_map, BACKBONE_TOL)
    _close(got_pool, want_pool, BACKBONE_TOL)
    with torch.no_grad():   # and the port's own library-conv path
        lib_map, _ = glancer.features(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got_map, lib_map.permute(0, 2, 3, 1).numpy(), BACKBONE_TOL)


def test_resnet_features_fused_matches_jax():
    x = np.random.RandomState(5).randn(2, 32, 32, 3).astype(np.float32)
    module = jres.resnet50(num_classes=10)
    vs = randomize_bn(jax.jit(module.init)(jax.random.key(0), jnp.asarray(x)), seed=5)
    want_map, want_pool = jax.jit(partial(jfi.resnet_features_fused, interpret=True))(
        vs, jnp.asarray(x))
    focuser = _load(tres.resnet50(num_classes=10), vs)
    got_map, got_pool = tfi.resnet_features_fused(focuser, torch.from_numpy(x))
    _close(got_map, want_map, BACKBONE_TOL)
    _close(got_pool, want_pool, BACKBONE_TOL)
    with torch.no_grad():
        lib_map, _ = focuser.features(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got_map, lib_map.permute(0, 2, 3, 1).numpy(), BACKBONE_TOL)


def test_inference_fused_matches_jax(monkeypatch):
    monkeypatch.setattr(jfb, "INTERPRET_DEFAULT", True)
    cfg, b = TINY, 2
    jmodel, variables = abstract_variables(cfg, seed=1)
    model = port_model(cfg, variables)
    rs = np.random.RandomState(2)
    t, s, g = cfg.num_frames, cfg.image_size, cfg.glance_size
    frames = rs.randn(b, t, s, s, 3).astype(np.float32)
    small = rs.randn(b, t, g, g, 3).astype(np.float32)
    flat = pad_for_extraction(jnp.asarray(frames.reshape(b * t, s, s, 3)))
    flat = flat.reshape((b, t) + flat.shape[1:])
    rng = jax.random.key(0)

    # JAX's phases each under one jit: eagerly each op compiles at each shape
    @jax.jit
    def glance_and_roll(variables, small, rng):
        fmap, _ = jfi.fused_glance(jmodel, variables, small)
        _, actor_logits, _ = jmodel.apply(
            variables, jnp.swapaxes(fmap, 0, 1),
            method=lambda m, v: m.policy.rollout_states(v))
        return actor_logits, jmodel.apply(variables, fmap, rng, "greedy", False,
                                          method=GFV.policy_rollout)

    actor_logits, roll = glance_and_roll(variables, jnp.asarray(small), rng)
    top2 = np.sort(np.asarray(actor_logits), axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-3   # no argmax near-tie
    with torch.inference_mode():
        got_fmap, _ = tfi.fused_glance(model, torch.from_numpy(small))
        got_roll = model.policy_rollout(got_fmap)
    np.testing.assert_array_equal(got_roll["action_idx"].numpy(),
                                  np.asarray(roll["action_idx"]))

    want = jax.jit(partial(inference, jmodel, fused="on"))(variables, flat, jnp.asarray(small),
                                                           rng)
    got = tgfv.inference(model, frames, small, device="cpu", fused="on")
    assert got.shape == (b, t, cfg.num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SLICE_TOL,
                               rtol=SLICE_TOL)
    off = tgfv.inference(model, frames, small, device="cpu", fused="off")
    np.testing.assert_allclose(got.numpy(), off.numpy(), atol=SLICE_TOL, rtol=SLICE_TOL)


def test_fused_routing_and_unported_tsm():
    # the temporal-shift backbones are ported (tests/test_torch_port_sthsth.py
    # holds them against JAX); a batch that is not whole clips is refused
    assert tfi.fused_enabled("on")
    assert not tfi.fused_enabled("auto") and not tfi.fused_enabled("off")
    x = torch.zeros(3, 32, 32, 3)
    with pytest.raises(ValueError, match="n_frames"):
        tfi.mobilenet_features_fused(tmob.MobileNetV2(10).eval(), x, n_frames=2)
    with pytest.raises(ValueError, match="n_frames"):
        tfi.resnet_features_fused(tres.resnet50(10).eval(), x, n_frames=2)


def _small_folds():
    gen = torch.Generator().manual_seed(0)
    ir = tmob.InvertedResidual(8, 8, 1, 6)
    bn = tres.Bottleneck(64, 16, 2, True)
    for m in (ir, bn):
        for p in m.parameters():
            p.data = torch.randn(p.shape, generator=gen) * 0.3
    return tfb.fold_inv_residual(ir), tfb.fold_bottleneck(bn)


def test_wrappers_check_flags_and_devices():
    ir, bn = _small_folds()
    x8, x64 = torch.zeros(2, 9, 9, 8), torch.zeros(2, 9, 9, 64)
    with pytest.raises(ValueError, match="residual requires"):
        tfb.fused_inverted_residual(x8, ir, stride=2, use_res=True)
    with pytest.raises(ValueError, match="identity residual"):
        tfb.fused_bottleneck(x64, bn._replace(wd=None, bd=None), stride=2)
    assert tfb.fused_bottleneck(x64, bn, stride=2).shape == (2, 5, 5, 64)
    before = (tfb.fused_inverted_residual.launches, tfb.fused_bottleneck.launches)
    ir_meta = tfb.InvResidualParams(*(t.to("meta") for t in ir))
    with pytest.raises(ValueError, match="no fused-block kernel"):
        tfb.fused_inverted_residual(x8.to("meta"), ir_meta, stride=1)
    with pytest.raises(ValueError, match="no fused-block kernel"):
        tfb.fused_bottleneck(x64.to("meta"), bn, stride=2)
    assert (tfb.fused_inverted_residual.launches, tfb.fused_bottleneck.launches) == before


# every distinct block of the flagship: (H, Cin, Chid, Cout, stride, expand /
# downsample) of the glancer at 224^2 and the focuser at 96^2 patches
FLAGSHIP_IR = [
    (112, 32, 32, 16, 1, False), (112, 16, 96, 24, 2, True), (56, 24, 144, 24, 1, True),
    (56, 24, 144, 32, 2, True), (28, 32, 192, 32, 1, True), (28, 32, 192, 64, 2, True),
    (14, 64, 384, 64, 1, True), (14, 64, 384, 96, 1, True), (14, 96, 576, 96, 1, True),
    (14, 96, 576, 160, 2, True), (7, 160, 960, 160, 1, True), (7, 160, 960, 320, 1, True),
]
FLAGSHIP_BOTTLENECK = [
    (24, 64, 64, 256, 1, True), (24, 256, 64, 256, 1, False), (24, 256, 128, 512, 2, True),
    (12, 512, 128, 512, 1, False), (12, 512, 256, 1024, 2, True),
    (6, 1024, 256, 1024, 1, False), (6, 1024, 512, 2048, 2, True),
    (3, 2048, 512, 2048, 1, False),
]


# odd shapes the CUDA tests and chip_smoke.py run: ragged depths and widths
ODD_IR = [(9, 8, 48, 12, 2, True), (9, 16, 16, 16, 2, False), (11, 20, 120, 12, 2, True)]
ODD_BOTTLENECK = [(9, 64, 16, 64, 2, True), (9, 20, 12, 48, 2, True)]


def _align(v, m=128):
    return -(-v // m) * m


def _region(t, s, size):
    return min((t - 1) * s + 3, size)


def _ir_smem_bf16(plan, h, cin, cout, s, expand):
    """fused_inv_residual.cu tc_layout, written out: the x region (rows of
    Cin rounded up to 16, padded by 16 bytes), the chunk's expand weights,
    the hidden, the depthwise output (64 rows a warpgroup tile), the chunk's
    project weights (the instance's width), a zero row, and two ints a row."""
    rows = 64 * (2 // plan.ns)
    mr = plan.g * _region(plan.th, s, h) * _region(plan.tw, s, h)
    cin_p = -(-cin // 16) * 16
    bnp = next(v for v in (16, 24, 32, 64, 96, 128, 160, 256) if -(-cout // plan.ns) <= v)
    return bnp, (_align(mr * (cin_p + 8) * 2)
                 + (_align(cin_p * 64 * 2) + _align(mr * 72 * 2) if expand else 0)
                 + _align(rows * 72 * 2) + _align(64 * plan.ns * bnp * 2)
                 + _align((cin_p + 8) * 2) + _align(rows * 8))


def _bottleneck_smem_bf16(plan, h, chid, s):
    """fused_bottleneck.cu tc_layout, written out: the ring (stages of the
    largest of conv1's x tiles and w1 tile, conv2's w2 tile, conv3's strided
    x tiles and w3 / wd tile; x rows padded by 16 bytes), one buffer for the
    h1 chunk or h2 (rows padded by 16 bytes), a zero row, eight mbarriers."""
    ns, depth = plan.ns, plan.depth
    bn2 = next(v for v in (16, 32, 64, 128, 256) if -(-chid // ns) <= v)
    mt, chid_p = 2 // ns, ns * bn2
    chunk = chid_p if plan.wide else 64
    a_tile = 64 * (depth + 8) * 2
    stage = max((mt if plan.wide else 2) * a_tile + depth * chunk * 2, depth * chid_p * 2,
                mt * a_tile + depth * ns * 128 * 2)
    h1 = plan.g * _region(plan.th, s, h) * _region(plan.tw, s, h) * (chunk + 8) * 2
    h2 = 64 * mt * (chid_p + 8) * 2
    return bn2, chunk, (plan.stages * stage + _align(max(h1, h2))
                        + _align((max(chunk, chid_p) + 8) * 2) + _align(8 * 8))


def _check_inv_residual_plan(h, cin, chid, cout, s, expand, itemsize, n):
    """The plan's shared memory is the kernel's layout, fits the card, and
    keeps the products' constraints."""
    plan = tfb.plan_inv_residual(h, h, cin, chid, cout, s, expand, itemsize, n)
    rh, rw = _region(plan.th, s, h), _region(plan.tw, s, h)
    opx = plan.g * plan.th * plan.tw
    assert plan.smem <= tfb.SMEM_MAX
    assert plan.g == 1 or (plan.th, plan.tw) == (tfb.out_size(h, s),) * 2
    if itemsize == 4:
        assert plan.smem == (tfb.STAGE_BYTES + opx * cout * 4
                             + (plan.g * rh * rw + opx) * plan.ch * itemsize)
        assert 1 <= plan.ch <= chid
        return
    bnp, smem = _ir_smem_bf16(plan, h, cin, cout, s, expand)
    assert plan.smem == smem
    # 64-row warpgroup tiles: both warpgroups on the same rows (ns = 2) or
    # one tile each; the project's width a multiple of 8 that holds Cout
    assert plan.ns in (1, 2) and opx <= 64 * (2 // plan.ns)
    assert bnp % 8 == 0 and plan.ns * bnp >= cout
    assert plan.ch == 64   # hidden chunk: a multiple of the products' depth of 16


def _check_bottleneck_plan(h, cin, chid, cout, s, down, itemsize, n):
    plan = tfb.plan_bottleneck(h, h, cin, chid, cout, s, down, itemsize, n)
    assert plan.smem <= tfb.SMEM_MAX
    assert plan.g == 1 or (plan.th, plan.tw) == (tfb.out_size(h, s),) * 2
    if itemsize == 4:
        rh, rw = _region(plan.th, s, h), _region(plan.tw, s, h)
        assert plan.smem == tfb.STAGE_BYTES + plan.g * (rh * rw + plan.th * plan.tw) * chid * 4
        return
    bn2, chunk, smem = _bottleneck_smem_bf16(plan, h, chid, s)
    assert plan.smem == smem
    assert plan.ns in (1, 2) and plan.g * plan.th * plan.tw <= 64 * (2 // plan.ns)
    assert plan.ns * bn2 >= chid and bn2 % 8 == 0
    # the hidden chunk is conv2's depth per pass: a multiple of 16 and of the
    # ring's depth, or the whole (padded) hidden layer
    assert chunk % 16 == 0 and chunk % plan.depth == 0 and plan.depth in (32, 64)
    assert not plan.wide or (chunk == plan.ns * bn2 and bn2 >= 64)
    assert 3 <= plan.stages <= 8


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
def test_plans_fit_shared_memory(itemsize):
    """Every flagship block's plan at the main path's N=1024 is laid out as
    its kernel lays it out and fits the card's shared memory."""
    for shape in FLAGSHIP_IR:
        _check_inv_residual_plan(*shape, itemsize, 1024)
    for shape in FLAGSHIP_BOTTLENECK:
        _check_bottleneck_plan(*shape, itemsize, 1024)


# small sample counts pick other plans (fewer samples per block, fewer waves)
@pytest.mark.parametrize("n", [9, 64])
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("h,cin,chid,cout,s,expand", FLAGSHIP_IR + ODD_IR)
def test_inv_residual_plan_fits_shared_memory(h, cin, chid, cout, s, expand, itemsize, n):
    _check_inv_residual_plan(h, cin, chid, cout, s, expand, itemsize, n)


@pytest.mark.parametrize("n", [9, 64])
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("h,cin,chid,cout,s,down", FLAGSHIP_BOTTLENECK + ODD_BOTTLENECK)
def test_bottleneck_plan_fits_shared_memory(h, cin, chid, cout, s, down, itemsize, n):
    _check_bottleneck_plan(h, cin, chid, cout, s, down, itemsize, n)


def test_pack_tiles_matches_the_kernel_layout():
    """Tile (n-tile, k-block) of pack_tiles holds element (k, n) at
    (k % depth / 8) * nb * 8 + (n % nb / 8) * 64 + (k % 8) * 8 + n % 8,
    the wgmma B layout of fused_gemm.cuh, zero past K and N."""
    rs = np.random.RandomState(0)
    w = torch.from_numpy(rs.randn(3, 40, 20).astype(np.float32))
    depth, nb, k_total = 32, 16, 64
    got = tfb.pack_tiles(w, depth, nb, k_total).reshape(3, -1).numpy()
    want = np.zeros_like(got)
    for k in range(40):
        for n in range(20):
            tile = (n // nb) * (k_total // depth) + k // depth
            off = (tile * depth * nb + (k % depth // 8) * nb * 8 + (n % nb // 8) * 64
                   + (k % 8) * 8 + n % 8)
            want[:, off] = w[:, k, n].numpy()
    np.testing.assert_array_equal(got, want)
