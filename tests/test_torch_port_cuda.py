"""The CUDA kernels against their plain versions, on a GPU.

Every test here is marked ``cuda`` and skips where no GPU is visible: a
CUDA kernel has no CPU or interpret mode. The file imports nothing of JAX,
so it runs on a machine without it, past tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Patch extraction is a copy: it is held bit-identical to the plain version,
at every source misalignment (x*C*e mod 16), on an unaligned base, at the N=16 band split, above N = 65535, with starts that
wrap and clamp, in 1-, 2- and 4-byte elements, from offsets and from
actions.

Under autograd the patch kernel still launches once a forward, and the
backward (a scatter in plain PyTorch) on the card equals the CPU's bit for
bit. One stage-1 train step at the tiny configuration on the card leaves
the frozen glancer and policy bit-identical; one stage-2 (PPO) step launches
the patch kernel twice, leaves everything but the policy bit-identical and
moves every policy parameter. The policy's sampler draws each class from a
CUDA generator at its softmax frequency, within 5 sigma. A stage-1 step over
a one-rank NCCL group equals the plain step bit for bit.

AdaFocus+ on the card: its top-K picks the CPU's frames among tied scores;
the patch kernel on frames gathered at K of T indices equals the plain
version bit for bit; its stage-1 and joint stage-2 steps at the tiny
configuration launch the patch kernel once and twice and leave the frozen
components bit-identical.

The data layer: the device cache's batches are CUDA tensors equal to the
host cache's; prefetching takes an unindexed CUDA device; the batch prep on the card (augmentation, views, glance
downsample) matches the CPU's on the same uint8 batch and draws within
max|d| / max|cpu| <= 1e-4, float32 with TF32 off.

Export: the four custom ops (``adafocus_torch::extract_patches``,
``extract_patches_at``, ``int8_conv``, ``int8_dwconv``) pass
``torch.library.opcheck`` on CUDA tensors; a tiny artifact exported on the
card, saved and reloaded holds every state tensor on the card, launches the
patch kernel once a forward (int8: also 86 ``int8_conv`` and 17
``int8_dwconv``, no fused block) and serves the eager forward's logits
(max|d| / max|eager| <= 1e-5; the same ops run).

The tooling: each ResNet variant over 4 patches of 96^2 in bf16 against
float32 (TF32 off) within 3e-2; ``utils.profiling.trace`` around a tiny
forward on the card, ``top_ops`` showing the patch kernel once and summing
to the trace's device events.

The fused blocks' tolerance, max|kernel - plain| / max|plain|: 1e-4 in
float32 (summation order only, TF32 off) and 2e-2 in bf16 (a hidden value
whose rounding flips moves by one bf16 ulp). Their cases cover the bf16
tensor-core kernels' edges: depths that are not a multiple of 16 (Cin 24,
20; Chid 144, 12), widths that are not a multiple of 8 or of the tile
(Cout 12; Chid 16), rows that are not 16-byte aligned (Cin 20), a sample
count that is not a multiple of the samples per block, both ways of sharing
a block between its two warpgroups, and the flagship's widest bottlenecks
at N=9. Both also run at every distinct block shape of the matched sth-sth
configuration in its temporal-shift split (``use_res=False``, N=4): the
glancer's residual blocks at 224^2 and every focuser bottleneck at 144^2
patches (36^2 to 5^2 maps), the down blocks without their ``down``.
"""

import pytest
import torch

from adafocus_torch.models import gfv as tgfv
from adafocus_torch.models import mobilenet as tmob
from adafocus_torch.models import policy as tpolicy
from adafocus_torch.models import resnet as tres
from adafocus_torch.ops import fused_blocks as tfb
from adafocus_torch.ops import patch as tpatch
from adafocus_torch.train import stages as tstages


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")


CUDA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _patch_frames(n, h, w, c, dtype, gen, unaligned=False):
    shape = (n, h, w, c)
    numel = n * h * w * c
    if dtype.is_floating_point:
        flat = torch.randn(numel + 1, generator=gen).to(dtype)
    else:
        flat = torch.randint(-2**31, 2**31 - 1, (numel + 1,), generator=gen).to(dtype)
    flat = flat.cuda()
    # a view one element in: its base is not 16-byte aligned
    return flat[1:].view(shape) if unaligned else flat[:numel].view(shape)


def _patch_offsets(n, h, w, p, gen):
    # starts that wrap (negative) and clamp (past the edge), then every
    # source column x in 0..15, so x*C*e takes every residue mod 16 that it can
    offs = torch.stack([torch.randint(-h // 2, h + 4, (n,), generator=gen),
                        torch.randint(-w // 2, w + 4, (n,), generator=gen)], 1)
    k = min(n, 16, w - p + 1)
    offs[:k, 1] = torch.arange(k)
    return offs.to(torch.int32).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,p,dtype,unaligned", [
    (16, 224, 224, 3, 96, torch.bfloat16, False),   # batch 1 of the flagship: the band split
    (16, 40, 48, 3, 16, torch.int8, False),         # every residue of x*C mod 16
    (8, 40, 48, 3, 16, torch.bfloat16, False),
    (9, 41, 48, 3, 16, torch.float32, False),
    (7, 40, 48, 3, 16, torch.bfloat16, True),       # unaligned base
    (7, 40, 48, 3, 16, torch.int8, True),
    (9, 41, 50, 3, 17, torch.bfloat16, False),      # odd rows
    (7, 50, 77, 5, 13, torch.int8, False),
    (5, 37, 37, 3, 11, torch.float32, False),
    (70000, 12, 16, 3, 8, torch.bfloat16, False),   # N > 65535
], ids=["n16-bf16", "residues-int8", "residues-bf16", "f32", "unaligned-bf16",
        "unaligned-int8", "odd-bf16", "odd-c5-int8", "odd-f32", "n70000-bf16"])
def test_cuda_kernel_matches_reference(n, h, w, c, p, dtype, unaligned):
    _needs_gpu()
    gen = torch.Generator().manual_seed(n + h + w + p)
    frames = _patch_frames(n, h, w, c, dtype, gen, unaligned)
    offs = _patch_offsets(n, h, w, p, gen)
    assert (frames.data_ptr() % 16 != 0) == unaligned
    before = tpatch.extract_patches.launches
    got = tpatch.extract_patches(frames, offs, p)
    torch.cuda.synchronize()
    assert tpatch.extract_patches.launches == before + 1
    assert torch.equal(got, tpatch.extract_patches_reference(frames, offs, p))


@pytest.mark.cuda
@pytest.mark.parametrize("c,p,dtype", [(3, 96, torch.int32), (3, 17, torch.int32),
                                       (3, 96, torch.bfloat16)])
def test_cuda_extract_at_matches_patch_offsets(c, p, dtype):
    # the offsets computed inside the kernel equal patch_offsets' for the
    # flagship's 49-anchor grid values plus 0 and 1, from (B, T, 2) actions
    # laid out as the policy returns them (transposed)
    _needs_gpu()
    from adafocus_torch.models.policy import discrete_to_coords

    b, t, s = 3, 17, 224
    grid = discrete_to_coords(torch.arange(49), 49)
    acts = torch.cat([grid, torch.tensor([[0.0, 0.0], [1.0, 1.0]])]).reshape(t, b, 2)
    acts = acts.cuda().transpose(0, 1)
    gen = torch.Generator().manual_seed(p)
    frames = _patch_frames(b * t, s, s, c, dtype, gen).reshape(b, t, s, s, c)
    before = tpatch.extract_patches.launches
    got = tpatch.extract_patches_at(frames, acts, s, p)
    torch.cuda.synchronize()
    assert tpatch.extract_patches.launches == before + 1
    offs = tpatch.patch_offsets(acts.reshape(b * t, 2), s, p)
    want = tpatch.extract_patches_reference(frames.reshape(b * t, s, s, c), offs, p)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("from_actions", [False, True], ids=["offsets", "actions"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_patch_function_matches_cpu(from_actions, dtype):
    # the kernel once a forward under autograd; forward and backward equal
    # to the plain version's on the CPU, bit for bit (starts that wrap and
    # clamp from offsets)
    _needs_gpu()
    b, t, s, p = 2, 5, 40, 16
    gen = torch.Generator().manual_seed(p + int(from_actions))
    frames = torch.randn((b, t, s, s, 3), generator=gen).to(dtype)
    cot = torch.randn((b * t, p, p, 3), generator=gen).to(dtype)
    actions = torch.rand((b, t, 2), generator=gen)
    offs = torch.randint(-20, 60, (b * t, 2), generator=gen, dtype=torch.int32)
    results = []
    for dev in ("cuda", "cpu"):
        src = frames.to(dev, copy=True).requires_grad_()
        before = tpatch.extract_patches.launches
        if from_actions:
            out = tpatch.extract_patches_at(src, actions.to(dev), s, p)
        else:
            out = tpatch.extract_patches(src.reshape(b * t, s, s, 3), offs.to(dev), p)
        out.backward(cot.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert tpatch.extract_patches.launches == before + 1
        results.append((out.detach().cpu(), src.grad.cpu()))
    assert torch.equal(results[0][0], results[1][0])
    assert torch.equal(results[0][1], results[1][1])


@pytest.mark.cuda
def test_cuda_stage1_step_keeps_frozen_components():
    _needs_gpu()
    cfg = tgfv.flagship(tiny=True)
    state = tstages.create_train_state(cfg, 1, device="cuda",
                                       generator=torch.Generator().manual_seed(0))
    model = state.model
    step = tstages.make_stage_train_step(model, 1, state.optimizer, state.scheduler)
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, t, s, g = 2, cfg.num_frames, cfg.image_size, cfg.glance_size
    batch = {"frames": torch.randn((b, t, s, s, 3), generator=gen, device="cuda"),
             "frames_small": torch.randn((b, t, g, g, 3), generator=gen, device="cuda"),
             "labels": torch.tensor([1, 4], device="cuda")}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    launches = tpatch.extract_patches.launches
    metrics = step(batch, gen)
    torch.cuda.synchronize()
    assert tpatch.extract_patches.launches == launches + 1
    assert torch.isfinite(metrics["loss"])
    after = model.state_dict()
    for key, value in before.items():
        if key.startswith(("glancer.", "policy.")):
            assert torch.equal(value, after[key]), key
    assert not torch.equal(before["focuser.stem.conv.weight"], after["focuser.stem.conv.weight"])
    assert not torch.equal(before["focuser.stem.bn.running_var"],
                           after["focuser.stem.bn.running_var"])


@pytest.mark.cuda
def test_cuda_one_rank_nccl_stage1_step_matches_plain(tmp_path):
    """A stage-1 step over a one-rank NCCL group, whose averages are
    identities, equals the plain step on the same weights, batch and
    actions bit for bit (cuDNN's deterministic algorithms); each launches
    the patch kernel once."""
    _needs_gpu()
    from adafocus_torch.parallel import mesh

    cfg = tgfv.flagship(tiny=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, t, s, g = 2, cfg.num_frames, cfg.image_size, cfg.glance_size
    batch = {"frames": torch.randn((b, t, s, s, 3), generator=gen, device="cuda"),
             "frames_small": torch.randn((b, t, g, g, 3), generator=gen, device="cuda"),
             "labels": torch.tensor([1, 4], device="cuda")}
    actions = torch.rand((b, t, 2), generator=gen, device="cuda")
    replicas = mesh.init_replicas(f"file://{tmp_path}/rendezvous", 1, 0, "cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = []
        for group in (None, replicas):
            state = tstages.create_train_state(cfg, 1, device="cuda",
                                               generator=torch.Generator().manual_seed(0))
            step = tstages.make_stage_train_step(state.model, 1, state.optimizer,
                                                 state.scheduler, group)
            launches = tpatch.extract_patches.launches
            metrics = step(batch, None, actions)
            torch.cuda.synchronize()
            assert tpatch.extract_patches.launches == launches + 1
            out.append(({k: float(v) for k, v in metrics.items()}, state.model.state_dict()))
    finally:
        torch.backends.cudnn.deterministic = deterministic
        mesh.shutdown(replicas)
    (m_plain, sd_plain), (m_group, sd_group) = out
    assert m_plain == m_group
    for key, value in sd_plain.items():
        assert torch.equal(value, sd_group[key]), key


@pytest.mark.cuda
def test_cuda_stage2_step_trains_only_the_policy():
    _needs_gpu()
    cfg = tgfv.flagship(tiny=True)
    state = tstages.create_train_state(cfg, 2, device="cuda",
                                       generator=torch.Generator().manual_seed(0))
    model = state.model
    step = tstages.make_stage2_step(model, state.ppo)
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, t, s, g = 2, cfg.num_frames, cfg.image_size, cfg.glance_size
    batch = {"frames": torch.randn((b, t, s, s, 3), generator=gen, device="cuda"),
             "frames_small": torch.randn((b, t, g, g, 3), generator=gen, device="cuda"),
             "labels": torch.tensor([1, 4], device="cuda")}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    launches = tpatch.extract_patches.launches
    metrics = step(batch, gen)
    torch.cuda.synchronize()
    assert tpatch.extract_patches.launches == launches + 2
    assert all(torch.isfinite(v) for v in metrics.values())
    assert abs(float(metrics["ppo/ratio_mean"]) - 1.0) <= 1e-6
    after = model.state_dict()
    for key, value in before.items():
        moved = not torch.equal(value, after[key])
        assert moved == key.startswith("policy."), key


_TIED_SCORES = {
    "issue_row": ([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0]], 2),
    "bf16_rounded": ([[0.1234, 0.5, 0.1235, 0.1236, -1.0, 0.5, 0.1234, 0.0]], 4),
    "few_levels": (torch.randint(0, 3, (64, 16), generator=torch.Generator().manual_seed(0))
                   .float().tolist(), 8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_TIED_SCORES))
def test_cuda_plus_top_k_ties_match_cpu(case):
    """AdaFocus+'s top-K on the card picks the CPU's frames among tied
    scores (ties toward the lower index, as ``jax.lax.top_k``), in bf16 and
    float32, and the straight-through mask is the hard mask exactly."""
    _needs_gpu()
    from adafocus_torch.models import gfv_plus as tplus

    rows, k = _TIED_SCORES[case]
    for dtype in (torch.float32, torch.bfloat16):
        scores = torch.tensor(rows).to(dtype).float()
        want, _ = tplus.select_topk(scores, k, "top")
        got, mask = tplus.select_topk(scores.cuda(), k, "top")
        assert torch.equal(got.cpu(), want), dtype
        assert torch.equal(mask, torch.zeros_like(mask).scatter(1, got, 1.0))
        noise = tplus.random_frame_selection(*scores.shape, k, noise=scores.cuda())
        assert torch.equal(noise.cpu(), want)


@pytest.mark.cuda
def test_cuda_patch_kernel_on_gathered_frames():
    """The patch kernel on frames gathered at AdaFocus+'s K of T indices
    (one launch) equals the plain version on the CPU bit for bit, and the
    patches of the ungathered frames at the same frames and actions."""
    _needs_gpu()
    from adafocus_torch.models import gfv_plus as tplus

    gen = torch.Generator().manual_seed(3)
    b, t, k, s, p = 3, 16, 8, 224, 96
    frames = torch.randn((b, t, s, s, 3), generator=gen).bfloat16()
    idx = tplus.random_frame_selection(b, t, k, gen)
    actions = torch.rand((b, k, 2), generator=gen)
    gathered = tplus.gather_frames(frames.cuda(), idx.cuda())
    assert gathered.is_contiguous() and gathered.shape == (b, k, s, s, 3)
    launches = tpatch.extract_patches.launches
    got = tpatch.extract_patches_at(gathered, actions.cuda(), s, p)
    torch.cuda.synchronize()
    assert tpatch.extract_patches.launches == launches + 1
    offs = tpatch.patch_offsets(actions.reshape(-1, 2), s, p)
    sel = tplus.gather_frames(frames, idx).reshape(b * k, s, s, 3)
    assert torch.equal(got.cpu(), tpatch.extract_patches_reference(sel, offs, p))
    rows = (torch.arange(b)[:, None] * t + idx).reshape(-1)
    assert torch.equal(got.cpu(), tpatch.extract_patches_reference(
        frames.reshape(b * t, s, s, 3)[rows], offs, p))


@pytest.mark.cuda
@pytest.mark.parametrize("rl", [False, True], ids=["st", "rl"])
def test_cuda_plus_steps_launch_and_freeze(rl):
    """AdaFocus+ at a tiny configuration on the card: the stage-1 step and,
    with ``plus_rl``, the joint stage-2 step launch the patch kernel once
    and twice; stage 1 leaves the glancer, the policy and the selector
    actor-critic bit-identical, the joint stage 2 everything but the policy
    and the selector actor-critic, and each trained component moves."""
    _needs_gpu()
    import dataclasses

    from adafocus_torch.train import stages_plus as tsplus

    cfg = dataclasses.replace(tgfv.flagship(tiny=True), num_frames=6, frame_budget=3,
                              selector_hidden=8, plus_rl=rl)
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, t, s, g = 2, cfg.num_frames, cfg.image_size, cfg.glance_size
    batch = {"frames": torch.randn((b, t, s, s, 3), generator=gen, device="cuda"),
             "frames_small": torch.randn((b, t, g, g, 3), generator=gen, device="cuda"),
             "labels": torch.tensor([1, 4], device="cuda")}
    for stage in ((1, 2) if rl else (1,)):
        state = tstages.create_train_state(cfg, stage, device="cuda",
                                           generator=torch.Generator().manual_seed(0))
        model = state.model
        step = tsplus.make_plus_stage2_joint_step(model, state.ppo) if stage == 2 else \
            tsplus.make_plus_train_step(model, 1, state.optimizer, state.scheduler)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        launches = tpatch.extract_patches.launches
        metrics = step(batch, gen)
        torch.cuda.synchronize()
        assert tpatch.extract_patches.launches == launches + stage
        assert all(torch.isfinite(v) for v in metrics.values())
        after = model.state_dict()
        frozen = ("glancer.", "focuser.", "classifier.") if stage == 2 else \
            ("glancer.", "policy.", "selector_ac.")
        for key, value in before.items():
            if key.startswith(frozen):
                assert torch.equal(value, after[key]), key
        trained = ("policy.", "selector_ac.") if stage == 2 else ("focuser.", "classifier.")
        for prefix in trained:
            assert any(not torch.equal(v, after[k]) for k, v in before.items()
                       if k.startswith(prefix)), prefix
        if stage == 2:
            assert abs(float(metrics["ppo/ratio_mean"]) - 1.0) <= 1e-6


def _synthetic_loader(cache: str, device=None):
    from adafocus_torch.data import cache as tcache
    from adafocus_torch.data import pipeline as tpipe
    from adafocus_torch.data.records import VideoRecord

    records = [VideoRecord(f"v{i}", 6, (i % 3, -1, -1)) for i in range(8)]
    cfg = tpipe.LoaderConfig(num_segments=4, canvas_size=40, batch_size=4, seed=3,
                             num_workers=2)
    return tcache.maybe_cache(tpipe.VideoLoader(records, tpipe.SyntheticVideoSource(), cfg),
                              cache, device)


@pytest.mark.cuda
def test_cuda_device_cache_gathers_on_the_card():
    """The device cache's batches are CUDA tensors equal to the host
    cache's, and only its fill copies frames to the card."""
    _needs_gpu()
    host, card = _synthetic_loader("host"), _synthetic_loader("device", torch.device("cuda"))
    card.fill()
    assert card._frames.is_cuda and card.nbytes == 8 * 6 * 40 * 40 * 3
    for epoch in (0, 1):
        host.set_epoch(epoch)
        card.set_epoch(epoch)
        for a, b in zip(host, card):
            assert b["frames"].is_cuda and b["frames"].dtype == torch.uint8
            assert torch.equal(b["frames"].cpu(), torch.from_numpy(a["frames"]))
            assert (a["labels"] == b["labels"]).all()


@pytest.mark.cuda
def test_cuda_prefetch_on_an_unindexed_device():
    """The prefetch thread takes the card as ``torch.device("cuda")`` (no
    index) and its batches are the sequential ones."""
    _needs_gpu()
    from adafocus_torch.data.prefetch import prefetch_to_device

    def prep(raw, i):
        return torch.full((4,), float(raw), device="cuda") * (i + 1)

    got = list(prefetch_to_device(range(5), prep, device=torch.device("cuda")))
    assert [float(t[0]) for t in got] == [float(k * (k + 1)) for k in range(5)]


@pytest.mark.cuda
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_cuda_batch_prep_matches_cpu(train):
    """The batch prep on the card against the CPU's on one uint8 batch with
    the same draws, float32 with TF32 off: max|d| / max|cpu| <= 1e-4."""
    _needs_gpu()
    from adafocus_torch import config as tconfig
    from adafocus_torch.cli import common as tcommon
    from adafocus_torch.data import transforms as tt

    cfg = tconfig.load_config("configs/actnet_default.yaml", [
        "model.dtype=float32", "model.glance_size=112", "augment.eval_crops=oversample"])
    raw = {"frames": torch.randint(0, 256, (3, 16, 256, 256, 3), dtype=torch.uint8,
                                   generator=torch.Generator().manual_seed(0)).numpy(),
           "labels": torch.tensor([[1, -1, -1], [2, 5, -1], [0, -1, -1]]).numpy()}
    draws = tt.draw_augment(3, 256, cfg.augment, torch.Generator().manual_seed(1),
                            torch.device("cpu"))
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        want, _, _ = tcommon.make_batch_prep(cfg, train, torch.device("cpu"))(raw, None, draws)
        prep = tcommon.make_batch_prep(cfg, train, torch.device("cuda"))
        got, _, _ = prep(raw, None, draws)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    for key in ("frames", "frames_small"):
        assert got[key].is_cuda and got[key].shape == want[key].shape
        assert _rel_err(got[key].cpu(), want[key]) <= 1e-4, key
    assert torch.equal(got["labels"].cpu(), want["labels"])


@pytest.mark.cuda
def test_cuda_sampler_frequencies():
    # 10^6 draws over K=49 from one row of logits on a CUDA generator
    _needs_gpu()
    n = 1_000_000
    row = torch.randn(49, generator=torch.Generator().manual_seed(3)).cuda() * 2
    draws, logp = tpolicy.sample_discrete(row.expand(n, 49),
                                          torch.Generator(device="cuda").manual_seed(4))
    torch.testing.assert_close(logp, torch.log_softmax(row, -1)[draws], rtol=0, atol=1e-6)
    freq = torch.bincount(draws, minlength=49).double() / n
    p = torch.softmax(row.double(), -1)
    assert ((freq - p).abs() <= 5 * (p * (1 - p) / n).sqrt()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cin,cout,stride,expand,size,use_res,n", [
    (8, 8, 1, 6, 16, True, 5), (8, 12, 2, 6, 9, False, 5), (16, 16, 1, 1, 13, False, 5),
    (32, 16, 1, 1, 20, False, 5), (24, 24, 1, 6, 12, False, 5),
    (24, 24, 1, 6, 56, True, 3),     # Cin 24, Chid 144: depth not a multiple of 16
    (24, 32, 2, 6, 56, False, 3),
    (20, 12, 2, 6, 11, False, 7),    # x rows not 16-byte aligned, Cout 12
    (96, 160, 2, 6, 14, False, 9),   # the project's width split between warpgroups
    (160, 320, 1, 6, 7, False, 9),
])
def test_cuda_inverted_residual_matches_reference(dtype, cin, cout, stride, expand,
                                                  size, use_res, n):
    _check_inverted_residual(dtype, cin, cout, stride, expand, size, use_res, n)


def _check_inverted_residual(dtype, cin, cout, stride, expand, size, use_res, n):
    _needs_gpu()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(cin + size)
    block = tmob.InvertedResidual(cin, cout, stride, expand)
    for prm in block.parameters():
        prm.data = torch.rand(prm.shape, generator=gen) - 0.5
    fold = tfb.fold_inv_residual(block.cuda(), dtype)
    x = torch.randn((n, size, size, cin), generator=gen).to("cuda", dtype)
    before = tfb.fused_inverted_residual.launches
    got = tfb.fused_inverted_residual(x, fold, stride, use_res)
    torch.cuda.synchronize()
    assert tfb.fused_inverted_residual.launches == before + 1
    want = tfb.fused_inverted_residual_reference(x, fold, stride, use_res)
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel_err(got, want) <= CUDA_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cin,features,stride,downsample,size,use_res,n", [
    (64, 16, 1, True, 8, True, 3), (64, 16, 1, False, 8, True, 3),
    (64, 16, 2, True, 9, True, 3), (64, 16, 1, False, 7, False, 3),
    (20, 12, 2, True, 9, True, 5),        # Cin 20: unaligned rows; Chid 12
    (256, 64, 1, False, 24, True, 3),     # layer1's width, tiles smaller than the map
    (1024, 256, 1, False, 6, True, 9),    # layer3_1: N not a multiple of g
    (1024, 512, 2, True, 6, True, 9),     # layer4_0: conv2's width split
    (1024, 512, 2, True, 6, False, 9),
])
def test_cuda_bottleneck_matches_reference(dtype, cin, features, stride, downsample, size,
                                           use_res, n):
    _check_bottleneck(dtype, cin, features, stride, downsample, size, use_res, n)


def _check_bottleneck(dtype, cin, features, stride, downsample, size, use_res, n):
    _needs_gpu()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(size + cin)
    block = tres.Bottleneck(cin, features, stride, downsample)
    for prm in block.parameters():
        prm.data = torch.rand(prm.shape, generator=gen) - 0.5
    fold = tfb.fold_bottleneck(block.cuda(), dtype)
    x = torch.randn((n, size, size, cin), generator=gen).to("cuda", dtype)
    before = tfb.fused_bottleneck.launches
    got = tfb.fused_bottleneck(x, fold, stride, use_res)
    torch.cuda.synchronize()
    assert tfb.fused_bottleneck.launches == before + 1
    want = tfb.fused_bottleneck_reference(x, fold, stride, use_res)
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel_err(got, want) <= CUDA_TOL[dtype]


# every distinct block of the matched sth-sth configuration (224^2 glance,
# 144^2 patches) that runs in the temporal-shift split, use_res=False on the
# shifted input: the glancer's residual blocks (H, C, expand ratio) and every
# focuser bottleneck (H, Cin, features, stride, downsample), whose ``down``
# runs outside the kernel
MATCHED_TSM_IR = [(56, 24, 6), (28, 32, 6), (14, 64, 6), (14, 96, 6), (7, 160, 6)]
MATCHED_TSM_BOTTLENECK = [
    (36, 64, 64, 1, True), (36, 256, 64, 1, False), (36, 256, 128, 2, True),
    (18, 512, 128, 1, False), (18, 512, 256, 2, True), (9, 1024, 256, 1, False),
    (9, 1024, 512, 2, True), (5, 2048, 512, 1, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("size,c,expand", MATCHED_TSM_IR)
def test_cuda_inverted_residual_tsm_split_matches_reference(dtype, size, c, expand):
    _check_inverted_residual(dtype, c, c, 1, expand, size, False, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("size,cin,features,stride,downsample", MATCHED_TSM_BOTTLENECK)
def test_cuda_bottleneck_tsm_split_matches_reference(dtype, size, cin, features, stride,
                                                     downsample):
    _check_bottleneck(dtype, cin, features, stride, downsample, size, False, 4)


# ---------------------------------------------------------------------------
# int8 serving: the two int8 kernels (csrc/int8_conv.cu) against their plain
# versions, and the int8 forward's launches
# ---------------------------------------------------------------------------

def _int8_unit(cout, cin, k, gen, depthwise=False):
    from adafocus_torch.ops import quant as tq

    w = torch.randn((cout, 1 if depthwise else cin, k, k) if k else (cout, cin), generator=gen)
    kq, ws = tq.quantize_weight(w)
    unit = tq.QConv(kq, ws, torch.randn(cout, generator=gen), torch.tensor(0.031))
    return tq.prepare_qconv(tq.QConv(*(t.cuda() for t in unit[:4])), depthwise=depthwise)


def _check_int8(run, acc, plain):
    """Accumulators equal; float32 outputs equal but for a double rounding
    of the plain version's float64-emulated FMA (1 ulp); bf16 the float32
    output rounded."""
    got_acc = run(torch.int32)
    torch.cuda.synchronize()
    assert torch.equal(got_acc.double(), acc)
    got, want = run(torch.float32), plain(torch.float32)
    diff = got != want
    if diff.any():
        ulps = (got[diff].view(torch.int32).long() - want[diff].view(torch.int32).long()).abs()
        assert ulps.max().item() <= 1
    assert torch.equal(run(torch.bfloat16), got.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,cin,cout,k,stride,act", [
    (2, 14, 32, 48, 1, 1, "relu6"), (2, 13, 64, 64, 3, 1, "relu"), (3, 9, 128, 72, 3, 2, None),
    (2, 28, 24, 144, 1, 1, "relu6"), (2, 12, 256, 512, 1, 2, None), (1, 5, 40, 1000, 3, 1, None),
    (2, 7, 16, 8, 3, 2, "relu")],
    ids=["1x1", "3x3s1", "3x3s2_odd", "cin24", "1x1s2", "cin40_wide", "cin16_narrow"])
def test_cuda_int8_conv_matches_reference(n, h, cin, cout, k, stride, act):
    """The GEMM kernel: both load paths (16-byte rows, Cin % 16 == 0, and
    the byte gather, Cin = 24 and 40), depth tails, widths that are not a
    multiple of the tile, odd maps."""
    from adafocus_torch.ops import quant as tq

    _needs_gpu()
    gen = torch.Generator().manual_seed(31)
    unit = _int8_unit(cout, cin, k, gen)
    x = torch.randint(-127, 128, (n, h, h, cin), generator=gen, dtype=torch.int8).cuda()
    acc = tq.conv_acc_reference(x, unit.kernel_q, stride)
    before = tq.int8_conv.launches
    _check_int8(lambda dt: tq.int8_conv(x, unit, stride, 1, act, dt), acc,
                lambda dt: tq.epilogue_reference(acc, unit.rescale, unit.bias, act, dt))
    assert tq.int8_conv.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 3328, 3072), (1, 1024, 49), (64, 1024, 3072),
                                   (17, 1568, 1024), (5, 24, 1)],
                         ids=["gru_x_b1", "actor_b1", "gru_b64", "fc_m17", "k24_n1"])
def test_cuda_int8_dense_matches_reference(m, k, n):
    from adafocus_torch.ops import quant as tq

    _needs_gpu()
    gen = torch.Generator().manual_seed(32)
    unit = _int8_unit(n, k, 0, gen)
    x = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8).cuda()
    acc = x.double() @ unit.kernel_q.double().t()
    _check_int8(lambda dt: tq.int8_dense(x, unit, None, dt), acc,
                lambda dt: tq.epilogue_reference(acc, unit.rescale, unit.bias, None, dt))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,c,stride", [(2, 56, 144, 2), (2, 14, 576, 1), (3, 7, 960, 1),
                                          (2, 9, 24, 2), (1, 5, 40, 1)],
                         ids=["56s2", "14s1", "7s1", "c24_odd_s2", "c40"])
def test_cuda_int8_dwconv_matches_reference(n, h, c, stride):
    """The depthwise kernel: 16 channels a thread (C % 16 == 0) and one
    channel a thread (C = 24, 40), odd maps at stride 2."""
    from adafocus_torch.ops import quant as tq

    _needs_gpu()
    gen = torch.Generator().manual_seed(33)
    unit = _int8_unit(c, c, 3, gen, depthwise=True)
    x = torch.randint(-127, 128, (n, h, h, c), generator=gen, dtype=torch.int8).cuda()
    acc = tq.conv_acc_reference(x, unit.kernel_q, stride, groups=c)
    before = tq.int8_dwconv.launches
    _check_int8(lambda dt: tq.int8_conv(x, unit, stride, c, "relu6", dt), acc,
                lambda dt: tq.epilogue_reference(acc, unit.rescale, unit.bias, "relu6", dt))
    assert tq.int8_dwconv.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [False, True], ids=["int8", "int8+heads"])
def test_cuda_q8_forward_launches(heads):
    """The tiny configuration's int8 forward on the card: one patch launch,
    every backbone unit an int8 launch (16 expand, 17 project and the head
    conv of the glancer, 52 focuser convs; 17 depthwise), no fused block;
    logits finite and close to the CPU's (the same int8 arithmetic; the
    stems' float convolutions round differently, which may move a code)."""
    from adafocus_torch.models import quant_inference as tqi
    from adafocus_torch.ops import quant as tq

    _needs_gpu()
    cfg = tgfv.flagship(tiny=True)
    gen = torch.Generator().manual_seed(34)
    frames = torch.randn((2, cfg.num_frames, cfg.image_size, cfg.image_size, 3), generator=gen)
    small = torch.randn((2, cfg.num_frames, cfg.glance_size, cfg.glance_size, 3), generator=gen)
    patches = torch.randn((4, cfg.patch_size, cfg.patch_size, 3), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        model = tgfv.GFV(cfg, device=dev)
        scales = tqi.calibrate_gfv(model, [{"frames_small": small, "patches": patches}],
                                   heads=heads)
        qw = tqi.prepare_q8(model, scales)
        counts = (tpatch.extract_patches, tq.int8_conv, tq.int8_dwconv,
                  tfb.fused_inverted_residual, tfb.fused_bottleneck)
        for fn in counts:
            fn.launches = 0
        out[dev] = tqi.inference_q8(model, scales, tq.quantize_frames(frames.to(dev)),
                                    tq.quantize_frames(small.to(dev)), device=dev, qw=qw)
        if dev == "cuda":
            torch.cuda.synchronize()
            head_launches = 2 * cfg.num_frames + 7 if heads else 0
            assert [fn.launches for fn in counts] == [1, 86 + head_launches, 17, 0, 0]
    got, want = out["cuda"].cpu(), out["cpu"]
    assert torch.isfinite(got).all()
    cos = torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0)
    assert cos.item() > 0.99


# ---------------------------------------------------------------------------
# export: the custom ops on CUDA tensors, and a tiny artifact exported on the
# card, reloaded and launching the kernels
# ---------------------------------------------------------------------------

def _opcheck_cases():
    from adafocus_torch.ops import quant as tq

    gen = torch.Generator().manual_seed(35)
    frames = torch.randn((6, 20, 23, 3), generator=gen).cuda()
    offsets = torch.tensor([[0, 0], [-3, 5], [13, 16], [20, 32], [5, -1], [2, 11]],
                           dtype=torch.int32).cuda()
    actions = torch.rand((2, 3, 2), generator=gen).cuda()
    x = torch.randint(-127, 128, (2, 9, 9, 32), generator=gen, dtype=torch.int8).cuda()
    w = tq.pack_conv_weight(torch.randint(-127, 128, (40, 32, 3, 3), generator=gen,
                                          dtype=torch.int8).cuda())
    dw = tq.pack_dw_weight(torch.randint(-127, 128, (32, 1, 3, 3), generator=gen,
                                         dtype=torch.int8).cuda())
    rescale = (torch.rand(40, generator=gen) * 1e-3).cuda()
    bias = torch.randn(40, generator=gen).cuda()
    return {
        "extract_patches": (tpatch._patches_op, (frames.requires_grad_(), offsets, 7)),
        "extract_patches_at": (tpatch._patches_at_op,
                               (frames.detach().requires_grad_(), actions, 20, 7)),
        "int8_conv": (tq._int8_conv_op, (x, w, rescale, bias, 3, 2, tq.ACTS["relu6"],
                                         torch.bfloat16)),
        "int8_dwconv": (tq._int8_dwconv_op, (x, dw, rescale[:32].contiguous(),
                                             bias[:32].contiguous(), 1, tq.ACTS["relu"],
                                             torch.float32)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["extract_patches", "extract_patches_at", "int8_conv",
                                "int8_dwconv"])
def test_cuda_custom_ops_opcheck(op):
    _needs_gpu()
    fn, args = _opcheck_cases()[op]
    torch.library.opcheck(fn, args)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_cuda_export_reload_launches(mode, tmp_path):
    from adafocus_torch import serving
    from adafocus_torch.benchmark import inference_fn, make_data
    from adafocus_torch.models import quant_inference as tqi
    from adafocus_torch.ops import quant as tq

    _needs_gpu()
    cfg = tgfv.flagship(tiny=True)
    model = tgfv.GFV(cfg, device="cuda")
    data = make_data(cfg, 2, device="cuda", seed=36)
    frames, small = data["frames"], data["frames_small"]
    scales = None
    if mode == "int8":
        scales = tqi.calibrate_gfv(model, [tqi.calibration_batch(model, frames, small)])
    path = str(tmp_path / "model.pt2")
    serving.save_exported(serving.export_inference(model, 2, mode, scales), path)
    fn = serving.load_exported(path)
    state = list(fn.state_dict().values()) + [v for v in vars(fn).values()
                                              if isinstance(v, torch.Tensor)]
    assert all(t.is_cuda for t in state)
    counts = (tpatch.extract_patches, tq.int8_conv, tq.int8_dwconv,
              tfb.fused_inverted_residual, tfb.fused_bottleneck)
    for f in counts:
        f.launches = 0
    got = fn(frames, small)
    torch.cuda.synchronize()
    assert [f.launches for f in counts] == ([1, 86, 17, 0, 0] if mode == "int8"
                                            else [1, 0, 0, 0, 0])
    if mode == "int8":
        want = tqi.inference_q8(model, scales, frames, small, qw=tqi.prepare_q8(model, scales))
    else:
        want = inference_fn(model)(frames, small)
    assert _rel_err(got, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet101", "resnet152",
                                  "wide_resnet101"])
def test_cuda_resnet_variant_bf16_matches_float32(name):
    """Each ResNet variant over 4 patches of 96^2 in bf16 against float32
    (TF32 off) on the same weights and random BatchNorm statistics, within
    chip_smoke.py phase 4's 3e-2 (max|d| / max|float32| of the pooled
    features)."""
    import copy

    _needs_gpu()
    gen = torch.Generator().manual_seed(15)
    torch.manual_seed(15)
    m32 = getattr(tres, name)(num_classes=10)
    for m in m32.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -0.5, 0.5),
                              (m.running_mean, -0.5, 0.5), (m.running_var, 0.5, 1.5)):
                t.data.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)
    m32 = m32.cuda().eval()
    m16 = copy.deepcopy(m32).bfloat16()
    x = torch.randn((4, 3, 96, 96), generator=gen).cuda()
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = m32.features(x)[1]
            got = m16.features(x.bfloat16())[1]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    assert got.shape == (4, m32.feature_dim)
    assert _rel_err(got, want) <= 3e-2


@pytest.mark.cuda
def test_cuda_profiler_attributes_the_patch_kernel(tmp_path):
    """``utils.profiling.trace`` around one tiny forward on the card:
    ``top_ops`` shows the patch kernel once, and its rows sum to the
    device events that ``load_trace`` reads."""
    from adafocus_torch.benchmark import inference_fn, make_data
    from adafocus_torch.utils import profiling

    _needs_gpu()
    cfg = tgfv.flagship(tiny=True)
    model = tgfv.GFV(cfg, device="cuda")
    data = make_data(cfg, 2, device="cuda", seed=37)
    fn = inference_fn(model)
    fn(data["frames"], data["frames_small"])   # warm-up
    with profiling.trace(str(tmp_path)):
        fn(data["frames"], data["frames_small"])
    rows = profiling.top_ops(str(tmp_path), n=10**6)
    patch = [r for r in rows if "patch_kernel" in r[0]]
    assert sum(r[2] for r in patch) == 1 and patch[0][1] > 0
    events = profiling.device_events(profiling.load_trace(str(tmp_path)))
    assert sum(r[2] for r in rows) == len(events)
    assert sum(r[1] for r in rows) == pytest.approx(sum(e["dur"] for e in events) / 1e3)
