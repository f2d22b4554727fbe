"""int8 PTQ serving forward (counterpart of
adafocus_tpu/models/quant_inference.py).

The backbones are re-run from the port's modules (models/mobilenet.py,
models/resnet.py) with every conv-bn unit as an int8 product
(ops/quant.py): BatchNorm folded (``ops.fused_blocks.fold_bn``), weights
per-output-channel int8, activations per-tensor int8 with calibrated
scales. The stems stay in the compute dtype, as do the max-pool, pooling,
the residual adds, and (mode ``int8``) the policy and the classifier. With
head scales (``calibrate_gfv(..., heads=True)``, mode ``int8+heads``) the
policy's encoder, GRU, actor and critic and the classifier's GRU and FC
run int8 too, with per-input-channel activation scales folded into the
float32 weights before they are quantized (``_HeadRunner``).

Calibration and execution share one traversal (``_run_backbone``): with
``scales=None`` it runs the float math of the compute dtype and records
each unit input's abs-max; with a scales dict it runs int8.
``calibrate_*`` take the maximum over batches on the host, one copy from
the device a batch.

Each int8 unit requantizes in its kernel's epilogue, as XLA fuses it for
the JAX package (``ops.quant.int8_unit``): a producer writes its output's
int8 codes at its consumer's scale, and writes the compute-dtype values
only where something still reads them (the residual carry, the ResNet block
output its ``down`` unit and the next block's residual read, the head
conv's map); the residual add (and ResNet's ReLU after it) happens in the
epilogue of the block's last unit. A unit that reads a tensor no int8
kernel produced (the stems' outputs, ResNet's max-pool output, the block
inputs of the four ``down`` units) quantizes it on load. Under TSM the
int8 codes are shifted: the shift moves values and fills zeros, and a zero
quantizes to code 0, so shift and quantize commute exactly. The codes are
those of JAX's unfused ``quantize_act`` bit for bit; no ``quantize_act``
runs inside an int8 backbone.

Frames may arrive in the int8 transport format (``ops.quant.FRAME_SCALE``):
the patch kernel crops them at one byte a value, and they are dequantized
into the compute dtype before each stem.

Numbers. The port's serving ``GFV`` holds bf16 parameters, so ``fold_bn``
folds weights already rounded to bf16 where the JAX package folds from
float32; its training model (float32 parameters, bf16 compute, as the CLI
builds it) folds from float32. Parity with the JAX package is therefore
held on float32 models on the CPU (tests/test_torch_port_quant.py); on the
card the int8 forward is held against the port's own bf16 and float32
forwards (chip_smoke.py phase 12).

Each ``inference_q8*`` runs on ``device`` (the GPU unless ``device="cpu"``),
where the model must already be, under ``torch.inference_mode()``, and
takes the prepared-weight cache of ``prepare_q8``. PyTorch has no trace, so
``prepare_q8`` fills that cache eagerly; it is valid for one model's
weights and one set of scales.
"""

from __future__ import annotations

import types
from typing import Callable, Dict, Iterable, List, Mapping, NamedTuple, Optional, Tuple

import torch
from torch.nn import functional as F

from adafocus_torch.models.fused_inference import _conv_bn
from adafocus_torch.models.gfv import (
    GFV, Device, _on_model_device, _set_mode, extract_for_frames, fuse_and_classify,
    glance_policy_actions,
)
from adafocus_torch.models.gfv_plus import gather_frames, scatter_frames, select_topk
from adafocus_torch.models.gfv_sthsth import (
    _check_frames, actions_per_frame, glance_division_rollout, sum_consensus,
)
from adafocus_torch.models.gru import _gates
from adafocus_torch.models.policy import sample_rollout
from adafocus_torch.models.tsm import temporal_shift
from adafocus_torch.ops.fused_blocks import fold_bn
from adafocus_torch.ops.quant import (
    FRAME_SCALE, QConv, act_scale_from_absmax, int8_conv, int8_dense, int8_unit, prepare_qconv,
    quantize_act, quantize_weight,
)
from adafocus_torch.utils.profiling import span

Scales = Dict[str, Dict[str, torch.Tensor]]
_ACT_NAMES = {None: None, F.relu: "relu", F.relu6: "relu6"}


# Called with (unit name, int8 codes) for each int8 backbone unit's input
# codes, in the order the units run, when set: a test's view of the codes
# that the fused path produces (an input quantized on load is quantized
# once more for it, as the kernel quantizes it).
code_tap: Optional[Callable[[str, torch.Tensor], None]] = None


class Act(NamedTuple):
    """A unit's output as the next units read it: ``y`` in the compute
    dtype, ``q`` its int8 codes at the scale of the unit that reads them;
    either may be absent (calibration and the stems carry ``y`` only)."""

    y: Optional[torch.Tensor] = None
    q: Optional[torch.Tensor] = None


class _UnitRunner:
    """Runs conv-bn units (``ConvBNAct``) in the compute dtype, recording
    each input's abs-max (``scales=None``, calibration), or int8 (a scales
    dict; a unit without a scale, the stems, stays in the compute dtype).

    ``qw`` (optional dict) caches each unit's prepared ``QConv``: folded,
    quantized, packed for the kernel, with its rescale. A miss computes and
    records it; a hit skips the fold and the quantization."""

    def __init__(self, scales: Optional[Mapping[str, torch.Tensor]], dtype: torch.dtype,
                 qw: Optional[dict] = None):
        self.scales = scales
        self.dtype = dtype
        self.qw = qw
        self.absmax: Dict[str, torch.Tensor] = {}

    def __call__(self, name: str, x: Act, unit, to: Optional[str] = None, keep: bool = False,
                 residual: Optional[Act] = None, res_relu: bool = False) -> Act:
        """One unit on x, (N, H, W, C) -> (N, H', W', C'). ``to``: the unit
        that reads the output's int8 codes (written at its scale); ``keep``:
        the compute-dtype output too (always without ``to``); ``residual``:
        added to the output in float32, rounded once to the compute dtype,
        ReLU after the add with ``res_relu``."""
        if self.scales is None or name not in self.scales:
            if self.scales is None:
                self.absmax[name] = x.y.float().abs().amax()
            y = _conv_bn(x.y, unit, self.dtype)
            if residual is not None:
                y = y + residual.y
                if res_relu:
                    y = y.relu_()
            return Act(y)
        groups = unit.conv.groups
        qc = self._qconv(name, unit)
        if code_tap is not None:
            code_tap(name, x.q if x.q is not None else quantize_act(x.y, qc.x_scale))
        out_scale = None if to is None else self.scales.get(to)
        y, q = int8_unit(x.q if x.q is not None else x.y, qc, unit.conv.stride[0], groups,
                         _ACT_NAMES[unit.act], self.dtype, out_scale=out_scale,
                         keep=keep or out_scale is None,
                         residual=None if residual is None else residual.y, res_relu=res_relu)
        return Act(y, q)

    def _qconv(self, name: str, unit) -> QConv:
        """The unit's prepared ``QConv``, from ``qw`` where it holds it."""
        qc = None if self.qw is None else self.qw.get(name)
        if qc is None:
            kernel, bias = fold_bn(unit)
            kq, ws = quantize_weight(kernel)
            qc = prepare_qconv(QConv(kq, ws, bias, self.scales[name]),
                               depthwise=unit.conv.groups > 1)
            if self.qw is not None:
                self.qw[name] = qc
        return qc

    def shift(self, x: Act, n_frames: int) -> Act:
        """``temporal_shift`` of what the next unit reads: the int8 codes
        where there are, else the compute-dtype values."""
        if x.q is not None:
            return Act(q=temporal_shift(x.q, n_frames))
        return Act(temporal_shift(x.y, n_frames))


class _UnfusedRunner(_UnitRunner):
    """JAX's unfused composition of an int8 backbone, the order of
    operations that the fused epilogues must reproduce (for checks): every
    int8 unit's input quantized by ``quantize_act`` (each unit's codes
    recorded in ``codes``), its output in the compute dtype, the residual
    added apart; the stems as ``_UnitRunner`` runs them."""

    def __init__(self, scales: Mapping[str, torch.Tensor], dtype: torch.dtype,
                 qw: Optional[dict] = None):
        super().__init__(scales, dtype, qw)
        self.codes: List[Tuple[str, torch.Tensor]] = []

    def __call__(self, name: str, x: Act, unit, to: Optional[str] = None, keep: bool = False,
                 residual: Optional[Act] = None, res_relu: bool = False) -> Act:
        if name not in self.scales:
            return super().__call__(name, x, unit, residual=residual, res_relu=res_relu)
        qc = self._qconv(name, unit)
        codes = quantize_act(x.y, qc.x_scale)
        self.codes.append((name, codes))
        y = int8_conv(codes, qc, unit.conv.stride[0], unit.conv.groups, _ACT_NAMES[unit.act],
                      self.dtype)
        if residual is not None:
            y = y + residual.y
            if res_relu:
                y = y.relu_()
        return Act(y)


def _mbv2_backbone(glancer, x: torch.Tensor, runner: _UnitRunner, n_frames: int = 0):
    h = runner("stem", Act(x), glancer.stem)
    names = glancer.block_names
    blocks = [getattr(glancer, name) for name in names]
    for i, (name, block) in enumerate(zip(names, blocks)):
        nxt = blocks[i + 1] if i + 1 < len(blocks) else None
        to = ("head_conv" if nxt is None
              else f"{names[i + 1]}/{'dw' if nxt.expand is None else 'expand'}")
        b = h
        if block.use_res and n_frames > 0:
            b = runner.shift(b, n_frames)
        if block.expand is not None:
            b = runner(f"{name}/expand", b, block.expand, to=f"{name}/dw")
        b = runner(f"{name}/dw", b, block.dw, to=f"{name}/project")
        # h + b, the next block's residual kept in the compute dtype
        h = runner(f"{name}/project", b, block.project, to=to,
                   keep=nxt is not None and nxt.use_res,
                   residual=h if block.use_res else None)
    fmap = runner("head_conv", h, glancer.head_conv).y
    return fmap, fmap.mean(dim=(1, 2))


def _resnet_backbone(focuser, x: torch.Tensor, runner: _UnitRunner, n_frames: int = 0):
    h = runner("stem", Act(x), focuser.stem).y
    h = F.max_pool2d(h.permute(0, 3, 1, 2), kernel_size=3, stride=2, padding=1)
    h = Act(h.permute(0, 2, 3, 1).contiguous())
    names = focuser.block_names
    for i, name in enumerate(names):
        block = getattr(focuser, name)
        to = f"{names[i + 1]}/conv1" if i + 1 < len(names) else None
        b = runner.shift(h, n_frames) if n_frames > 0 else h
        b = runner(f"{name}/conv1", b, block.conv1, to=f"{name}/conv2")
        b = runner(f"{name}/conv2", b, block.conv2, to=f"{name}/conv3")
        # relu(b + res) rounded once to the compute dtype, as JAX computes it,
        # in the epilogue of the block's last unit
        if block.down is None:
            h = runner(f"{name}/conv3", b, block.conv3, to=to, keep=True, residual=h,
                       res_relu=True)
        else:
            b = runner(f"{name}/conv3", b, block.conv3)
            h = runner(f"{name}/down", Act(h.y), block.down, to=to, keep=True, residual=b,
                       res_relu=True)
    return h.y, h.y.mean(dim=(1, 2))


def _run_backbone(kind: str, module, x: torch.Tensor, scales, n_frames: int = 0,
                  dtype: Optional[torch.dtype] = None, qw: Optional[dict] = None):
    """kind 'mbv2' | 'resnet'; x (N, H, W, 3). Returns (map, pooled), plus
    the abs-max dict when ``scales`` is None."""
    runner = _UnitRunner(scales, dtype or x.dtype, qw)
    fn = _mbv2_backbone if kind == "mbv2" else _resnet_backbone
    fmap, pooled = fn(module, x, runner, n_frames)
    if scales is None:
        return fmap, pooled, runner.absmax
    return fmap, pooled


def mobilenet_features_q8(glancer, x: torch.Tensor, scales, n_frames: int = 0):
    """``MobileNetV2.features`` with int8 units (the stem in x's dtype): x
    (N, H, W, 3) -> (map (N, h, w, 1280), pooled (N, 1280))."""
    return _run_backbone("mbv2", glancer, x, scales, n_frames)


def resnet_features_q8(focuser, x: torch.Tensor, scales, n_frames: int = 0):
    """``ResNet.features`` with int8 units (the stem in x's dtype)."""
    return _run_backbone("resnet", focuser, x, scales, n_frames)


def _module_device(module) -> torch.device:
    return next(module.parameters()).device


def calibrate_backbone(kind: str, module, batches: Iterable[torch.Tensor],
                       n_frames: int = 0, dtype: torch.dtype = torch.bfloat16
                       ) -> Dict[str, torch.Tensor]:
    """The forward in ``dtype`` over calibration batches ((N, H, W, 3) each)
    -> per-unit activation scales {unit name: () float32} on the module's
    device (abs-max calibration). The stem runs in ``dtype``: its abs-max is
    recorded and dropped."""
    dev = _module_device(module)
    running: Dict[str, float] = {}
    with torch.inference_mode():
        for xb in batches:
            absmax = _run_backbone(kind, module, torch.as_tensor(xb).to(dev, dtype), None,
                                   n_frames, dtype)[2]
            values = torch.stack(list(absmax.values())).cpu().tolist()
            for k, v in zip(absmax, values):
                running[k] = max(running.get(k, 0.0), v)
    return {k: act_scale_from_absmax(v).to(dev) for k, v in running.items() if k != "stem"}


@torch.inference_mode()
def calibration_batch(model: GFV, frames: torch.Tensor, frames_small: torch.Tensor) -> dict:
    """One ``calibrate_gfv`` batch from an eval batch: the family's
    deployment phases in the compute dtype (glance, the greedy policy, for
    AdaFocus+ the top-K frames first), then the patches they pick.
    frames (B, Tf, S, S, 3), frames_small (B, T, g, g, 3) on the model's
    device. Returns {'frames_small', 'patches'} in float32."""
    cfg = model.cfg
    with model.autocast():
        if cfg.sthsth:
            roll = glance_division_rollout(model, frames_small)[2]
            actions = actions_per_frame(roll["actions"], frames.shape[1])
        elif cfg.frame_budget > 0:
            fmap, pooled = model.glance(frames_small)
            if cfg.plus_rl:
                idx = model.select_rollout(pooled.to(cfg.dtype), "top")["idx"]
            else:
                idx, _ = select_topk(model.frame_scores(pooled), cfg.frame_budget, "top")
            actions = model.policy_rollout(gather_frames(fmap, idx))["actions"]
            frames = gather_frames(frames, idx)
        else:
            actions = glance_policy_actions(model, frames_small)[2]["actions"]
        patches = extract_for_frames(frames, actions, cfg.image_size, cfg.patch_size)
    return {"frames_small": frames_small.float(), "patches": patches.float()}


def calibrate_gfv(model: GFV, batches, heads: bool = False) -> Scales:
    """Calibrate the backbones (and with ``heads`` the heads) from
    deployment-shaped batches: dicts of 'frames_small' (B, T, g, g, 3) and
    'patches' (N, P, P, 3), the patches the greedy policy picks (the
    evaluate CLI's ``calibrate_from_loader`` makes them). Returns
    {'glancer': scales, 'focuser': scales} and, with ``heads``, 'heads',
    which makes the ``inference_q8*`` forwards quantize the policy and the
    classifier too."""
    cfg = model.cfg
    batches = list(batches)
    g_batches = [torch.as_tensor(b["frames_small"]).flatten(0, 1) for b in batches]
    scales = {
        "glancer": calibrate_backbone("mbv2", model.glancer, g_batches,
                                      cfg.num_frames if cfg.tsm else 0, cfg.dtype),
        "focuser": calibrate_backbone("resnet", model.focuser,
                                      [b["patches"] for b in batches],
                                      cfg.t_focuser if cfg.tsm else 0, cfg.dtype),
    }
    if heads:
        scales["heads"] = calibrate_heads(model, batches)
    return scales


def q8_glance(model: GFV, scales: Scales, frames_small: torch.Tensor, qw=None):
    """(B, T, g, g, 3) -> map (B, T, gh, gw, 1280), pooled (B, T, 1280)."""
    cfg = model.cfg
    b, t = frames_small.shape[:2]
    fmap, pooled = _run_backbone(
        "mbv2", model.glancer, frames_small.flatten(0, 1).to(cfg.dtype), scales["glancer"],
        cfg.num_frames if cfg.tsm else 0, qw=None if qw is None else qw["glancer"])
    return fmap.reshape((b, t) + fmap.shape[1:]), pooled.reshape(b, t, -1)


def q8_focus(model: GFV, scales: Scales, patches: torch.Tensor, qw=None) -> torch.Tensor:
    """(N, P, P, 3) -> pooled focuser features (N, 2048)."""
    cfg = model.cfg
    return _run_backbone(
        "resnet", model.focuser, patches.to(cfg.dtype), scales["focuser"],
        cfg.t_focuser if cfg.tsm else 0, qw=None if qw is None else qw["focuser"])[1]


# ---------------------------------------------------------------------------
# Quantized heads.
# ---------------------------------------------------------------------------


class _HeadRunner:
    """Dense and GRU counterpart of ``_UnitRunner``: with ``scales=None``
    the float32 math, recording each quantization point's abs-max per input
    channel; with a scales dict int8 products (per-output-channel weights,
    per-input-channel activations, float32 epilogues).

    A per-input-channel scale folds exactly into a matmul: y_j = sum_k
    (x_k / s_k) * (s_k * W_jk), so x is quantized per channel and the scale
    vector multiplies the float32 weight (out, in) along ``in`` before its
    per-output-channel quantization."""

    def __init__(self, scales: Optional[Mapping[str, torch.Tensor]], qw: Optional[dict] = None):
        self.scales = scales
        self.qw = qw
        self.absmax: Dict[str, torch.Tensor] = {}

    def _qweight(self, name: str, weight: torch.Tensor, s: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> QConv:
        if self.qw is not None and name in self.qw:
            return self.qw[name]
        kq, ws = quantize_weight(weight.float() * s)
        b = torch.zeros_like(ws) if bias is None else bias.float()
        qc = prepare_qconv(QConv(kq, ws, b, torch.ones((), device=ws.device)))
        if self.qw is not None:
            self.qw[name] = qc
        return qc

    def _see(self, name: str, x: torch.Tensor) -> None:
        a = x.float().abs().amax(dim=tuple(range(x.dim() - 1)))
        prev = self.absmax.get(name)
        self.absmax[name] = a if prev is None else torch.maximum(prev, a)

    def dense(self, name: str, x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], act=None) -> torch.Tensor:
        """(..., in) x weight (out, in)^T (+ bias) -> (..., out) float32;
        the quantization point is the input, one scale an input channel."""
        if self.scales is None or name not in self.scales:
            if self.scales is None:
                self._see(name, x)
            y = x.float() @ weight.float().t()
            if bias is not None:
                y = y + bias.float()
        else:
            s = self.scales[name].reshape(-1)
            qc = self._qweight(name, weight, s, bias)
            q = quantize_act(x, s)
            y = int8_dense(q.reshape(-1, q.shape[-1]), qc).reshape(x.shape[:-1] + (-1,))
        return act(y) if act is not None else y

    def gru(self, name: str, cell, h0: torch.Tensor, xs_tb: torch.Tensor) -> torch.Tensor:
        """The torch-parity GRU over (T, B, in) -> hiddens (T, B, H): the
        input projection as one product over all steps, the recurrence step
        by step, its hidden re-quantized each step against ``{name}/h``."""
        gi = self.dense(f"{name}/x", xs_tb, cell.weight_ih, cell.bias_ih)
        hname = f"{name}/h"
        h, hs = h0, []
        if self.scales is None or hname not in self.scales:
            wh, bh = cell.weight_hh.float(), cell.bias_hh.float()
            amax = torch.zeros(wh.shape[1], device=h0.device)
            for gi_t in gi.unbind(0):
                h = _gates(gi_t, h, h @ wh.t() + bh)
                amax = torch.maximum(amax, h.abs().amax(dim=0))
                hs.append(h)
            if self.scales is None:
                prev = self.absmax.get(hname)
                self.absmax[hname] = amax if prev is None else torch.maximum(prev, amax)
            return torch.stack(hs)
        s_h = self.scales[hname].reshape(-1)
        qc = self._qweight(f"{name}/wh", cell.weight_hh, s_h, cell.bias_hh)
        for gi_t in gi.unbind(0):
            h = _gates(gi_t, h, int8_dense(quantize_act(h, s_h), qc))
            hs.append(h)
        return torch.stack(hs)


def _q8_encode(runner: _HeadRunner, policy, fmap: torch.Tensor) -> torch.Tensor:
    """The quantized ``StateEncoder``: the 1x1 conv as a channel matmul
    (BatchNorm folded where there is one), ReLU, the (h, w, c) flatten, fc,
    ReLU; or the MLP encoder's mean over the map, fc, ReLU. fmap (N, h, w, C)
    -> (N, 1024)."""
    enc = policy.encoder
    if enc.proj is not None:
        if enc.bn is not None:
            w, bias = fold_bn(types.SimpleNamespace(conv=enc.proj, bn=enc.bn))
        else:
            w, bias = enc.proj.weight, enc.proj.bias
        x = runner.dense("policy/proj", fmap, w[:, :, 0, 0], bias, act=F.relu)
        x = x.reshape(x.shape[0], -1)
    else:
        x = fmap.float().mean(dim=(1, 2))
    return runner.dense("policy/fc", x, enc.fc.weight, enc.fc.bias, act=F.relu)


def q8_policy_states(model: GFV, head_scales, fmaps_tb: torch.Tensor, qw=None):
    """The quantized ``ActorCritic.rollout_states``. fmaps_tb (T, B, gh, gw,
    C), time-major glance maps (or division-stacked ones). Returns (hiddens
    (T, B, H), actor out (T, B, K | 2), value (T, B), the runner)."""
    runner = _HeadRunner(head_scales, qw)
    p = model.policy
    t, b = fmaps_tb.shape[:2]
    states = _q8_encode(runner, p, fmaps_tb.reshape((t * b,) + fmaps_tb.shape[2:]))
    h0 = torch.zeros((b, p.gru.hidden_size), device=fmaps_tb.device)
    hs = runner.gru("policy/gru", p.gru, h0, states.reshape(t, b, -1))
    actor = runner.dense("policy/actor", hs, p.actor.weight, p.actor.bias)
    if model.cfg.continuous_policy:
        actor = torch.sigmoid(actor)
    value = runner.dense("policy/critic", hs, p.critic.weight, p.critic.bias)[..., 0]
    return hs, actor, value, runner


def q8_policy_rollout(model: GFV, head_scales, fmap: torch.Tensor, mode: str = "greedy",
                      div: bool = False, qw=None, generator: Optional[torch.Generator] = None):
    """The quantized ``GFV.policy_rollout`` (``policy_rollout_div`` with
    ``div``): fmap (B, T, gh, gw, C) -> (the rollout dict, the runner)."""
    cfg = model.cfg
    if div:
        fmap = model.division_maps(fmap)
    _, actor_out, value, runner = q8_policy_states(model, head_scales, fmap.transpose(0, 1), qw)
    actions, idx, logprob = sample_rollout(actor_out, mode, cfg.action_dim, generator,
                                           cfg.continuous_policy, cfg.action_std)
    return {
        "actions": actions.transpose(0, 1).float(),
        "action_idx": idx.transpose(0, 1),
        "logprob": logprob.transpose(0, 1).float(),
        "value": value.transpose(0, 1).float(),
    }, runner


def q8_classify_gru(model: GFV, head_scales, pooled: torch.Tensor, local: torch.Tensor,
                    qw=None):
    """The quantized GRU classifier: [pooled | local] (B, T, 3328) -> int8
    GRU -> int8 FC, per-step logits (B, T, classes) float32; and the
    runner."""
    runner = _HeadRunner(head_scales, qw)
    p = model.classifier
    fused = torch.cat([pooled.float(), local.float()], dim=-1)
    h0 = torch.zeros((fused.shape[0], p.gru.hidden_size), device=fused.device)
    hs = runner.gru("cls/gru", p.gru, h0, fused.transpose(0, 1))
    logits = runner.dense("cls/fc", hs, p.fc.weight, p.fc.bias)
    return logits.transpose(0, 1), runner


def q8_frame_logits(model: GFV, head_scales, feats: torch.Tensor, which: str, qw=None):
    """The quantized per-frame FC heads: the sth-sth local head
    (``classifier.fc``, dropout inactive at inference, ``which='local'``)
    or the glancer's classifier. feats (..., D) -> ((..., classes), the
    runner)."""
    runner = _HeadRunner(head_scales, qw)
    if which == "local":
        fc, name = model.classifier.fc, "cls/fc"
    else:
        fc, name = model.glancer.classifier, "glancer/fc"
    return runner.dense(name, feats, fc.weight, fc.bias), runner


def _dequant_frames(frames: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 transport frames -> the compute dtype, ``FRAME_SCALE`` rounded
    to that dtype first, as JAX multiplies; float frames pass through."""
    if frames.dtype == torch.int8:
        return frames.to(dtype) * torch.tensor(FRAME_SCALE, dtype=dtype, device=frames.device)
    return frames


def _div_stack(fmap: torch.Tensor, d: int) -> torch.Tensor:
    """(B, Tg, gh, gw, C) -> time-major division-stacked (D, B, gh, gw,
    C * Tg / D), the sth-sth policy's input in ``GFV.division_maps``'
    order."""
    b, tg, gh, gw, c = fmap.shape
    stacked = fmap.reshape(b, d, tg // d, gh, gw, c).movedim(2, 4)
    return stacked.reshape(b, d, gh, gw, (tg // d) * c).transpose(0, 1)


def calibrate_heads(model: GFV, batches) -> Dict[str, torch.Tensor]:
    """The float32 pass over the head path (glance maps -> policy, focus
    features -> classifier) recording each quantization point's abs-max per
    input channel. batches: the ``calibrate_gfv`` dicts. Returns {point
    name: (C,) float32 scale} on the model's device."""
    cfg = model.cfg
    dev = model.device
    tsm = cfg.tsm
    running: Dict[str, torch.Tensor] = {}
    with torch.inference_mode():
        for batch in batches:
            small = torch.as_tensor(batch["frames_small"]).to(dev)
            patches = torch.as_tensor(batch["patches"]).to(dev)
            b, t = small.shape[:2]
            fmap, pooled, _ = _run_backbone("mbv2", model.glancer,
                                            small.flatten(0, 1).to(cfg.dtype), None,
                                            cfg.num_frames if tsm else 0)
            fmap = fmap.reshape((b, t) + fmap.shape[1:]).float()
            pooled = pooled.reshape(b, t, -1)
            maps = _div_stack(fmap, cfg.video_div) if cfg.sthsth else fmap.transpose(0, 1)
            absmax = dict(q8_policy_states(model, None, maps)[3].absmax)
            _, local, _ = _run_backbone("resnet", model.focuser, patches.to(cfg.dtype), None,
                                        cfg.t_focuser if tsm else 0)
            tf = local.shape[0] // b
            local = local.reshape(b, tf, -1)
            if cfg.classifier == "gru":
                absmax.update(q8_classify_gru(model, None, pooled[:, :tf], local)[1].absmax)
            elif cfg.sthsth:
                absmax.update(q8_frame_logits(model, None, local, "local")[1].absmax)
                absmax.update(q8_frame_logits(model, None, pooled, "glancer")[1].absmax)
            host = torch.cat([v.reshape(-1) for v in absmax.values()]).cpu()
            for k, a in zip(absmax, host.split([v.numel() for v in absmax.values()])):
                prev = running.get(k)
                running[k] = a if prev is None else torch.maximum(prev, a)
    return {k: act_scale_from_absmax(v).to(dev) for k, v in running.items()}


# ---------------------------------------------------------------------------
# The families' int8 serving forwards.
# ---------------------------------------------------------------------------


@torch.inference_mode()
def inference_q8(model: GFV, scales: Scales, frames: torch.Tensor, frames_small: torch.Tensor,
                 device: Device = None, qw: Optional[dict] = None) -> torch.Tensor:
    """The int8 serving forward of the ActivityNet family (``inference``'s
    counterpart): int8 glance and focus backbones; with ``scales['heads']``
    the policy and the GRU classifier int8 too. frames (B, T, S, S, 3) and
    frames_small (B, T, g, g, 3), float or int8 transport. ``qw``: the
    cache of ``prepare_q8``. Returns per-step logits (B, T, classes) (the
    linear head: log-probabilities (B, classes)). The call is the span
    ``serve``, its phases ``glance``, ``policy``, ``focus`` and
    ``classify``, as in ``models.gfv.inference``."""
    if model.cfg.sthsth:
        raise ValueError("a consensus-head (sth-sth) model serves through inference_q8_sthsth")
    with span("serve"):
        frames, frames_small = _on_model_device(model, device, frames, frames_small)
        cfg = model.cfg
        heads = scales.get("heads")
        hqw = None if qw is None else qw["heads"]
        b, t = frames_small.shape[:2]
        with span("glance"):
            fmap, pooled = q8_glance(model, scales, _dequant_frames(frames_small, cfg.dtype), qw)
        with span("policy"):
            if heads is not None:
                roll, _ = q8_policy_rollout(model, heads, fmap.float(), qw=hqw)
            else:
                with model.autocast():
                    roll = model.policy_rollout(fmap.to(cfg.dtype))
        patches = extract_for_frames(frames, roll["actions"], cfg.image_size, cfg.patch_size)
        with span("focus"):
            local = q8_focus(model, scales, _dequant_frames(patches, cfg.dtype),
                             qw).reshape(b, t, -1)
        with span("classify"):
            if heads is not None and cfg.classifier == "gru":
                return q8_classify_gru(model, heads, pooled, local, hqw)[0]
            with model.autocast():
                return fuse_and_classify(model, pooled.to(cfg.dtype), local.to(cfg.dtype))


@torch.inference_mode()
def inference_q8_plus(model: GFV, scales: Scales, frames: torch.Tensor,
                      frames_small: torch.Tensor, device: Device = None,
                      qw: Optional[dict] = None) -> torch.Tensor:
    """The int8 serving forward of AdaFocus+ (``inference_plus``'s
    counterpart): int8 backbones, the selector (the top K, or with
    ``plus_rl`` its greedy rollout) in the compute dtype, the policy and the
    classifier int8 with head scales. The K selected frames are gathered
    (int8 ones too) before the patch kernel. Returns (B, T, classes)."""
    frames, frames_small = _on_model_device(model, device, frames, frames_small)
    cfg = model.cfg
    heads = scales.get("heads")
    hqw = None if qw is None else qw["heads"]
    b, t = frames_small.shape[:2]
    fmap, pooled = q8_glance(model, scales, _dequant_frames(frames_small, cfg.dtype), qw)
    fmap, pooled = fmap.to(cfg.dtype), pooled.to(cfg.dtype)
    with model.autocast():
        if cfg.plus_rl:
            idx = model.select_rollout(pooled, "top")["idx"]
        else:
            idx, _ = select_topk(model.frame_scores(pooled), cfg.frame_budget, "top")
    fmap_sel = gather_frames(fmap, idx)
    if heads is not None:
        roll, _ = q8_policy_rollout(model, heads, fmap_sel.float(), qw=hqw)
    else:
        with model.autocast():
            roll = model.policy_rollout(fmap_sel)
    patches = extract_for_frames(gather_frames(frames, idx), roll["actions"], cfg.image_size,
                                 cfg.patch_size)
    local_sel = q8_focus(model, scales, _dequant_frames(patches, cfg.dtype), qw)
    local = scatter_frames(local_sel.reshape(b, cfg.frame_budget, -1).to(cfg.dtype), idx, t)
    if heads is not None and cfg.classifier == "gru":
        return q8_classify_gru(model, heads, pooled, local, hqw)[0]
    with model.autocast():
        return fuse_and_classify(model, pooled, local)


@torch.inference_mode()
def inference_q8_sthsth(model: GFV, scales: Scales, frames: torch.Tensor,
                        frames_small: torch.Tensor, device: Device = None,
                        qw: Optional[dict] = None) -> torch.Tensor:
    """The int8 serving forward of the sth-sth family
    (``inference_sthsth``'s counterpart): int8 TSM backbones; the division
    policy, the glancer's and the local heads int8 with head scales.
    Returns the summed consensus logits (B, classes)."""
    frames, frames_small = _on_model_device(model, device, frames, frames_small)
    _check_frames(model, frames, frames_small)
    cfg = model.cfg
    heads = scales.get("heads")
    hqw = None if qw is None else qw["heads"]
    b, tf = frames.shape[:2]
    fmap, pooled = q8_glance(model, scales, _dequant_frames(frames_small, cfg.dtype), qw)
    if heads is not None:
        global_logits = q8_frame_logits(model, heads, pooled, "glancer", hqw)[0]
        roll, _ = q8_policy_rollout(model, heads, fmap.float(), div=True, qw=hqw)
    else:
        _set_mode(model.glancer, False)
        with model.autocast():
            global_logits = model.glancer.classify(pooled)
            roll = model.policy_rollout_div(fmap.to(cfg.dtype))
    patches = extract_for_frames(frames, actions_per_frame(roll["actions"], tf),
                                 cfg.image_size, cfg.patch_size)
    feats = q8_focus(model, scales, _dequant_frames(patches, cfg.dtype), qw).reshape(b, tf, -1)
    if heads is not None:
        local_logits = q8_frame_logits(model, heads, feats, "local", hqw)[0]
    else:
        with model.autocast():
            local_logits = model.classify_frame_logits(feats.to(cfg.dtype))
    return sum_consensus(global_logits, local_logits, cfg.with_glancer)


def family_q8(cfg):
    """The family's int8 forward: ``inference_q8_plus`` for a frame-budget
    model, ``inference_q8_sthsth`` for a consensus head, else
    ``inference_q8``."""
    if cfg.frame_budget > 0:
        return inference_q8_plus
    return inference_q8_sthsth if cfg.sthsth else inference_q8


def prepare_q8(model: GFV, scales: Scales) -> dict:
    """Fill the prepared-weight cache of the model's family eagerly: one
    forward of ``family_q8`` at batch 1 on zeros (the weights' preparation
    does not depend on the data) records every unit's and head's
    ``QConv``. Returns {'glancer': {...}, 'focuser': {...}, 'heads':
    {...}}; pass it as ``qw`` to the ``inference_q8*`` forwards. Valid for
    this model's weights and these scales only: rebuild it after either
    changes."""
    cfg = model.cfg
    qw = {"glancer": {}, "focuser": {}, "heads": {}}
    s, g = cfg.image_size, cfg.glance_size
    zeros = [torch.zeros(shape, dtype=cfg.dtype, device=model.device)
             for shape in ((1, cfg.t_focuser, s, s, 3), (1, cfg.num_frames, g, g, 3))]
    family_q8(cfg)(model, scales, *zeros, device=model.device, qw=qw)
    return qw
