"""The AdaFocus networks in plain float32 PyTorch, written from the papers'
descriptions: MobileNetV2 (Sandler et al., 2018), ResNet-50 (He et al.,
2016), the temporal shift of TSM (Lin et al., 2019), a GRU (Cho et al.,
2014), the recurrent patch policy and the two heads of AdaFocus (Wang et
al., ICCV 2021) and AdaFocus-TSM (its sth-sth variant).

Functional: every function takes ``W``, a dict of tensors keyed by
parameter name, the names the benchmark's weight file format uses (the
serving program's state-dict names; ``param_specs`` lists them). Images are
NCHW. Each product's inputs pass through ``q`` (the identity; a lower
precision for the benchmark's control, ``precision.py``). BatchNorm runs on
its running statistics, or on the batch's with ``stats`` given (train
mode; the running update ``0.9 * running + 0.1 * batch`` of the mean and of
the biased variance is written into ``stats``).

Nothing here imports the program under test.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.nn import functional as F

EPS = 1e-5
MOMENTUM = 0.9
# MobileNetV2's inverted residual stages: (expansion, channels, blocks, stride)
MBV2_STAGES = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
               (6, 160, 3, 2), (6, 320, 1, 1))
MBV2_STEM, MBV2_FEATURES = 32, 1280
RESNET50_STAGES = (3, 4, 6, 3)
FOCUS_FEATURES = 2048
POLICY_STATE = 1024          # the policy encoder's output width
SHIFT_DIV = 8                # TSM shifts 1/8 of the channels each way

Q = Callable[[torch.Tensor], torch.Tensor]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


# ---------------------------------------------------------------------------
# Parameter layout
# ---------------------------------------------------------------------------


def _conv_bn(specs: List[tuple], name: str, cout: int, cin: int, k: int) -> None:
    specs.append((f"{name}.conv.weight", (cout, cin, k, k), "lecun"))
    _bn(specs, f"{name}.bn", cout)


def _bn(specs: List[tuple], name: str, c: int) -> None:
    for leaf, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                       ("running_mean", "bn_mean"), ("running_var", "bn_var")):
        specs.append((f"{name}.{leaf}", (c,), kind))
    specs.append((f"{name}.num_batches_tracked", (), "count"))


def _linear(specs: List[tuple], name: str, cout: int, cin: int) -> None:
    specs.append((f"{name}.weight", (cout, cin), "lecun"))
    specs.append((f"{name}.bias", (cout,), "zero"))


def _gru(specs: List[tuple], name: str, cin: int, hidden: int) -> None:
    for leaf, shape in (("weight_ih", (3 * hidden, cin)), ("weight_hh", (3 * hidden, hidden)),
                        ("bias_ih", (3 * hidden,)), ("bias_hh", (3 * hidden,))):
        specs.append((f"{name}.{leaf}", shape, "gru"))


def mbv2_blocks():
    """(name, cin, hidden, cout, stride, expand, residual) of each inverted
    residual block."""
    out, cin = [], MBV2_STEM
    for i, (t, c, n, s) in enumerate(MBV2_STAGES):
        for j in range(n):
            stride = s if j == 0 else 1
            out.append((f"block_{i}_{j}", cin, cin * t, c, stride, t != 1,
                        stride == 1 and cin == c))
            cin = c
    return out


def resnet50_blocks():
    """(name, cin, inner, cout, stride, down) of each bottleneck block."""
    out, cin = [], 64
    for stage, n in enumerate(RESNET50_STAGES):
        inner = 64 * 2 ** stage
        for j in range(n):
            stride = 2 if stage > 0 and j == 0 else 1
            cout = inner * 4
            out.append((f"layer{stage + 1}_{j}", cin, inner, cout, stride,
                        j == 0 and (stride != 1 or cin != cout)))
            cin = cout
    return out


def glance_map_size(size: int) -> int:
    for _ in range(5):
        size = math.ceil(size / 2)
    return size


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of a model of configuration
    ``cfg`` (the configuration file's keys). Kinds: 'lecun' (normal of
    variance 1 / fan-in), 'zero', 'gru' (uniform in +-1/sqrt(hidden)),
    'bn_weight', 'bn_bias', 'bn_mean', 'bn_var', 'count'."""
    specs: List[tuple] = []
    classes = cfg["num_classes"]
    _conv_bn(specs, "glancer.stem", MBV2_STEM, 3, 3)
    for name, cin, hidden, cout, _, expand, _ in mbv2_blocks():
        if expand:
            _conv_bn(specs, f"glancer.{name}.expand", hidden, cin, 1)
        specs.append((f"glancer.{name}.dw.conv.weight", (hidden, 1, 3, 3), "lecun"))
        _bn(specs, f"glancer.{name}.dw.bn", hidden)
        _conv_bn(specs, f"glancer.{name}.project", cout, hidden, 1)
    _conv_bn(specs, "glancer.head_conv", MBV2_FEATURES, 320, 1)
    _linear(specs, "glancer.classifier", classes, MBV2_FEATURES)
    _conv_bn(specs, "focuser.stem", 64, 3, 7)
    for name, cin, inner, cout, _, down in resnet50_blocks():
        _conv_bn(specs, f"focuser.{name}.conv1", inner, cin, 1)
        _conv_bn(specs, f"focuser.{name}.conv2", inner, inner, 3)
        _conv_bn(specs, f"focuser.{name}.conv3", cout, inner, 1)
        if down:
            _conv_bn(specs, f"focuser.{name}.down", cout, cin, 1)
    _linear(specs, "focuser.fc", classes, FOCUS_FEATURES)
    g = glance_map_size(cfg["glance_size"])
    sthsth = cfg["classifier"] == "consensus"
    policy_in = MBV2_FEATURES * (cfg["num_frames"] // cfg["video_div"] if sthsth else 1)
    cc = cfg["policy_channels"]
    specs.append(("policy.encoder.proj.weight", (cc, policy_in, 1, 1), "lecun"))
    if cfg["policy_bn"]:
        _bn(specs, "policy.encoder.bn", cc)
    else:
        specs.append(("policy.encoder.proj.bias", (cc,), "zero"))
    _linear(specs, "policy.encoder.fc", POLICY_STATE, g * g * cc)
    _gru(specs, "policy.gru", POLICY_STATE, cfg["policy_hidden"])
    _linear(specs, "policy.actor", 2 if cfg["continuous_policy"] else cfg["action_dim"],
            cfg["policy_hidden"])
    _linear(specs, "policy.critic", 1, cfg["policy_hidden"])
    if sthsth:
        _linear(specs, "classifier.fc", classes, FOCUS_FEATURES)
    else:
        _gru(specs, "classifier.gru", MBV2_FEATURES + FOCUS_FEATURES, cfg["hidden_dim"])
        _linear(specs, "classifier.fc", classes, cfg["hidden_dim"])
    return specs


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def batch_norm(x: torch.Tensor, W: Dict[str, torch.Tensor], name: str,
               stats: Optional[dict] = None) -> torch.Tensor:
    """BatchNorm over NCHW ``x`` (eps 1e-5): on the running statistics, or,
    with ``stats``, on the batch's, the running update written there."""
    weight, bias = W[f"{name}.weight"], W[f"{name}.bias"]
    if stats is None:
        return F.batch_norm(x, W[f"{name}.running_mean"], W[f"{name}.running_var"], weight,
                            bias, False, 0.0, EPS)
    with torch.no_grad():
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        for leaf, batch in (("running_mean", mean), ("running_var", var)):
            key = f"{name}.{leaf}"
            stats[key] = W[key] * MOMENTUM + batch * (1.0 - MOMENTUM)
    return F.batch_norm(x, None, None, weight, bias, True, 0.0, EPS)


def conv_bn(x, W, name, stride=1, groups=1, act=None, stats=None, q: Q = _identity):
    w = W[f"{name}.conv.weight"]
    y = F.conv2d(q(x), q(w), stride=stride, padding=(w.shape[-1] - 1) // 2, groups=groups)
    y = batch_norm(y, W, f"{name}.bn", stats)
    return y if act is None else act(y)


def linear(x, W, name, q: Q = _identity):
    return F.linear(q(x), q(W[f"{name}.weight"]), W[f"{name}.bias"])


def relu6(x):
    return x.clamp(0.0, 6.0)


def temporal_shift(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """NCHW ``x`` of clips of ``n_frames`` consecutive frames: the first
    C/8 channels of frame t take frame t+1's, the next C/8 frame t-1's,
    zeros past the clip's ends; the rest stays."""
    n, c, h, w = x.shape
    fold = c // SHIFT_DIV
    v = x.reshape(n // n_frames, n_frames, c, h, w)
    zeros = torch.zeros_like(v[:, :1, :fold])
    ahead = torch.cat([v[:, 1:, :fold], zeros], dim=1)
    behind = torch.cat([zeros, v[:, :-1, fold:2 * fold]], dim=1)
    return torch.cat([ahead, behind, v[:, :, 2 * fold:]], dim=2).reshape(n, c, h, w)


def gru_scan(W, name, xs: torch.Tensor, q: Q = _identity) -> torch.Tensor:
    """GRU with gates [r, z, n] over (B, T, in) from a zero state -> the
    hiddens (B, T, H)."""
    wi, wh = W[f"{name}.weight_ih"], W[f"{name}.weight_hh"]
    bi, bh = W[f"{name}.bias_ih"], W[f"{name}.bias_hh"]
    hidden = wh.shape[1]
    gi = F.linear(q(xs), q(wi), bi)
    h = xs.new_zeros(xs.shape[0], hidden)
    out = []
    for t in range(xs.shape[1]):
        gh = F.linear(q(h), q(wh), bh)
        i_r, i_z, i_n = gi[:, t].chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1.0 - z) * n + z * h
        out.append(h)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# Backbones
# ---------------------------------------------------------------------------


def mobilenet_v2(W, x, n_frames: int = 0, q: Q = _identity):
    """Glancer over NCHW images -> (map (N, 1280, h, w), pooled (N, 1280));
    with ``n_frames`` the TSM variant (the residual branch's input shifted)."""
    x = conv_bn(x, W, "glancer.stem", 2, act=relu6, q=q)
    for name, _, hidden, _, stride, expand, residual in mbv2_blocks():
        p = f"glancer.{name}"
        h = temporal_shift(x, n_frames) if residual and n_frames else x
        if expand:
            h = conv_bn(h, W, f"{p}.expand", act=relu6, q=q)
        h = conv_bn(h, W, f"{p}.dw", stride, groups=hidden, act=relu6, q=q)
        h = conv_bn(h, W, f"{p}.project", q=q)
        x = x + h if residual else h
    fmap = conv_bn(x, W, "glancer.head_conv", act=relu6, q=q)
    return fmap, fmap.mean(dim=(2, 3))


def resnet50(W, x, n_frames: int = 0, stats: Optional[dict] = None, q: Q = _identity):
    """Focuser over NCHW patches -> pooled features (N, 2048); with
    ``n_frames`` the TSM variant (each block's branch input shifted)."""
    x = conv_bn(x, W, "focuser.stem", 2, act=F.relu, stats=stats, q=q)
    x = F.max_pool2d(x, 3, 2, 1)
    for name, _, _, _, stride, down in resnet50_blocks():
        p = f"focuser.{name}"
        h = temporal_shift(x, n_frames) if n_frames else x
        h = conv_bn(h, W, f"{p}.conv1", act=F.relu, stats=stats, q=q)
        h = conv_bn(h, W, f"{p}.conv2", stride, act=F.relu, stats=stats, q=q)
        h = conv_bn(h, W, f"{p}.conv3", stats=stats, q=q)
        if down:
            x = conv_bn(x, W, f"{p}.down", stride, stats=stats, q=q)
        x = F.relu(x + h)
    return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# Policy and patches
# ---------------------------------------------------------------------------


def policy_outputs(W, cfg: dict, maps: torch.Tensor, q: Q = _identity) -> torch.Tensor:
    """The recurrent policy over (B, T, C, h, w) state maps -> the actor's
    output a step: (B, T, K) anchor logits, or (B, T, 2) sigmoid means for
    the continuous policy. Encoder: 1x1 conv [+ BatchNorm], ReLU, the map
    flattened in (h, w, c) order, a linear layer to 1024, ReLU."""
    b, t = maps.shape[:2]
    x = maps.reshape((b * t,) + maps.shape[2:])
    x = F.conv2d(q(x), q(W["policy.encoder.proj.weight"]), W.get("policy.encoder.proj.bias"))
    if cfg["policy_bn"]:
        x = batch_norm(x, W, "policy.encoder.bn")
    x = F.relu(x).permute(0, 2, 3, 1).reshape(b, t, -1)
    states = F.relu(linear(x, W, "policy.encoder.fc", q))
    out = linear(gru_scan(W, "policy.gru", states, q), W, "policy.actor", q)
    return torch.sigmoid(out) if cfg["continuous_policy"] else out


def anchor_grid(k: int, device=None) -> torch.Tensor:
    """The K = k^2 anchors, (y, x) in [0, 1]^2, row-major: i / (k - 1) in
    float32 (the product by the float32 reciprocal), the last exactly 1."""
    side = math.isqrt(k)
    line = torch.arange(side, dtype=torch.float32, device=device) * \
        torch.tensor(1.0 / (side - 1), dtype=torch.float32, device=device)
    line[-1] = 1.0
    yy, xx = torch.meshgrid(line, line, indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)


def crop(frames: torch.Tensor, actions: torch.Tensor, patch: int) -> torch.Tensor:
    """(N, S, S, C) frames at (N, 2) actions (y, x) in [0, 1] -> (N, P, P, C):
    the window at floor(a * (S - P)), float32 arithmetic."""
    n, s = frames.shape[:2]
    span = s - patch
    off = torch.floor(actions.float() * span).long().clamp(0, span)
    ar = torch.arange(patch, device=frames.device)
    rows = (off[:, 0, None] + ar)[:, :, None]
    cols = (off[:, 1, None] + ar)[:, None, :]
    return frames[torch.arange(n, device=frames.device)[:, None, None], rows, cols]


def wide(x: torch.Tensor) -> torch.Tensor:
    """A floating ``x`` in float32, or float64 where it is float64 already."""
    if not x.is_floating_point():
        return x
    return x.to(torch.promote_types(x.dtype, torch.float32))


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)
