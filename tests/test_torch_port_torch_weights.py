"""The port's torchvision weight converter (adafocus_torch/utils/torch_weights.py)
and its ResNet variants (adafocus_torch/models/resnet.py) against the JAX
package, on the CPU.

- The converter: torchvision-layout state dicts from tests/torch_ref_models.py
  (ResNet-18, ResNet-50, MobileNetV2, random BatchNorm statistics) and the
  tonylins layout made from the MobileNetV2 dict go through JAX's
  ``convert_resnet`` / ``convert_mobilenet_v2`` and then the port's weight
  bridge (``gfv_state_dict_from_flax``), and separately through the port's
  converter: the same keys and bit-identical tensors.
- ``merge_into`` against JAX's on a head of the wrong class count, and the
  CLI's ``checkpoint.pt`` loaded by ``load_stage_components`` at stage 1.
- The variants against JAX's with weights carried by the bridge, atol 5e-4
  and rtol 1e-4 (PERF.md's backbone tolerance): resnet18 and resnet34 at
  32^2, N=2, and the generic ``ResNet`` with ``inner_mult=2`` at
  ``stage_sizes=(1, 1, 1, 1)``. resnet101, resnet152 and wide_resnet101 are
  checked key for key and shape for shape against ``jax.eval_shape`` of
  JAX's init (nothing compiled; the port's modules built on the meta
  device).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adafocus_torch.models import resnet as tres
from adafocus_torch.train import checkpoint as tckpt
from adafocus_torch.utils import torch_weights as tw
from adafocus_torch.weights import _convert_leaf, _flatten, gfv_state_dict_from_flax
from adafocus_tpu.models import resnet as jres
from adafocus_tpu.utils import torch_weights as jw
from tests.test_torch_parity import _randomize_bn_stats, _tv_to_tonylins
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.torch_port_common import scratch_path  # noqa: F401 (a fixture)
from tests.torch_ref_models import torch_mobilenet_v2, torch_resnet18, torch_resnet50

ATOL, RTOL = 5e-4, 1e-4


def _ref_state_dict(make, seed: int, num_classes: int = 1000) -> dict:
    torch.manual_seed(seed)
    model = make(num_classes=num_classes)
    _randomize_bn_stats(model)
    return model.state_dict()


def _assert_same_state(got: dict, want: dict) -> None:
    assert got.keys() == want.keys(), sorted(got.keys() ^ want.keys())
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _bridged(params, stats) -> dict:
    return gfv_state_dict_from_flax(jax.tree.map(np.asarray, params),
                                    jax.tree.map(np.asarray, stats))


CONVERT_CASES = {
    "resnet18": (torch_resnet18, lambda sd: jw.convert_resnet(sd, depth=18),
                 lambda sd: tw.convert_resnet(sd, depth=18)),
    "resnet50": (torch_resnet50, lambda sd: jw.convert_resnet(sd, depth=50),
                 lambda sd: tw.convert_resnet(sd, depth=50)),
    "mobilenet_v2": (torch_mobilenet_v2, jw.convert_mobilenet_v2, tw.convert_mobilenet_v2),
    "mobilenet_v2 tonylins": (torch_mobilenet_v2, jw.convert_mobilenet_v2,
                              tw.convert_mobilenet_v2),
}


@pytest.mark.parametrize("case", sorted(CONVERT_CASES))
def test_converter_matches_jax_and_bridge(case):
    make, jconvert, tconvert = CONVERT_CASES[case]
    sd = _ref_state_dict(make, seed=len(case))
    if "tonylins" in case:
        sd = _tv_to_tonylins(sd)
        assert tw._is_tonylins(sd)
    sd = {f"module.{k}": v for k, v in sd.items()}   # a DataParallel dict
    _assert_same_state(tconvert(sd), _bridged(*jconvert(sd)))


def test_converted_loads_into_port_modules():
    """Every key of the port's modules is converted, strictly."""
    from adafocus_torch.models.mobilenet import MobileNetV2

    tres.resnet18(num_classes=1000).load_state_dict(
        tw.convert_resnet(_ref_state_dict(torch_resnet18, 1), depth=18))
    MobileNetV2(num_classes=1000).load_state_dict(
        tw.convert_mobilenet_v2(_ref_state_dict(torch_mobilenet_v2, 2)))


def test_merge_into_matches_jax_on_a_wrong_head():
    """A 1000-class converted ResNet-18 into a 10-class focuser: the head
    keeps its fresh value in both packages, everything else is replaced."""
    jmodel = jres.resnet18(num_classes=10, dtype=jnp.float32)
    fresh = _abstract_resnet(jmodel, seed=4)
    fresh_sd = _bridged(fresh["params"], fresh["batch_stats"])
    sd = _ref_state_dict(torch_resnet18, seed=5)
    conv_p, conv_s = jw.convert_resnet(sd, depth=18)
    params, stats = jw.merge_into({"focuser": fresh["params"], "policy": {"w": np.ones(2)}},
                                  {"focuser": fresh["batch_stats"]}, "focuser",
                                  conv_p, conv_s)
    want = _bridged(params["focuser"], stats["focuser"])

    model = types.SimpleNamespace(focuser=tres.resnet18(num_classes=10),
                                  glancer=torch.nn.Linear(2, 2))
    model.focuser.load_state_dict(fresh_sd)
    glancer = {k: v.clone() for k, v in model.glancer.state_dict().items()}
    kept = tw.merge_into(model, "focuser", tw.convert_resnet(sd, depth=18))
    assert sorted(kept) == ["fc.bias", "fc.weight"]
    _assert_same_state(model.focuser.state_dict(), want)
    assert torch.equal(model.focuser.fc.weight, fresh_sd["fc.weight"])
    _assert_same_state(model.glancer.state_dict(), glancer)


@pytest.mark.parametrize("arch,component", [("resnet50", "focuser"),
                                            ("mobilenet_v2", "glancer")])
def test_cli_checkpoint_warm_starts_stage1(scratch_path, arch, component):
    """``python -m adafocus_torch.utils.torch_weights`` (called in process):
    its ``checkpoint.pt`` is the port's format, and the stage-1 warm start
    loads the converted component into a fresh train state, every tensor
    but the ImageNet head, and leaves the other components as they were."""
    from adafocus_torch.models.gfv import flagship
    from adafocus_torch.train.stages import create_train_state

    make = torch_resnet50 if arch == "resnet50" else torch_mobilenet_v2
    sd = _ref_state_dict(make, seed=6)
    pth = scratch_path / "ref.pth"
    torch.save({"state_dict": sd, "epoch": 3}, pth)   # a training checkpoint's wrapper
    out = scratch_path / "converted"
    path = tw.convert_checkpoint_cli([str(pth), str(out), "--arch", arch])
    tree = tckpt.load_checkpoint(str(out))
    assert path == str(out / "checkpoint.pt") and list(tree["components"]) == [component]
    assert tree["meta"]["arch"] == arch and tree["meta"]["best_acc"] == 0.0
    converted = tree["components"][component]
    _assert_same_state(converted, tw.convert_checkpoint(str(pth), arch))

    state = create_train_state(flagship(tiny=True), 1, device="cpu")
    before = {name: {k: v.clone() for k, v in getattr(state.model, name).state_dict().items()}
              for name in tckpt.COMPONENTS}
    tckpt.load_stage_components(state, tree, 1)
    head = "fc" if component == "focuser" else "classifier"
    for name, fresh in before.items():
        now = getattr(state.model, name).state_dict()
        for k, v in now.items():
            src = converted if name == component and not k.startswith(f"{head}.") else fresh
            assert torch.equal(v, src[k]), (name, k)


# ---------------------------------------------------------------------------
# the ResNet variants
# ---------------------------------------------------------------------------


def _abstract_resnet(jmodel, seed: int, size: int = 32) -> dict:
    """{'params', 'batch_stats'} of ``jmodel`` as numpy trees: the structure
    from ``jax.eval_shape`` of its init, values from a seeded generator
    (kernels normal of variance 1 / fan-in, BatchNorm scale, bias and
    statistics random, other biases small)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    rs = np.random.RandomState(seed)
    ranges = {"scale": (0.5, 1.5), "mean": (-0.5, 0.5), "var": (0.5, 1.5)}

    def fill(path, s):
        name = path[-1]
        if name == "kernel":
            v = rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ranges:
            v = rs.uniform(*ranges[name], s.shape)
        else:
            bn = len(path) >= 2 and path[-2] == "bn"
            v = rs.uniform(-0.5, 0.5, s.shape) if bn else rs.uniform(-0.1, 0.1, s.shape)
        return v.astype(np.float32)

    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else fill(path + (k,), v)
                for k, v in tree.items()}

    return {k: walk(dict(v)) for k, v in shapes.items()}


VARIANT_CASES = {
    "resnet18": (lambda: jres.resnet18(num_classes=7, dtype=jnp.float32),
                 lambda: tres.resnet18(num_classes=7)),
    "resnet34": (lambda: jres.resnet34(num_classes=7, dtype=jnp.float32),
                 lambda: tres.resnet34(num_classes=7)),
    "inner_mult=2": (lambda: jres.ResNet(block_cls=jres.Bottleneck, stage_sizes=(1, 1, 1, 1),
                                         inner_mult=2, num_classes=7, dtype=jnp.float32),
                     lambda: tres.ResNet(tres.Bottleneck, (1, 1, 1, 1), inner_mult=2,
                                         num_classes=7)),
}


@pytest.mark.parametrize("case", sorted(VARIANT_CASES))
def test_resnet_variant_matches_jax(case):
    make_j, make_t = VARIANT_CASES[case]
    jmodel, tmodel = make_j(), make_t()
    variables = _abstract_resnet(jmodel, seed=len(case))
    tmodel.load_state_dict(_bridged(variables["params"], variables["batch_stats"]))
    tmodel.eval()
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    fmap_j, pooled_j = jmodel.apply(variables, jnp.asarray(x), method=jmodel.features)
    fc = variables["params"]["fc"]   # JAX's __call__ is fc(features(x)[1])
    logits_j = np.asarray(pooled_j) @ fc["kernel"] + fc["bias"]
    with torch.no_grad():
        fmap_t, pooled_t = tmodel.features(torch.from_numpy(x).permute(0, 3, 1, 2))
        logits_t = tmodel.fc(pooled_t)
    assert pooled_t.shape[1] == tmodel.feature_dim == jmodel.feature_dim
    np.testing.assert_allclose(fmap_t.permute(0, 2, 3, 1).numpy(), np.asarray(fmap_j),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(pooled_t.numpy(), np.asarray(pooled_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["resnet101", "resnet152", "wide_resnet101"])
def test_resnet_variant_structure_matches_jax(name):
    """Every state-dict key and shape of the port's variant is what the
    bridge makes of JAX's init, and nothing else."""
    jmodel = getattr(jres, name)(num_classes=11, dtype=jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    want = {}
    for collection in shapes.values():
        for path, s in _flatten(jax.tree.map(lambda a: np.broadcast_to(
                np.zeros((), np.float32), a.shape), dict(collection))).items():
            mods, value = _convert_leaf(path, s)
            want[".".join(mods)] = tuple(value.shape)
    for key in [k for k in want if k.endswith(".running_mean")]:
        want[key[: -len("running_mean")] + "num_batches_tracked"] = ()
    with torch.device("meta"):
        tmodel = getattr(tres, name)(num_classes=11)
    got = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    assert got == want
    assert tmodel.feature_dim == jmodel.feature_dim == 2048
