"""Export of the int8 serving forward (adafocus_torch/serving.py, mode
``int8``) on the CPU, every family, modes int8 and int8+heads.

The reloaded artifact against the port's eager ``family_q8`` forward on
the same model, scales, prepared weights and inputs: atol = rtol = 1e-5,
the JAX package's bar for its reloaded int8 artifact
(tests/test_serving.py ``test_export_int8``). The artifact takes the
model's dtype, as JAX's export takes ``make_data``'s.

The port's int8 forward is held against JAX's where it already is,
tests/test_torch_port_quant.py ``test_inference_q8_matches_jax``: in
float64, on prepared weights carried over from JAX. A float32 comparison
across the two packages' own preparations would hinge on XLA's CPU
``rsqrt`` in the BatchNorm fold, which is not torch's ``1 / sqrt``: a
weight code or an activation within float32 rounding of a rounding
boundary takes the other code in the other package, and one flip cascades
through the tiny configurations' 1x1 deep maps (PERF.md, section 6). Here the
two sides of each comparison are the port's, on one preparation.

Also: the int8 artifact is smaller than the bf16 one of the same model (it
carries the packed int8 weights and no float copy of a weight it runs in
int8); without scales export raises ``ValueError`` (JAX's
``test_export_int8_requires_scales``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from adafocus_torch import serving as tserving
from adafocus_torch.benchmark import make_data
from adafocus_torch.models import gfv as tgfv
from adafocus_torch.models import quant_inference as tqi
from tests.torch_port_common import scratch_path  # noqa: F401 (a fixture)

B = 2
TINY = tgfv.flagship(tiny=True)
FAMILIES = {
    "actnet": TINY,
    "sthsth": dataclasses.replace(TINY, num_classes=5, image_size=32, glance_size=32,
                                  classifier="consensus", tsm=True, video_div=2,
                                  num_frames_focuser=4),
    "plus": dataclasses.replace(TINY, num_classes=5, num_frames=6, frame_budget=3,
                                selector_hidden=8),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model_and_scales(cfg, heads: bool, seed: int = 9):
    model = tgfv.GFV(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    data = make_data(cfg, B, device="cpu", seed=seed + 1)
    batch = tqi.calibration_batch(model, data["frames"], data["frames_small"])
    return model, tqi.calibrate_gfv(model, [batch], heads=heads)


@pytest.mark.parametrize("heads", [False, True], ids=["int8", "int8+heads"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_export_int8_matches_eager(family, heads, scratch_path):
    cfg = FAMILIES[family]
    model, scales = _model_and_scales(cfg, heads)
    path = str(scratch_path / "q8.pt2")
    tserving.save_exported(tserving.export_inference(model, B, mode="int8", scales=scales),
                           path)
    data = make_data(cfg, B, device="cpu", seed=11)
    got = tserving.load_exported(path)(data["frames"], data["frames_small"])
    qw = tqi.prepare_q8(model, scales)
    want = tqi.family_q8(cfg)(model, scales, data["frames"], data["frames_small"],
                              device="cpu", qw=qw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_int8_artifact_carries_no_float_conv_weights(scratch_path):
    """Smaller than the bf16 artifact of the same model; none of the float
    conv weights of a unit it runs in int8 is in its state, the stems' are."""
    model, scales = _model_and_scales(TINY, heads=False)
    ep8 = tserving.export_inference(model, B, mode="int8", scales=scales)
    for name in ("model_glancer_block_1_0_expand_conv_weight",
                 "model_focuser_layer1_0_conv2_conv_weight"):
        assert name not in ep8.state_dict
    assert "model_glancer_stem_conv_weight" in ep8.state_dict
    assert "qw_focuser_layer1_0_conv2_packed" in ep8.state_dict
    sizes = {}
    for mode, ep in (("int8", ep8), ("bf16", tserving.export_inference(model, B))):
        tserving.save_exported(ep, str(scratch_path / f"{mode}.pt2"))
        sizes[mode] = os.path.getsize(scratch_path / f"{mode}.pt2")
    assert sizes["int8"] < sizes["bf16"] / 2, sizes


def test_export_int8_requires_scales():
    model = tgfv.GFV(TINY, device="cpu")
    with pytest.raises(ValueError, match="scales"):
        tserving.export_inference(model, B, mode="int8")
    with pytest.raises(ValueError, match="mode"):
        tserving.export_inference(model, B, mode="int4")
