"""AdaFocus in PyTorch for NVIDIA Hopper (H100).

The PyTorch/CUDA counterpart of ``adafocus_tpu``, laid out the same way so
that each module's counterpart is easy to find (``models/gfv.py``,
``models/mobilenet.py``, ``ops/patch.py``, ...). Convolutions, matmuls,
BatchNorm and GRU gates are PyTorch library ops; every kernel that the JAX
package wrote in Pallas becomes a CUDA kernel written for ``sm_90a``
(``csrc/``, built at first use by ``ops/_kernels.py``).

Covered so far: the deployment forward of the ActivityNet family
(``models.gfv.inference``): glance, greedy policy, patch extraction, focus
and the GRU classifier; and its four-stage training (``train.stages``:
the supervised stages 0, 1 and 3, the stage-2 PPO step on the sampled
policy with the random-patch lookahead baseline (``ppo.core``), and the
eval step; ``train.optim``). The deployment forward of the sth-sth family
(``models.gfv_sthsth.inference_sthsth``: temporal-shift backbones, one
continuous action per video division, sum consensus) and its training
(``train.stages_sthsth``: stages 1, 2 and 3, the TSN optimizer groups,
partial BatchNorm, per-block recomputation). ``benchmark`` times the
forwards (``port_bench.py``). Both families train and evaluate from the
port's own CLI
(``python -m adafocus_torch.cli.train`` / ``cli.evaluate``, ``config``)
over its data layer (``data``: the loaders, the augmentation on the card,
the dataset cache) and checkpoints (``train.checkpoint``).
``weights.gfv_state_dict_from_flax`` carries the weights of a trained flax
GFV over, ``weights.ppo_state_from_flax`` a stage-2 learner's Adam state.

Every entry point runs on the GPU unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request it raises
(``default_device``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["default_device"]


def default_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else CUDA;
    a CUDA device without an index resolves to the current one.

    Raises ``RuntimeError`` when no device is given and no GPU is visible,
    so that nothing falls back to the CPU without the caller asking.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
