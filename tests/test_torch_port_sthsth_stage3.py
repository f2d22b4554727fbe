"""Port parity for the sth-sth family's stage-3 step in float64 on the CPU:
the frozen greedy policy's patches, the focuser and the head trained under
stage 1's freeze matrix, with the TSN optimizer groups and partial
BatchNorm on and off, one step against the JAX package's (the port takes
its own greedy actions). Set-up and tolerances:
tests/test_torch_port_sthsth_steps.py.
"""

import pytest

from tests.test_torch_port_sthsth_steps import (  # noqa: F401 (fixtures)
    check_train_step, jax_gradient_of, one_torch_thread, setup64,
)


@pytest.fixture(scope="module", params=[False, True], ids=["stage3", "stage3-pbn"])
def jax_gradient(request, setup64):  # noqa: F811
    return jax_gradient_of(3, request.param, setup64)


@pytest.mark.parametrize("tsn", [False, True], ids=["sgd", "tsn"])
def test_sthsth_stage3_step_matches_jax(jax_gradient, setup64, tsn):  # noqa: F811
    check_train_step(jax_gradient, setup64, tsn)
