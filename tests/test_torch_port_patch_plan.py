"""The patch kernel's host plan (adafocus_torch/ops/patch.py
plan_patch_extract), on the CPU: how the work is cut into row bands and
blocks. The kernel itself is held against its plain version on a GPU by
tests/test_torch_port_cuda.py.
"""

import pytest

from adafocus_torch.ops import patch as tpatch

# the published (frame, patch) sizes: ActivityNet and sth-sth (README.md)
PUBLISHED = [(224, 96), (224, 128), (224, 160), (224, 192), (224, 144), (224, 176)]
ELEMS = [1, 2, 4]


def _check_split(plan, n, p, c, e, sms=tpatch.SM_COUNT):
    row = p * c * e
    # the bands cover the patch, none is empty
    assert plan.bands == -(-p // plan.rows)
    assert plan.rows * (plan.bands - 1) < p <= plan.rows * plan.bands
    # an item moves at most STAGE_CAP bytes, unless one row is more
    assert plan.rows * row <= max(row, tpatch.STAGE_CAP)
    assert plan.grid == max(1, min(n * plan.bands, tpatch.BLOCKS_PER_SM * sms))


@pytest.mark.parametrize("e", ELEMS)
@pytest.mark.parametrize("s,p", PUBLISHED)
@pytest.mark.parametrize("n", [16, 1024])
def test_published_sizes_plan(n, s, p, e):
    plan = tpatch.plan_patch_extract(n, p, 3, e)
    _check_split(plan, n, p, 3, e)
    assert n * plan.bands >= tpatch.MIN_ITEMS_PER_SM * tpatch.SM_COUNT
    if n == 1024:
        # enough items already: the tallest band that fits STAGE_CAP
        rmax = min(p, tpatch.STAGE_CAP // (p * 3 * e))
        assert plan.bands == -(-p // rmax)


@pytest.mark.parametrize("e", ELEMS)
@pytest.mark.parametrize("n,h,w,c,p", [
    (5, 37, 37, 3, 11), (6, 29, 45, 5, 13), (1100, 12, 10, 3, 5),   # test_extract_matches_jax_slice
    (9, 41, 50, 3, 17), (7, 50, 77, 5, 13), (70000, 12, 10, 3, 5),  # chip_smoke.py's odd shapes
])
def test_odd_shapes_plan(n, h, w, c, p, e):
    plan = tpatch.plan_patch_extract(n, p, c, e)
    _check_split(plan, n, p, c, e)
    if n * p < tpatch.MIN_ITEMS_PER_SM * tpatch.SM_COUNT:
        assert plan.rows == 1   # too few rows in all: one a band


@pytest.mark.parametrize("s,p", PUBLISHED)
def test_batch_one_gives_every_block_an_item(s, p):
    # B=1, T=16: 16 patches still cut into two items for each of 132 SMs
    plan = tpatch.plan_patch_extract(16, p, 3, 2)
    assert 16 * plan.bands >= 2 * 132
    assert plan.grid <= 16 * plan.bands


@pytest.mark.parametrize("n", [1, 2, 16, 100, 1024, 70000])
@pytest.mark.parametrize("p", [1, 5, 17, 96, 144, 223])
def test_bands_cover_the_patch(n, p):
    plan = tpatch.plan_patch_extract(n, p, 3, 2)
    assert plan.bands == -(-p // plan.rows)
    assert plan.rows * (plan.bands - 1) < p <= plan.rows * plan.bands
    assert 1 <= plan.grid <= n * plan.bands


def test_flagship_plan():
    # the main path's call: bf16, N = 64 x 16, 96^2 from 224^2, in bands of
    # 24 rows (13.5 KB), 4 a patch
    plan = tpatch.plan_patch_extract(1024, 96, 3, 2)
    assert plan == (24, 4, tpatch.BLOCKS_PER_SM * 132)


def test_plan_follows_the_sm_count():
    # a card with 114 SMs (H100 PCIe) at batch 1: fewer items asked for,
    # a smaller grid
    plan = tpatch.plan_patch_extract(16, 96, 3, 2, sms=114)
    _check_split(plan, 16, 96, 3, 2, sms=114)
    assert 16 * plan.bands >= 2 * 114
    assert plan.grid == min(16 * plan.bands, tpatch.BLOCKS_PER_SM * 114)
