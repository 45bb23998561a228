"""The launch plan of the port's two GlowStep kernels
(``recurrent_flows_tpu_torch.ops.glowstep.launch_plan``): a pure function of
the shapes that decides the batch tile, the cluster size, the register
tiles, the weight ring and the layout of shared memory. It runs on the CPU,
so these tests hold what the CUDA kernels rely on without a card: the
limits of the hardware, the cover of the batch by the tiles and of the
weights by the chunks of the stream. The kernels themselves are compared
with their plain versions on the card (tests/test_torch_kernels_cuda.py).
"""

import pytest

from recurrent_flows_tpu_torch.ops import (LaunchPlan, launch_plan, plan_chunks,
                                           plan_samples)
from recurrent_flows_tpu_torch.ops.glowstep import (MAX_SMEM_BYTES, THREADS,
                                                    _row_stride, _tiles)

# x [B, hw, hw, C] with Cc cond channels at the scales 1-4 of
# rfn_mnist_production (U = 256)
PRODUCTION = [(16, 8, 32), (8, 16, 64), (4, 32, 128), (2, 64, 256)]
ODD = [  # b, h, w, c, cc, u: widths that are no multiples of 4, H != W
    (3, 8, 8, 8, 6, 32), (1, 2, 2, 2, 3, 5), (7, 4, 6, 6, 5, 20),
    (2, 3, 5, 10, 7, 36), (5, 8, 8, 2, 1, 32)]


@pytest.mark.parametrize("b", [8, 30])
@pytest.mark.parametrize("hw,c,cc", PRODUCTION)
def test_production_plan_fits_the_card(b, hw, c, cc):
    plan = launch_plan(b, hw, hw, c, cc, 256)
    assert isinstance(plan, LaunchPlan)
    assert plan.smem_bytes == 4 * plan.smem_floats <= MAX_SMEM_BYTES
    assert 1 <= plan.cluster_blocks <= 16
    assert plan.clusters * plan.batch_tile >= b > (plan.clusters - 1) * plan.batch_tile
    assert plan.clusters * plan.cluster_blocks <= 2 * 132  # at most two waves
    assert 2 <= plan.stages <= 4
    # rows of more than one sample where a map has fewer than 64 positions;
    # 16-block clusters only where 4 of them take the whole batch
    if hw * hw < 64:
        assert plan.batch_tile > 1
    assert plan.cluster_blocks == (16 if hw * hw < 64 and b == 8 else 8)
    # the 16-byte copies apply to every production shape
    assert plan.vec == 3


@pytest.mark.parametrize("shape", [(b, hw, hw, c, cc, 256) for b in (8, 30)
                                   for hw, c, cc in PRODUCTION] + ODD)
def test_layout_of_shared_memory(shape):
    plan = launch_plan(*shape)
    offsets = [getattr(plan, f) for f in LaunchPlan._fields if f.startswith("o_")]
    assert offsets[0] == 0 and offsets == sorted(offsets)
    assert all(o % 4 == 0 for o in offsets)  # 16-byte loads from every map
    assert plan.o_ring + plan.stages * plan.stage_floats <= plan.smem_floats
    assert plan.stage_floats % 4 == 0
    for stride in (plan.s_in, plan.s_h, plan.s_g):
        assert stride % 8 == 4  # eight neighbouring rows, eight bank groups
    b, h, w, c, cc, u = shape
    assert plan.s_in >= c // 2 + cc
    # every product's 4x4 tiles fit the block's threads
    nu = -(-u // plan.cluster_blocks)
    assert _tiles(plan.batch_tile * h * w, max(nu, c), plan.im) <= THREADS


@pytest.mark.parametrize("b,tile", [(1, None), (7, None), (30, 4), (30, 8), (33, None),
                                    (33, 5)])
def test_ragged_batches_are_covered_once(b, tile):
    plan = launch_plan(b, 4, 4, 32, 128, 256, batch_tile=tile)
    tiles = plan_samples(plan, b)
    assert len(tiles) == plan.clusters
    assert sorted(s for t in tiles for s in t) == list(range(b))
    assert all(1 <= len(t) <= plan.batch_tile for t in tiles)
    if tile:
        assert plan.batch_tile == tile


@pytest.mark.parametrize("shape", ODD)
def test_odd_widths_get_a_plan(shape):
    b, h, w, c, cc, u = shape
    plan = launch_plan(*shape)
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    # 16-byte copies only where every slice starts on a multiple of 4
    assert bool(plan.vec & 1) == (u % (4 * plan.cluster_blocks) == 0)
    assert bool(plan.vec & 2) == (c % 4 == 0)
    # the hidden map goes through L2 only with 16-byte copies
    assert not plan.ha_global or plan.vec & 1


@pytest.mark.parametrize("shape", [(2, 16, 16, 32, 256, 256), (1, 16, 16, 32, 128, 256),
                                   (4, 16, 16, 8, 2048, 256)])
def test_a_map_too_large_raises_with_its_bytes(shape):
    with pytest.raises(ValueError, match=r"needs \d+ B of shared memory"):
        launch_plan(*shape)


def test_more_rows_than_the_threads_take_raise():
    with pytest.raises(ValueError, match="1024 rows by 32 columns"):
        launch_plan(1, 32, 32, 4, 16, 256)


def test_very_wide_hidden_maps_take_16_blocks():
    # 256 rows by 64 columns are too many 8x4 tiles for a block's threads;
    # on 16 blocks a slice has 32 columns
    assert launch_plan(2, 16, 16, 8, 8, 512).cluster_blocks == 16


@pytest.mark.parametrize("bad", [(0, 4, 4, 8, 4, 32), (2, 4, 4, 7, 4, 32),
                                 (2, 4, 4, 8, 4, 0)])
def test_bad_shapes_raise(bad):
    with pytest.raises(ValueError, match="bad shape"):
        launch_plan(*bad)


@pytest.mark.parametrize("shape", [(8, hw, hw, c, cc, 256) for hw, c, cc in PRODUCTION]
                         + [(30, 8, 8, 16, 64, 256)] + ODD)
def test_chunks_cover_every_weight_once(shape):
    b, h, w, c, cc, u = shape
    plan = launch_plan(*shape)
    ca, nu = c // 2 + cc, -(-u // plan.cluster_blocks)
    seen = {"wa": [], "wb": [], "wc": []}
    for array, tap, taps, row, rows, floats in plan_chunks(plan, h * w, c, cc, u):
        assert 0 < floats <= plan.stage_floats
        assert rows > 0
        seen[array] += [(t, r) for t in range(tap, tap + taps)
                        for r in range(row, row + rows)]
    assert sorted(seen["wa"]) == [(t, r) for t in range(9) for r in range(ca)]
    assert sorted(seen["wb"]) == [(0, r) for r in range(u)]
    assert sorted(seen["wc"]) == [(t, r) for t in range(9) for r in range(nu)]


@pytest.mark.parametrize("fixed", [dict(cluster_blocks=16), dict(ha_global=True),
                                   dict(ha_global=False), dict(stages=2), dict(im=2),
                                   dict(batch_tile=1)])
def test_a_fixed_choice_is_kept(fixed):
    plan = launch_plan(30, 8, 8, 16, 64, 256, **fixed)
    for key, value in fixed.items():
        assert getattr(plan, key) == int(value)
    assert plan.smem_bytes <= MAX_SMEM_BYTES


def test_the_hidden_map_cannot_go_through_l2_in_4_byte_copies():
    with pytest.raises(ValueError, match="16-byte"):
        launch_plan(3, 8, 8, 8, 6, 20, ha_global=True)


@pytest.mark.parametrize("n", [1, 4, 16, 32, 36, 72, 144, 288, 10])
def test_row_stride(n):
    stride = _row_stride(n)
    assert n <= stride <= n + 7 and stride % 8 == 4
