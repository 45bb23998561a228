"""The launch plan of the port's ConvLSTM gates kernel (``ops.gates_plan``):
a pure function of the shapes, so these tests hold on the CPU what
``csrc/convlstm_gates.cu`` relies on: every state written exactly once by
one thread, one wave over the SMs at the shapes of rfn_mnist_production,
and the hardware's limits. The kernel itself is compared with its plain
version on the card (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest

from recurrent_flows_tpu_torch.ops import GatesPlan, gates_plan
from recurrent_flows_tpu_torch.ops.fused import GATES_MAX_THREADS, N_SMS

HW, HC = 4, 200  # the ConvLSTM's 2x2 map and h_dim in rfn_mnist_production
THREADS_PER_SM = 2048  # resident threads of one H100 SM


def _cdiv(a, b):
    return -(-a // b)


def _writes(plan: GatesPlan, b: int, hw: int, hc: int) -> np.ndarray:
    """How often each state (sample, position, channel) is written, from the
    kernel's index math: block (p, j, s) of the grid (hw, channel_blocks, b),
    thread t takes channel j·threads + t of position p of sample s, and
    returns where that channel is hc or more."""
    writes = np.zeros((b, hw, hc), np.int64)
    t = np.arange(plan.threads)
    for j in range(plan.channel_blocks):
        ch = j * plan.threads + t
        ch = ch[ch < hc]
        for p in range(hw):
            for s in range(b):
                np.add.at(writes, (s, p, ch), 1)
    return writes


def _check(plan: GatesPlan, b: int, hw: int, hc: int):
    assert 32 <= plan.threads <= GATES_MAX_THREADS and plan.threads % 32 == 0
    assert plan.channel_blocks == _cdiv(hc, plan.threads)
    assert plan.blocks == hw * plan.channel_blocks * b
    # the channels shared evenly over the fewest blocks, under a warp idle in each
    assert (plan.channel_blocks - 1) * plan.threads < hc
    assert plan.threads - 32 < _cdiv(hc, plan.channel_blocks)
    assert (_writes(plan, b, hw, hc) == 1).all()


@pytest.mark.parametrize("b,blocks", [(8, 32), (30, 120)])
def test_gates_plan_at_the_request_and_the_train_step(b, blocks):
    # 200 channels of a position in one block of 224 threads: a block per
    # (position, sample), 32 or 120 of the 132 SMs, one wave
    plan = gates_plan(b, HW, HC)
    assert plan == GatesPlan(threads=224, channel_blocks=1, blocks=blocks)
    assert plan.blocks <= N_SMS
    _check(plan, b, HW, HC)


@pytest.mark.parametrize("b", [1, 7, 33])
def test_gates_plan_at_ragged_batches(b):
    plan = gates_plan(b, HW, HC)
    assert plan == GatesPlan(threads=224, channel_blocks=1, blocks=HW * b)
    assert plan.blocks <= N_SMS
    _check(plan, b, HW, HC)


@pytest.mark.parametrize("hc", [6, 7, 16])
@pytest.mark.parametrize("b", [1, 8, 30])
def test_gates_plan_at_odd_widths(b, hc):
    # one warp per position and sample, its lanes beyond hc idle
    plan = gates_plan(b, HW, hc)
    assert plan == GatesPlan(threads=32, channel_blocks=1, blocks=HW * b)
    assert plan.blocks <= N_SMS
    _check(plan, b, HW, hc)


@pytest.mark.parametrize("b,hw,hc,channel_blocks",
                         [(2, 2, 600, 3), (3, 1, 257, 2), (50, 9, 7, 1), (5, 64, 32, 1)])
def test_gates_plan_beyond_one_block_or_132_blocks(b, hw, hc, channel_blocks):
    # more channels than a block has threads: several blocks per position;
    # more blocks than SMs: still resident at once, a few per SM
    plan = gates_plan(b, hw, hc)
    assert plan.channel_blocks == channel_blocks
    assert plan.blocks * plan.threads <= N_SMS * THREADS_PER_SM
    _check(plan, b, hw, hc)


@pytest.mark.parametrize("b,hw,hc", [(0, 4, 200), (8, 0, 200), (8, 4, 0), (65536, 4, 200)])
def test_gates_plan_raises_on_what_the_kernel_cannot_take(b, hw, hc):
    with pytest.raises(ValueError):
        gates_plan(b, hw, hc)
