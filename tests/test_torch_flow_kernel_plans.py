"""The launch plans and input layouts of the port's two small flow kernels,
``actnorm_invconv`` (``ops.ainv_plan``) and ``coupling_transform``
(``ops.coupling_plan``, ``ops.nhwc_view``, ``ops.coupling_mode``): pure
functions of shapes and strides, so these tests hold on the CPU what the
CUDA kernels rely on: every row, output and term covered exactly once, the
hardware's limits, and the layouts the kernels read in place. Then
``AffineCoupling`` hands the kernel its strided 'split'/'cross' views and
still matches the JAX package. The kernels themselves are compared with
their plain versions on the card (tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from recurrent_flows_tpu.flows import modules as jmod
from recurrent_flows_tpu_torch.flows import modules as tmod
from recurrent_flows_tpu_torch.ops import (AinvPlan, CouplingPlan, ainv_plan,
                                           coupling_mode, coupling_plan, coupling_transform,
                                           nhwc_view)
from recurrent_flows_tpu_torch.ops.fused import (AINV_MAX_SMEM, AINV_MAX_THREADS,
                                                AINV_REGISTER_WORK, AINV_RGB_WIDTHS,
                                                AINV_TILE_COLS, AINV_TILE_LANES, AINV_TILE_MAX_K,
                                                AINV_TILE_ROWS, AINV_WIDTHS, N_SMS,
                                                ainv_tile_smem)

# x [B·H·W, C] of the folded actnorm + 1x1 at scales 0-4 of rfn_mnist_production
SCALES = [(32 >> l, 4 << l) for l in range(5)]
BATCHES = [30, 1, 7, 33]  # the train step's, then ragged ones


def _ainv_tile_terms(plan: AinvPlan, rows: int, c: int) -> np.ndarray:
    """``_ainv_terms`` of the tile design, from ``ainv_kernel_tile``'s index
    math. Thread t (cg = t mod ng, rg = t // ng mod tm/4, lane = t //
    (ng·tm/4), ng = tn/4 = groups) sums into register (i, j) of its 4x4 tile
    the products of x's tile row rg + i·tm/4 (``xp + i·rgs·stride``) and W's
    tile row cg + j·ng (``wp + j·ng·stride``) over the channels
    [s + lane·ks, s + (lane+1)·ks) of every stage s = 0, k_stage, ... below c
    (ks = k_stage / lanes). With one lane it stores register (i, j) at tile
    row rg + i·tm/4, output cg + j·ng. With more it writes the register to
    the partials at [lane, rg + i·tm/4, cg + j·ng], a fixed tree adds lane
    l + h into l for h = lanes/2, ..., 1, and thread v stores 16-byte piece v
    of lane 0's partials (floats 4v .. 4v+3 of [tm, tn]) at tile row v // ng,
    outputs 4·(v mod ng) .. +3.
    Block (bx, by) places its tile at row bx·tm, output by·tn, and stores
    only inside y. Each partial, each sum of the tree and each store must
    take the registers of its own row and output, and every output is
    stored exactly once."""
    tm, ng, lanes = plan.rows_per_block, plan.groups, plan.lanes
    tn, rgs = 4 * ng, tm // 4
    t = np.arange(plan.threads)
    cg, rg, lane = t % ng, t // ng % rgs, t // (ng * rgs)
    assert lane.max() == lanes - 1 and plan.k_stage % (4 * lanes) == 0
    ks = plan.k_stage // lanes
    ij = np.zeros((plan.threads, 4, 4), np.int64)
    i, j = ij + np.arange(4)[:, None], ij + np.arange(4)[None, :]
    lane, rg, cg = (np.broadcast_to(a[:, None, None], ij.shape) for a in (lane, rg, cg))
    x_row, w_row = rg + i * rgs, cg + j * ng  # what register (i, j) sums
    # the tile position each register goes to: a partial, or with one lane
    # its store
    at_m, at_n = rg + i * rgs, cg + j * ng
    held = np.full((lanes, tm, tn, 2), -1)
    assert len(set(zip(lane.ravel(), at_m.ravel(), at_n.ravel()))) == lane.size
    held[lane, at_m, at_n] = np.stack([x_row, w_row], -1)
    # each partial's channels, counted by a difference along c'
    diff = np.zeros((lanes, tm, tn, c + 1), np.int16)
    for s in range(0, c, plan.k_stage):
        k0, k1 = np.minimum(s + lane * ks, c), np.minimum(s + (lane + 1) * ks, c)
        np.add.at(diff, (lane, at_m, at_n, k0), 1)
        np.add.at(diff, (lane, at_m, at_n, k1), -1)
    part = np.cumsum(diff, axis=3, dtype=np.int16)[..., :c]
    h = lanes // 2
    while h >= 1:
        assert (held[:h] == held[h:2 * h]).all()
        part[:h] += part[h:2 * h]
        h //= 2
    src_m, src_n = at_m, at_n  # what each store takes
    if lanes > 1:  # piece v: floats 4v .. 4v+3 of lane 0's partials
        v, q = np.arange(tm * tn // 4).repeat(4), np.tile(np.arange(4), tm * tn // 4)
        src_m, src_n = divmod(4 * v + q, tn)
        at_m, at_n = v // ng, 4 * (v % ng) + q
    src_m, src_n, at_m, at_n = (a.ravel() for a in (src_m, src_n, at_m, at_n))
    assert (held[0, src_m, src_n] == np.stack([at_m, at_n], -1)).all()
    col_blocks = -(-c // tn)
    assert plan.blocks == -(-rows // tm) * col_blocks
    count = np.zeros((rows, c, c), np.int8)
    stores = np.zeros((rows, c), np.int64)
    for bx in range(-(-rows // tm)):
        for by in range(col_blocks):
            row, d = bx * tm + at_m, by * tn + at_n
            live = (row < rows) & (d < c)
            np.add.at(stores, (row[live], d[live]), 1)
            count[row[live], d[live]] = part[0, src_m[live], src_n[live]]
    assert (stores == 1).all()
    return count


def _ainv_terms(plan: AinvPlan, rows: int, c: int) -> np.ndarray:
    """How often each product y[r, d] += w[d, c'] · x[r, c'] is summed by the
    plan's threads, from the kernel's index math (csrc/actnorm_invconv.cu)."""
    if plan.vec == 2:
        return _ainv_tile_terms(plan, rows, c)
    count = np.zeros((rows, c, c), np.int64)
    t = np.arange(plan.threads)
    if not plan.vec:  # one thread per output, all c' in a loop
        for bx in range(plan.blocks):
            row, d = bx * plan.rows_per_block + t // c, t % c
            live = row < rows
            count[row[live], d[live], :] += 1
        return count
    per_row, n_vec = plan.groups * plan.lanes, c // 4
    col_blocks = n_vec // plan.groups
    assert plan.blocks % col_blocks == 0
    for bx in range(plan.blocks // col_blocks):
        for by in range(col_blocks):
            row = bx * plan.rows_per_block + t // per_row
            j = t % per_row
            g, lane = by * plan.groups + j // plan.lanes, j % plan.lanes
            live = row < rows
            for k in range(n_vec // plan.lanes):
                piece = k * plan.lanes + lane
                for e in range(4):
                    for dd in range(4):
                        np.add.at(count, (row[live], 4 * g[live] + dd, 4 * piece[live] + e), 1)
    return count


def _check_ainv_plan(plan: AinvPlan, rows: int, c: int):
    assert plan.threads <= AINV_MAX_THREADS
    if plan.vec == 2:
        tm, tn = plan.rows_per_block, 4 * plan.groups
        assert tm % 4 == 0 and tm <= AINV_TILE_ROWS and tn <= AINV_TILE_COLS
        assert plan.threads == plan.lanes * (tm // 4) * plan.groups
        # a stage fits the block's shared memory; a lane sums at least 4
        # channels of it, the lanes are a power of 2 (their tree of sums)
        assert ainv_tile_smem(tm, tn, plan.lanes, plan.k_stage, c) <= AINV_MAX_SMEM
        assert plan.k_stage <= max(AINV_TILE_MAX_K, c) and plan.k_stage // plan.lanes >= 4
        assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes <= AINV_TILE_LANES
    elif plan.vec:
        assert c % 4 == 0 and (c // 4) % plan.lanes == 0 and plan.lanes in (1, 2, 4)
        assert (c // 4) % plan.groups == 0
        assert plan.threads == plan.rows_per_block * plan.groups * plan.lanes
    else:
        assert plan.lanes == 1 and plan.threads == plan.rows_per_block * c
    assert (_ainv_terms(plan, rows, c) == 1).all()


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("hw,c", SCALES)
def test_ainv_plan_covers_every_term_once(b, hw, c):
    rows = b * hw * hw
    plan = ainv_plan(rows, c)
    assert plan.vec == 1
    assert plan.lanes == {4: 1, 8: 1, 16: 1, 32: 4, 64: 4}[c]
    assert plan.groups == min(c // 4, 2)
    if b == 30:  # every scale of the train step spreads over most SMs, one wave
        assert 0.9 * N_SMS <= plan.blocks <= N_SMS
    _check_ainv_plan(plan, rows, c)


def _regime(rows: int, c: int, aligned: bool = True) -> int:
    """The regime ``ainv_plan`` takes on x [rows, c]: the compile-time width
    (1) at the gray widths and 12, and at 24, 48 and 96 up to
    ``AINV_REGISTER_WORK`` (aligned pointers); the tiles (2) at 24 and 48
    above it and at any c above 64; else the run-time width (0)."""
    if aligned and c in AINV_RGB_WIDTHS and (c == 12 or rows * c * c <= AINV_REGISTER_WORK):
        return 1
    if c > 64 or (aligned and c in (24, 48)):
        return 2
    return int(aligned and c in AINV_WIDTHS)


@pytest.mark.parametrize("rows,c", [(7, 2), (50, 6), (50, 7), (50, 48), (1, 1), (33, 64)])
def test_ainv_plan_at_odd_widths(rows, c):
    plan = ainv_plan(rows, c)
    assert plan.vec == _regime(rows, c)
    _check_ainv_plan(plan, rows, c)


# x [rows, C] of the tile design: the BAIR CLI step's 2x2x192 (B=32), the wide
# widths at [512, C], rfn_bair's 4x4x96, 8x8x48 and 16x16x24 (B=32), then
# ragged rows and odd widths above 64 (several stages at [1, 1024], [5, 300])
TILE_SHAPES = [(128, 192), (512, 96), (512, 128), (512, 192), (512, 256), (2048, 48),
               (8192, 24)]


@pytest.mark.parametrize("rows,c", TILE_SHAPES + [(131, 66), (7, 100), (33, 130), (7, 192),
                                                  (5, 300), (1, 256), (1, 1024), (131, 97)])
def test_ainv_plan_tiles_cover_every_term_once(rows, c):
    plan = ainv_plan(rows, c)
    assert plan.vec == 2
    _check_ainv_plan(plan, rows, c)
    if (rows, c) in TILE_SHAPES:
        # one wave over most of the SMs (two blocks an SM up to 64 channels),
        # all of C in one stage
        per_sm = 2 if c <= 64 else 1
        assert 0.9 * per_sm * N_SMS <= plan.blocks <= per_sm * N_SMS and plan.k_stage == c


# The RGB widths 24-96 by work: x [8·H·W, C] of rfn_bair's serving request and
# twice its rows take the compile-time instance, [32·H·W, C] of its train
# step the tiles; 12 always the compile-time instance
@pytest.mark.parametrize("rows,c,vec", [(2048, 24, 1), (4096, 24, 1), (8192, 24, 2),
                                        (512, 48, 1), (1024, 48, 1), (2048, 48, 2),
                                        (128, 96, 1), (256, 96, 1), (512, 96, 2),
                                        (8192, 12, 1), (32768, 12, 1)])
def test_ainv_plan_routes_the_rgb_widths_by_work(rows, c, vec):
    plan = ainv_plan(rows, c)
    assert plan.vec == vec == _regime(rows, c)
    if rows <= 4096:
        _check_ainv_plan(plan, rows, c)
    # unaligned pointers: the run-time width up to 64, the tiles above
    assert ainv_plan(rows, c, aligned=False).vec == (0 if c <= 64 else 2)


def test_ainv_plan_takes_the_run_time_width_on_unaligned_pointers():
    plan = ainv_plan(120, 64, aligned=False)
    assert plan.vec == 0 and plan.lanes == 1
    _check_ainv_plan(plan, 120, 64)


@pytest.mark.parametrize("rows", [1, 3, 131, 4096, 100_000])
@pytest.mark.parametrize("c", [4, 8, 16, 32, 64])
def test_ainv_plan_at_other_row_counts(rows, c):
    # under two waves of N_SMS blocks until the blocks are full, more beyond
    plan = ainv_plan(rows, c)
    assert plan.blocks < 2 * N_SMS or plan.threads == AINV_MAX_THREADS
    if rows <= 131:
        _check_ainv_plan(plan, rows, c)


@pytest.mark.parametrize("rows,c,match", [(0, 4, "bad shape"), (0, 96, "at least 1 row"),
                                          (10, 0, "at least 1 row and 1 channel")])
def test_ainv_plan_raises_on_what_the_kernel_cannot_take(rows, c, match):
    with pytest.raises(ValueError, match=match):
        ainv_plan(rows, c)


# z2 [B, hw, hw, C/2] of the serving request, then of the train step's scales
COUPLING = [(8, 32, 2)] + [(b, hw, c // 2) for b in BATCHES for hw, c in SCALES]


def _check_coupling_plan(plan: CouplingPlan, b: int, n: int):
    nq = -(-n // 4)
    assert plan.blocks == b  # one block per sample
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    groups = []
    for t in range(plan.threads):  # one sample's groups, as the kernel loops
        groups += range(t, nq, plan.threads)
    assert sorted(groups) == list(range(nq))


@pytest.mark.parametrize("b,hw,ch", COUPLING)
def test_coupling_plan_covers_every_group_once(b, hw, ch):
    n = hw * hw * ch
    plan = coupling_plan(b, n)
    assert -(-n // 4) <= plan.threads  # one group of 4 values per thread: no loop
    _check_coupling_plan(plan, b, n)


@pytest.mark.parametrize("b,n", [(8, 2048), (30, 128), (33, 50), (1, 3), (2, 9000),
                                 (7, 4097)])
def test_coupling_plan_at_odd_sizes(b, n):
    # a sample of more than 4,096 values: each thread loops over several groups
    plan = coupling_plan(b, n)
    assert plan.threads == min(1024, -(-n // 128) * 32)
    _check_coupling_plan(plan, b, n)


@pytest.mark.parametrize("b,n", [(0, 8), (2, 0), (-1, 8), (2, -4)])
def test_coupling_plan_raises_on_bad_input(b, n):
    with pytest.raises(ValueError):
        coupling_plan(b, n)


def _x(*shape):
    return torch.arange(float(np.prod(shape))).reshape(shape)


def _addresses_match(t, r, cs):
    """Every element of t lies where the kernel looks for it: (b, h, w, c) at
    ((b·H + h)·W + w)·r + c·cs floats from its first element."""
    b, h, w, c = t.shape
    pos = torch.arange(b * h * w).reshape(b, h, w, 1)
    want = pos * r + torch.arange(c) * cs
    got = sum(torch.arange(n).reshape([-1 if i == d else 1 for i in range(4)]) * st
              for d, (n, st) in enumerate(zip(t.shape, t.stride())))
    return torch.equal(got.expand(b, h, w, c), want)


@pytest.mark.parametrize("b,h,w,c", [(2, 32, 32, 4), (30, 2, 2, 64), (3, 1, 5, 14),
                                     (1, 1, 1, 6), (4, 3, 1, 2), (2, 4, 4, 2)])
def test_nhwc_view_accepts_the_coupling_halves(b, h, w, c):
    x = _x(b, h, w, c)
    half = c // 2
    views = {"whole": x, "split": x[..., half:], "cross even": x[..., 0::2],
             "cross odd": x[..., 1::2], "contiguous half": x[..., half:].contiguous(),
             "first sample": x[:1, ..., half:]}
    for name, t in views.items():
        r, cs = nhwc_view(name, t)
        assert cs in (1, 2) and _addresses_match(t, r, cs), name
    if h * w > 1:  # the production layouts, with their row strides
        assert nhwc_view("x", x[..., half:]) == (c, 1)
        assert nhwc_view("x", x[..., 0::2]) == (c, 2 if half > 1 else 1)


@pytest.mark.parametrize("view", [
    lambda x: x.transpose(1, 2),  # H and W swapped
    lambda x: x[..., 0::4],  # channel stride 4
    lambda x: x[:, ::2],  # every other row of the map
    lambda x: x[:, :, :3],  # a part of each row: positions no longer evenly spaced
    lambda x: x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),  # NCHW storage
    lambda x: x[..., :1].expand(-1, -1, -1, 3),  # channel stride 0
    lambda x: x.reshape(-1, 8),  # not NHWC
])
def test_nhwc_view_raises_on_other_layouts(view):
    with pytest.raises(ValueError, match="row stride|NHWC"):
        nhwc_view("x", view(_x(2, 4, 4, 8)))


def test_coupling_transform_checks_layouts_on_the_cpu_too():
    x = torch.randn(2, 4, 4, 8)
    out, ld = coupling_transform(x[..., 4:], x[..., 0::2], torch.tanh(x[..., 1::2]))
    assert out.shape == (2, 4, 4, 4) and ld.shape == (2,)
    with pytest.raises(ValueError, match="shift: strides"):
        coupling_transform(x[..., 4:], x[..., :4].transpose(1, 2), x[..., :4])


def _views(x, h):
    ch = x.shape[-1] // 2
    return [(t.data_ptr(), *nhwc_view("t", t)) for t in (x[..., ch:], h[..., 0::2],
                                                         torch.tanh(h[..., 1::2]))]


@pytest.mark.parametrize("hw,c,mode", [(32, 4, 2), (16, 8, 4), (2, 64, 4), (5, 4, 1),
                                       (4, 6, 1), (3, 14, 1)])
def test_coupling_mode_of_the_production_views(hw, c, mode):
    x, h = torch.randn(2, hw, hw, c), torch.randn(2, hw, hw, c)
    n = hw * hw * c // 2
    assert coupling_mode(c // 2, n, _views(x, h)) == mode


def test_coupling_mode_falls_back_to_4_byte_loads_on_unaligned_views():
    h = torch.randn(2, 8, 8, 8)
    ok = [(h.data_ptr(), 8, 2)] * 3
    assert coupling_mode(4, 256, ok) == 4
    assert coupling_mode(4, 256, ok[:2] + [(h.data_ptr() + 4, 8, 2)]) == 1  # h[..., 1::2]
    assert coupling_mode(4, 256, ok[:2] + [(h.data_ptr(), 6, 1)]) == 1  # row stride 6
    assert coupling_mode(2, 128, [(h.data_ptr() + 8, 4, 1)] * 3) == 2  # 8-byte aligned
    assert coupling_mode(2, 128, [(h.data_ptr() + 8, 4, 2)] * 3) == 1
    assert coupling_mode(2, 128, [(h.data_ptr(), 2, 1)] * 3) == 2  # contiguous
    assert coupling_mode(2, 128, [(h.data_ptr() + 8, 2, 1)] * 3) == 1
    assert coupling_mode(2, 126, [(h.data_ptr(), 4, 1)] * 3) == 1  # n no multiple of 4


@pytest.mark.parametrize("clamp", ["realnvp", "none"])
def test_affine_coupling_hands_the_kernel_its_views_and_matches_jax(clamp, monkeypatch):
    """AffineCoupling passes z2 and shift to coupling_transform as strided
    views of x and of the net's output, copying nothing, and both
    directions still match the JAX package."""
    b, c, cc, u = 2, 8, 5, 16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, 8, 8, c)).astype(np.float32)
    cond = rng.standard_normal((b, 8, 8, cc)).astype(np.float32)
    jm = jmod.AffineCoupling(c, hidden_units=u, clamp_type=clamp)
    v = jax.jit(lambda k: jm.init(k, x, cond, jnp.zeros(b)))(jax.random.key(0))
    v = {"params": U.perturb(v["params"], 11)}
    ref, ref_ld = jm.apply(v, x, cond, jnp.zeros(b))
    tm = U.port_from(tmod.AffineCoupling(c, cc, u, clamp_type=clamp), v)
    seen = []

    def spy(z2, shift, s, reverse=False):
        seen.append([(tuple(t.stride()), t.is_contiguous()) for t in (z2, shift, s)])
        return coupling_transform(z2, shift, s, reverse)

    monkeypatch.setattr(tmod, "coupling_transform", spy)
    got, ld = tm(torch.tensor(x), torch.tensor(cond), torch.zeros(b))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(ref_ld), rtol=1e-5, atol=1e-4)
    back, _ = tm.reverse(got, torch.tensor(cond))
    np.testing.assert_allclose(back.detach().numpy(), x, atol=1e-4)
    row = 8 * 8 * c
    for z2, shift, s in seen:
        assert z2 == ((row, 8 * c, c, 1), False)  # x[..., C/2:]
        assert shift == ((row, 8 * c, c, 2), False)  # h[..., 0::2]
        # the realnvp clamp makes s afresh; 'none' passes h[..., 1::2] itself
        assert s == (((row, 8 * c, c, 2), False) if clamp == "none"
                     else ((row // 2, 8 * c // 2, c // 2, 1), True))
    assert len(seen) == 2
