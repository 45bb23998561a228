"""Each kernel of the port against its plain version on an NVIDIA GPU.

Marked ``cuda``: they need a CUDA device with nvcc, and skip where there
is none. On the card the same comparisons, at the serving
path's full shapes, run in ``python3 chip_smoke.py``.

Tolerances as in chip_smoke.py, each element within tol·(1+|ref|): 1e-5 for
the elementwise kernels and the folded 1x1, 1e-4 for the coupling's logdet
(a sum of up to 2,048 terms), one GlowStep and the chain after K steps of
three convs each; two launches of any kernel on the same inputs must agree
bit for bit. Each kernel operator's registered
gradients are held to autograd through the plain version, 1e-4 of
1+|ref| (the forward values they start from differ by the kernel's
rounding). The plain side runs with TF32 off.
"""

import math

import pytest
import torch

from recurrent_flows_tpu_torch.ops import (
    GlowStepParams,
    ainv_plan,
    actnorm_invconv,
    actnorm_invconv_ref,
    convlstm_gates,
    convlstm_gates_ref,
    coupling_transform,
    coupling_plan,
    coupling_transform_ref,
    glowchain,
    glowchain_ref,
    glowstep,
    glowstep_ref,
)
from recurrent_flows_tpu_torch.ops.fused import AINV_REGISTER_WORK
from recurrent_flows_tpu_torch.utils import float32_precision

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels have no CPU mode)")
    with float32_precision():
        yield torch.Generator(device="cuda").manual_seed(0)


def _close(got, ref, tol):
    assert ((got - ref).abs() <= tol * (1 + ref.abs())).all()


@pytest.mark.parametrize("reverse", [False, True])
def test_coupling_kernel_matches_plain(cuda, reverse):
    z2, shift, s = (torch.randn(3, 32, 32, 2, generator=cuda, device="cuda")
                    for _ in range(3))
    n = coupling_transform.launches
    out, ld = coupling_transform(z2, shift, 0.5 * s, reverse)
    torch.cuda.synchronize()
    assert coupling_transform.launches == n + 1
    ref_out, ref_ld = coupling_transform_ref(z2, shift, 0.5 * s, reverse)
    _close(out, ref_out, 1e-5)
    _close(ld, ref_ld, 1e-5)


def _coupling_views(cuda, b, hw, ch, layout):
    """(z2, shift, s) of [b, hw, hw, ch]: contiguous, or as AffineCoupling
    gives them, the 'split' half of x and the 'cross' half of the net's
    output (s contiguous, or with the 'none' clamp the other 'cross' half)."""
    def n(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=cuda, device="cuda")

    if layout == "contiguous":
        return n(b, hw, hw, ch), n(b, hw, hw, ch), n(b, hw, hw, ch, scale=0.5)
    x, h = n(b, hw, hw, 2 * ch), n(b, hw, hw, 2 * ch, scale=0.5)
    s = h[..., 1::2] if layout == "cross s" else torch.tanh(h[..., 1::2])
    return x[..., ch:], h[..., 0::2], s


def _coupling_agrees(cuda, b, hw, ch, layout):
    z2, shift, s = _coupling_views(cuda, b, hw, ch, layout)
    for reverse in (False, True):
        n = coupling_transform.launches
        out, ld = coupling_transform(z2, shift, s, reverse)
        out2, ld2 = coupling_transform(z2, shift, s, reverse)
        torch.cuda.synchronize()
        assert coupling_transform.launches == n + 2
        ref_out, ref_ld = coupling_transform_ref(z2, shift, s, reverse)
        assert out.is_contiguous()
        _close(out, ref_out, 1e-5)
        _close(ld, ref_ld, 1e-4)
        assert torch.equal(out, out2) and torch.equal(ld, ld2)


# z2 [B, hw, hw, C/2] of the serving request (B=8) and of the train step's
# five scales (B=30)
COUPLING_SHAPES = [(8, 32, 2)] + [(30, 32 >> l, 2 << l) for l in range(5)]


@pytest.mark.parametrize("layout", ["split/cross", "contiguous"])
@pytest.mark.parametrize("b,hw,ch", COUPLING_SHAPES)
def test_coupling_kernel_at_production_shapes(cuda, b, hw, ch, layout):
    _coupling_agrees(cuda, b, hw, ch, layout)


# z2 of the standalone models: GlowImage's three scales at 96 frames,
# cGlow's two at B=16
@pytest.mark.parametrize("layout", ["split/cross", "contiguous"])
@pytest.mark.parametrize("b,hw,ch", [(96, 32, 2), (96, 16, 4), (96, 8, 8), (16, 16, 6),
                                     (16, 8, 12)])
def test_coupling_kernel_at_the_standalone_models_shapes(cuda, b, hw, ch, layout):
    _coupling_agrees(cuda, b, hw, ch, layout)


@pytest.mark.parametrize("b", [1, 7, 33])
@pytest.mark.parametrize("hw,ch", [(32, 2), (8, 8)])
def test_coupling_kernel_at_ragged_batches(cuda, b, hw, ch):
    _coupling_agrees(cuda, b, hw, ch, "split/cross")


@pytest.mark.parametrize("layout", ["split/cross", "contiguous", "cross s"])
@pytest.mark.parametrize("hw,ch", [(5, 2), (4, 6), (3, 7), (2, 48), (1, 2)])
def test_coupling_kernel_at_odd_widths(cuda, hw, ch, layout):
    # 4-byte loads where C/2 is no multiple of 4 (or 2 at an odd H·W), or a
    # view's pointer is not 16-byte aligned
    _coupling_agrees(cuda, 3, hw, ch, layout)


def test_coupling_kernel_raises_on_other_layouts(cuda):
    x = torch.randn(2, 8, 8, 8, generator=cuda, device="cuda")
    with pytest.raises(ValueError, match="row stride"):
        coupling_transform(x[..., ::4], x[..., 1::4], x[..., 2::4])
    t = x[..., :4].transpose(1, 2)
    with pytest.raises(ValueError, match="row stride"):
        coupling_transform(t, t, t)


@pytest.mark.parametrize("b,hw,ch", [(2, 64, 4), (3, 48, 6)])
def test_coupling_kernel_loops_over_large_samples(cuda, b, hw, ch):
    # more groups of 4 values than a block has threads: each thread loops
    assert coupling_plan(b, hw * hw * ch).threads * 4 < hw * hw * ch
    _coupling_agrees(cuda, b, hw, ch, "split/cross")


def _randn(cuda, shape, offset=0, scale=1.0):
    """A contiguous tensor of N(0, scale²) that starts ``offset`` floats into
    its buffer (offset 1: not 16-byte aligned)."""
    t = scale * torch.randn(math.prod(shape) + offset, generator=cuda, device="cuda")
    return t[offset:].view(shape)


@pytest.mark.parametrize("b,h,w,hc,offset", [
    (8, 2, 2, 200, 0), (30, 2, 2, 200, 0),  # the request's and the train step's
    (1, 2, 2, 200, 0), (7, 2, 2, 200, 0), (33, 2, 2, 200, 0), (70, 2, 2, 200, 0),  # ragged
    (3, 4, 4, 24, 0), (5, 2, 3, 16, 0), (2, 1, 2, 600, 0),  # H≠W, three channel blocks
    (4, 3, 5, 6, 0), (6, 1, 4, 7, 0), (50, 3, 3, 7, 0),  # odd widths
    (8, 2, 2, 200, 1), (30, 2, 2, 200, 1), (7, 3, 2, 16, 1),  # inputs not 16-byte aligned
])
def test_gates_kernel_matches_plain(cuda, b, h, w, hc, offset):
    gates = _randn(cuda, (b, h, w, 4 * hc), offset)
    c = _randn(cuda, (b, h, w, hc), offset)
    peeps = [_randn(cuda, (1, h, w, hc), offset, 0.1) for _ in range(3)]
    assert all(t.data_ptr() % 16 == 4 * offset for t in (gates, c, *peeps))
    n = convlstm_gates.launches
    got = convlstm_gates(gates, c, *peeps)
    again = convlstm_gates(gates, c, *peeps)
    torch.cuda.synchronize()
    assert convlstm_gates.launches == n + 2
    for a, a2, r in zip(got, again, convlstm_gates_ref(gates, c, *peeps)):
        _close(a, r, 1e-5)
        assert torch.equal(a, a2)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("b", [8, 32, 13])
def test_gates_kernel_at_the_srnn_and_vrnn_shapes(cuda, b, offset):
    # h = 256 at 8x8 (SRNN's lstm_h and lstm_a, VRNN's lstm at 64x64 frames):
    # the request's B=8, the train step's B=32 and a ragged batch; one
    # channel block of 256 threads per position
    hc = 256
    gates = _randn(cuda, (b, 8, 8, 4 * hc), offset)
    c = _randn(cuda, (b, 8, 8, hc), offset)
    peeps = [_randn(cuda, (1, 8, 8, hc), offset, 0.1) for _ in range(3)]
    n = convlstm_gates.launches
    got = convlstm_gates(gates, c, *peeps)
    again = convlstm_gates(gates, c, *peeps)
    torch.cuda.synchronize()
    assert convlstm_gates.launches == n + 2
    for a, a2, r in zip(got, again, convlstm_gates_ref(gates, c, *peeps)):
        _close(a, r, 1e-5)
        assert torch.equal(a, a2)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("b", [8, 32, 7])
def test_gates_kernel_at_kth_and_bair_width(cuda, b, offset):
    # h = 256 at 4x4: the request's B=8 and the train step's B=32, two
    # channel blocks
    hc = 256
    gates = _randn(cuda, (b, 4, 4, 4 * hc), offset)
    c = _randn(cuda, (b, 4, 4, hc), offset)
    peeps = [_randn(cuda, (1, 4, 4, hc), offset, 0.1) for _ in range(3)]
    got = convlstm_gates(gates, c, *peeps)
    again = convlstm_gates(gates, c, *peeps)
    torch.cuda.synchronize()
    for a, a2, r in zip(got, again, convlstm_gates_ref(gates, c, *peeps)):
        _close(a, r, 1e-5)
        assert torch.equal(a, a2)


def test_gates_kernel_on_inputs_whose_exponentials_overflow(cuda):
    # |pre-activations| up to ~200: e^-v overflows to inf, 1 + e^-v passes
    # 2^126; sigmoid must give 0 (not NaN) and tanh ±1
    hc = 200
    gates = 50 * torch.randn(8, 2, 2, 4 * hc, generator=cuda, device="cuda")
    c = 50 * torch.randn(8, 2, 2, hc, generator=cuda, device="cuda")
    peeps = [0.1 * torch.randn(1, 2, 2, hc, generator=cuda, device="cuda") for _ in range(3)]
    got = convlstm_gates(gates, c, *peeps)
    torch.cuda.synchronize()
    for a, r in zip(got, convlstm_gates_ref(gates, c, *peeps)):
        assert torch.isfinite(a).all()
        _close(a, r, 1e-5)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("clamp", ["realnvp", "glow", "softclamp", "none"])
def test_glowchain_kernel_matches_plain(cuda, clamp, reverse):
    b, h, c, cc, u, k = 3, 8, 8, 6, 32, 3

    def n(*shape, scale=0.1):
        return scale * torch.randn(shape, generator=cuda, device="cuda")

    ps = GlowStepParams(
        an_bias=n(k, c), an_logs=n(k, c),
        w1x1=torch.eye(c, device="cuda").repeat(k, 1, 1) + n(k, c, c),
        wa=n(k, 9, c // 2 + cc, u), ana_bias=n(k, u), ana_logs=n(k, u),
        wb=n(k, u, u), anb_bias=n(k, u), anb_logs=n(k, u),
        wc=n(k, 9, u, c), bias_c=n(k, c),
        clamp_scale=1 + n(k, c // 2), clamp_shift=n(k, c // 2))
    x, cond = n(b, h, h, c, scale=1.0), n(b, h, h, cc, scale=1.0)
    y, ld = glowchain(x, cond, ps, clamp, reverse)
    torch.cuda.synchronize()
    y_ref, ld_ref = glowchain_ref(x, cond, ps, clamp, reverse)
    _close(y, y_ref, 1e-4)
    _close(ld, ld_ref, 1e-4)


def _step_inputs(cuda, b=3, h=8, c=8, cc=6, u=32, k=None):
    lead = () if k is None else (k,)

    def n(*shape, scale=0.1):
        return scale * torch.randn(lead + shape, generator=cuda, device="cuda")

    ps = GlowStepParams(
        an_bias=n(c), an_logs=n(c), w1x1=torch.eye(c, device="cuda") + n(c, c),
        wa=n(9, c // 2 + cc, u), ana_bias=n(u), ana_logs=n(u),
        wb=n(u, u), anb_bias=n(u), anb_logs=n(u), wc=n(9, u, c), bias_c=n(c),
        clamp_scale=1 + n(c // 2), clamp_shift=n(c // 2))
    x = torch.randn(b, h, h, c, generator=cuda, device="cuda")
    cond = torch.randn(b, h, h, cc, generator=cuda, device="cuda")
    return x, cond, ps


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("clamp", ["realnvp", "glow", "softclamp", "none"])
def test_glowstep_kernel_matches_plain(cuda, clamp, reverse):
    x, cond, ps = _step_inputs(cuda)
    n = glowstep.launches
    y, ld = glowstep(x, cond, ps, clamp, reverse)
    torch.cuda.synchronize()
    assert glowstep.launches == n + 1
    y_ref, ld_ref = glowstep_ref(x, cond, ps, clamp, reverse)
    _close(y, y_ref, 1e-4)
    _close(ld, ld_ref, 1e-4)


def _step_and_chain_agree(cuda, b, h, w, c, cc, u, k=2):
    """Both kernels against their plain versions at one shape, forward and
    reverse; the second launch must repeat the first bit for bit."""
    def n(*shape, scale):
        return scale * torch.randn(shape, generator=cuda, device="cuda")

    fan_a, fan_c = 9 * (c // 2 + cc), 9 * u
    ps = GlowStepParams(
        an_bias=n(k, c, scale=0.1), an_logs=n(k, c, scale=0.1),
        w1x1=torch.eye(c, device="cuda").repeat(k, 1, 1) + n(k, c, c, scale=0.3 / c),
        wa=n(k, 9, c // 2 + cc, u, scale=fan_a ** -0.5), ana_bias=n(k, u, scale=0.1),
        ana_logs=n(k, u, scale=0.1), wb=n(k, u, u, scale=u ** -0.5),
        anb_bias=n(k, u, scale=0.1), anb_logs=n(k, u, scale=0.1),
        wc=n(k, 9, u, c, scale=0.3 * fan_c ** -0.5), bias_c=n(k, c, scale=0.1),
        clamp_scale=1 + n(k, c // 2, scale=0.1), clamp_shift=n(k, c // 2, scale=0.1))
    x = torch.randn(b, h, w, c, generator=cuda, device="cuda")
    cond = torch.randn(b, h, w, cc, generator=cuda, device="cuda")
    p0 = GlowStepParams(*(t[0].contiguous() for t in ps))
    for reverse in (False, True):
        for kernel, ref, params in ((glowstep, glowstep_ref, p0),
                                    (glowchain, glowchain_ref, ps)):
            y, ld = kernel(x, cond, params, "realnvp", reverse)
            y2, ld2 = kernel(x, cond, params, "realnvp", reverse)
            torch.cuda.synchronize()
            y_ref, ld_ref = ref(x, cond, params, "realnvp", reverse)
            _close(y, y_ref, 1e-4)
            _close(ld, ld_ref, 1e-4)
            assert torch.equal(y, y2) and torch.equal(ld, ld2)


@pytest.mark.parametrize("b", [1, 7, 30, 33])
def test_glow_kernels_at_ragged_batches(cuda, b):
    # 4x4 maps: a cluster takes a tile of several samples, the last one ragged
    _step_and_chain_agree(cuda, b, 4, 4, 32, 128, 256)


@pytest.mark.parametrize("h,w,c,cc,u", [(4, 6, 6, 5, 20), (3, 5, 10, 7, 36),
                                        (2, 7, 2, 3, 5), (8, 4, 8, 6, 32)])
def test_glow_kernels_at_odd_shapes(cuda, h, w, c, cc, u):
    # H != W, and widths that are no multiples of 4: the 4-byte copies
    _step_and_chain_agree(cuda, 5, h, w, c, cc, u, k=3)


@pytest.mark.parametrize("b", [8, 30])
@pytest.mark.parametrize("hw,c,cc", [(16, 8, 32), (8, 16, 64), (4, 32, 128),
                                     (2, 64, 256)])
def test_glow_kernels_at_production_shapes(cuda, hw, c, cc, b):
    _step_and_chain_agree(cuda, b, hw, hw, c, cc, 256, k=10)


@pytest.mark.parametrize("b", [8, 32])
@pytest.mark.parametrize("hw,c,cc", [(4, 96, 384),  # rfn_bair scale 3
                                     (8, 16, 384), (4, 32, 384)])  # rfn_kth scales 2-3
def test_glow_kernels_at_kth_and_bair_shapes(cuda, hw, c, cc, b):
    _step_and_chain_agree(cuda, b, hw, hw, c, cc, 256, k=10)


# the standalone models: GlowImage (64x64 gray, L=3, U=128, cond 8; B=16
# sampled, 96 frames trained) at scales 1-2, cGlow (32x32 RGB, L=2, U=256,
# cond 32, B=16) at both scales
@pytest.mark.parametrize("b,hw,c,cc,u,k", [
    (16, 16, 8, 8, 128, 8), (96, 16, 8, 8, 128, 8), (16, 8, 16, 8, 128, 8),
    (96, 8, 16, 8, 128, 8), (16, 16, 12, 32, 256, 4), (16, 8, 24, 32, 256, 4)])
def test_glow_kernels_at_the_standalone_models_shapes(cuda, b, hw, c, cc, u, k):
    _step_and_chain_agree(cuda, b, hw, hw, c, cc, u, k=k)


@pytest.mark.parametrize("fixed", [dict(cluster_blocks=16), dict(ha_global=False),
                                   dict(ha_global=True, stages=2), dict(im=2),
                                   dict(batch_tile=2, cluster_blocks=4)])
def test_glow_kernels_under_other_launch_plans(cuda, fixed, monkeypatch):
    import functools
    import importlib

    module = importlib.import_module("recurrent_flows_tpu_torch.ops.glowstep")
    monkeypatch.setattr(module, "launch_plan",
                        functools.partial(module.launch_plan, **fixed))
    module._plan_ints.cache_clear()
    try:
        _step_and_chain_agree(cuda, 9, 8, 8, 16, 64, 256)
    finally:
        module._plan_ints.cache_clear()


def _ainv_agrees(cuda, rows, c, offset=0, orthogonal=False):
    """The kernel against its plain version on x [rows, c] (starting
    ``offset`` floats into its buffer), and a second launch bit for bit.
    W is N(0,1), or with ``orthogonal`` an orthogonal matrix, as the flow's
    1x1 is at init."""
    x = torch.randn(rows * c + offset, generator=cuda, device="cuda")[offset:].view(rows, c)
    bias, logs = (0.3 * torch.randn(c, generator=cuda, device="cuda") for _ in range(2))
    w = torch.randn(c, c, generator=cuda, device="cuda")
    if orthogonal:
        w = torch.linalg.qr(w)[0].contiguous()
    n = actnorm_invconv.launches
    y = actnorm_invconv(x, bias, logs, w)
    y2 = actnorm_invconv(x, bias, logs, w)
    torch.cuda.synchronize()
    assert actnorm_invconv.launches == n + 2
    _close(y, actnorm_invconv_ref(x, bias, logs, w), 1e-5)
    assert torch.equal(y, y2)


@pytest.mark.parametrize("rows,c", [(30 * 32 * 32, 4), (1000, 8), (120, 64), (7, 2)])
def test_actnorm_invconv_kernel_matches_plain(cuda, rows, c):
    _ainv_agrees(cuda, rows, c)
    # above 64 channels the tile design launches; a strided x is refused
    _ainv_agrees(cuda, 4, 66)
    x = torch.zeros(4, 2 * c, device="cuda")[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        actnorm_invconv(x, torch.zeros(c, device="cuda"), torch.zeros(c, device="cuda"),
                        torch.zeros(c, c, device="cuda"))


# x [B·H·W, C] above 64 channels: rfn_bair's scale 3 at the train step
# (32·4·4 rows of 96) and the request (8·4·4), then 128 (gray, L = 6),
# 192 (RGB at L = 5: main_rfn --choose_data bair at its defaults, whose
# step at B=32 gives 32·2·2 = 128 rows of 192) and 256 (gray at L = 7);
# then widths no flow width is: 100 and 160 (the run-time-width instance
# with bulk copies, 100 with zeroed channels past C), 300, 384 (RGB at
# L = 6) and 1024 (two stage buffers taking turns, 300 with a short last
# stage); ragged row counts, and x one or two floats into its buffer (not
# 16-byte aligned: 4-byte loads). W is orthogonal, as the flow's: with an N(0,1) W
# of 256 columns the outputs' partial sums reach ~16, and float32 sums in
# two orders (the kernel's, cuBLAS's) differ by ~1.6e-5 at outputs near 0
# (measured on the H100), past 1e-5·(1+|ref|)
@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("rows", [32 * 16, 8 * 16, 131, 7, 1])
@pytest.mark.parametrize("c", [96, 128, 192, 256, 100, 160, 300, 384, 1024])
def test_actnorm_invconv_kernel_above_64_channels(cuda, c, rows, offset):
    # every width above 64 takes the tile design, aligned or not, but 96 with
    # aligned pointers at little work: the compile-time instance
    small = c == 96 and offset == 0 and rows * c * c <= AINV_REGISTER_WORK
    assert ainv_plan(rows, c, aligned=offset == 0).vec == (1 if small else 2)
    _ainv_agrees(cuda, rows, c, offset, orthogonal=True)


# x [32·H·W, C] at rfn_bair's four scales (the train step: the tile design
# from 24), the BAIR CLI step's 2x2x192 (B=32), the request's 4x4x96 and
# 16x16x24 (B=8: the compile-time instance), ragged row counts, and x one
# float into its buffer (the run-time-width instance up to 64)
@pytest.mark.parametrize("rows,c,offset,vec", [
    (32 * 1024, 12, 0, 1), (32 * 256, 24, 0, 2), (32 * 64, 48, 0, 2), (32 * 16, 96, 0, 2),
    (32 * 4, 192, 0, 2), (8 * 16, 96, 0, 1), (8 * 256, 24, 0, 1),
    (7, 12, 0, 1), (131, 24, 0, 1), (1, 48, 0, 1), (33, 96, 0, 1), (8 * 256, 24, 1, 0),
    (8 * 64, 48, 1, 0)])
def test_actnorm_invconv_kernel_at_rgb_widths(cuda, rows, c, offset, vec):
    assert ainv_plan(rows, c, aligned=offset == 0).vec == vec
    _ainv_agrees(cuda, rows, c, offset, orthogonal=c > 64)


# x [30·H·W, C] at the five scales of the train step, and ragged row counts
@pytest.mark.parametrize("rows,c", [(30 * 1024, 4), (30 * 256, 8), (30 * 64, 16),
                                    (30 * 16, 32), (30 * 4, 64), (33 * 16, 32),
                                    (7 * 4, 64), (1, 4), (131, 16)])
def test_actnorm_invconv_kernel_at_production_and_ragged_shapes(cuda, rows, c):
    _ainv_agrees(cuda, rows, c)


# x [B·H·W, C] of the standalone models' module-path steps: GlowImage's
# three scales at 96 frames, cGlow's two at B=16
@pytest.mark.parametrize("rows,c", [(96 * 1024, 4), (96 * 256, 8), (96 * 64, 16),
                                    (16 * 256, 12), (16 * 64, 24)])
def test_actnorm_invconv_kernel_at_the_standalone_models_shapes(cuda, rows, c):
    _ainv_agrees(cuda, rows, c)


@pytest.mark.parametrize("rows,c", [(50, 2), (50, 6), (50, 7), (50, 48), (1, 1)])
def test_actnorm_invconv_kernel_at_odd_widths(cuda, rows, c):
    _ainv_agrees(cuda, rows, c)


@pytest.mark.parametrize("c", [4, 16, 64])
def test_actnorm_invconv_kernel_on_unaligned_rows(cuda, c):
    # x one float into its buffer: the run-time-width instance
    assert ainv_plan(30, c, aligned=False).vec == 0
    _ainv_agrees(cuda, 30, c, offset=1)


def _grads_match(fn, ref, inputs, tol=1e-4):
    """Gradients of a random projection of every output, through the
    kernel operator's registered backward and through autograd of the plain
    version."""
    def run(f):
        ins = [t.detach().clone().requires_grad_(True) for t in inputs]
        outs = f(ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        g = torch.Generator(device="cuda").manual_seed(7)
        loss = sum((o * torch.randn(o.shape, generator=g, device="cuda")).sum()
                   for o in outs)
        return torch.autograd.grad(loss, ins)

    for got, want in zip(run(fn), run(ref)):
        _close(got, want, tol)


@pytest.mark.parametrize("reverse", [False, True])
def test_coupling_function_gradients(cuda, reverse):
    ins = [0.5 * torch.randn(3, 16, 16, 4, generator=cuda, device="cuda") for _ in range(3)]
    _grads_match(lambda i: coupling_transform(*i, reverse),
                 lambda i: coupling_transform_ref(*i, reverse), ins)


@pytest.mark.parametrize("reverse", [False, True])
def test_coupling_function_gradients_through_strided_views(cuda, reverse):
    # x and the net's output h as leaves; the kernel reads their halves
    x = torch.randn(3, 16, 16, 8, generator=cuda, device="cuda")
    h = 0.5 * torch.randn(3, 16, 16, 8, generator=cuda, device="cuda")

    def run(f):
        return lambda i: f(i[0][..., 4:], i[1][..., 0::2], torch.tanh(i[1][..., 1::2]), reverse)

    _grads_match(run(coupling_transform), run(coupling_transform_ref), [x, h])


def test_gates_function_gradients(cuda):
    hc = 24
    ins = [torch.randn(3, 4, 4, 4 * hc, generator=cuda, device="cuda"),
           torch.randn(3, 4, 4, hc, generator=cuda, device="cuda")]
    ins += [0.1 * torch.randn(1, 4, 4, hc, generator=cuda, device="cuda") for _ in range(3)]
    _grads_match(lambda i: convlstm_gates(*i), lambda i: convlstm_gates_ref(*i), ins)


def test_actnorm_invconv_function_gradients(cuda):
    _ainv_grads(cuda, 16)


@pytest.mark.parametrize("c", [96, 128, 192, 256])
def test_actnorm_invconv_function_gradients_above_64_channels(cuda, c):
    _ainv_grads(cuda, c)


def _ainv_grads(cuda, c):
    ins = [torch.randn(5, 8, 8, c, generator=cuda, device="cuda"),
           0.3 * torch.randn(c, generator=cuda, device="cuda"),
           0.3 * torch.randn(c, generator=cuda, device="cuda"),
           torch.randn(c, c, generator=cuda, device="cuda")]
    _grads_match(lambda i: actnorm_invconv(*i), lambda i: actnorm_invconv_ref(*i), ins)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kernel,ref,k", [(glowstep, glowstep_ref, None),
                                          (glowchain, glowchain_ref, 3)],
                         ids=["glowstep", "glowchain"])
def test_glowstep_and_chain_function_gradients(cuda, kernel, ref, k, reverse):
    x, cond, ps = _step_inputs(cuda, k=k)
    _grads_match(lambda i: kernel(i[0], i[1], GlowStepParams(*i[2:]), "realnvp", reverse),
                 lambda i: ref(i[0], i[1], GlowStepParams(*i[2:]), "realnvp", reverse),
                 [x, cond, *ps])


# The three pointwise kernels at the local shapes a rank of chip_smoke.py's
# 1x2 (data x model) grid gives them (phase 17): half the rows of each map
# of rfn_mnist_production's B=30 step; the gates on the 2x2 latent's one
# row, the coupling's z2 and the folded 1x1's x on each flow scale's
# [30, hw/2, hw, C] rows.
@pytest.mark.parametrize("offset", [0, 1])
def test_gates_kernel_at_the_grid_shapes(cuda, offset):
    gates = _randn(cuda, (30, 1, 2, 800), offset)
    c = _randn(cuda, (30, 1, 2, 200), offset)
    peeps = [_randn(cuda, (1, 1, 2, 200), offset, 0.1) for _ in range(3)]
    got = convlstm_gates(gates, c, *peeps)
    again = convlstm_gates(gates, c, *peeps)
    torch.cuda.synchronize()
    for a, a2, r in zip(got, again, convlstm_gates_ref(gates, c, *peeps)):
        _close(a, r, 1e-5)
        assert torch.equal(a, a2)


def _grid_coupling_views(cuda, b, h, w, ch):
    """The 'split' half of x and the 'cross' halves of the net's output,
    [b, h, w, ch] each, as AffineCoupling gives them on a rank's rows."""
    x = torch.randn(b, h, w, 2 * ch, generator=cuda, device="cuda")
    net = 0.5 * torch.randn(b, h, w, 2 * ch, generator=cuda, device="cuda")
    return x[..., ch:], net[..., 0::2], torch.tanh(net[..., 1::2])


@pytest.mark.parametrize("level", range(5))
def test_coupling_and_folded_1x1_kernels_at_the_grid_shapes(cuda, level):
    hw, c = 32 >> level, 4 << level
    z2, shift, s = _grid_coupling_views(cuda, 30, hw // 2, hw, c // 2)
    for reverse in (False, True):
        out, ld = coupling_transform(z2, shift, s, reverse)
        out2, ld2 = coupling_transform(z2, shift, s, reverse)
        torch.cuda.synchronize()
        ref_out, ref_ld = coupling_transform_ref(z2, shift, s, reverse)
        _close(out, ref_out, 1e-5)
        _close(ld, ref_ld, 1e-4)
        assert torch.equal(out, out2) and torch.equal(ld, ld2)
    _ainv_agrees(cuda, 30 * (hw // 2) * hw, c, orthogonal=True)


def test_coupling_net_runs_without_layout_transposes(cuda):
    """One scale-1 coupling of rfn_mnist_production (x [8, 32, 32, 4], 16
    condition channels, U=256), forward and backward, profiled: the net runs
    channel-major, so cuDNN runs none of its NHWC<->NCHW transposes."""
    from torch.profiler import ProfilerActivity, profile

    from recurrent_flows_tpu_torch.flows.modules import AffineCoupling
    from recurrent_flows_tpu_torch.utils.profiling import TRANSPOSE_KERNELS

    m = AffineCoupling(4, 16, 256, device="cuda", generator=cuda)
    x = torch.randn(8, 32, 32, 4, generator=cuda, device="cuda", requires_grad=True)
    cond = torch.randn(8, 32, 32, 16, generator=cuda, device="cuda", requires_grad=True)

    def step():
        y, ld = m(x, cond, torch.zeros(8, device="cuda"))
        (y.square().sum() + ld.sum()).backward()

    step()  # cuDNN's plans and the coupling kernel's build
    torch.cuda.synchronize()
    runs = AffineCoupling.channel_major_runs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    assert AffineCoupling.channel_major_runs == runs + 1
    kernels = [ev.name() for ev in prof.profiler.kineto_results.events()
               if str(ev.device_type()).endswith("CUDA") and not ev.is_user_annotation()]
    assert any("coupling_kernel" in k for k in kernels), kernels  # the trace holds kernels
    assert not [k for k in kernels if any(t in k for t in TRANSPOSE_KERNELS)], kernels
