"""Each kernel of the port against its plain version on an NVIDIA GPU.

Marked ``cuda``: they need a CUDA device with nvcc and triton, and skip
where there is none. On the card the same comparisons, at the serving
path's full shapes, run in ``python3 chip_smoke.py``.

Tolerances as in chip_smoke.py, each element within tol·(1+|ref|): 1e-5 for
the elementwise kernels and the folded 1x1, 1e-4 for one GlowStep and for
the chain after K steps of three convs each; two launches of a GlowStep
kernel on the same inputs must agree bit for bit. Each autograd Function's
gradients are held to autograd through the plain version, 1e-4 of
1+|ref| (the forward values they start from differ by the kernel's
rounding). The plain side runs with TF32 off.
"""

import pytest
import torch

from recurrent_flows_tpu_torch.ops import (
    GlowStepParams,
    actnorm_invconv,
    actnorm_invconv_ref,
    convlstm_gates,
    convlstm_gates_ref,
    coupling_transform,
    coupling_transform_ref,
    glowchain,
    glowchain_ref,
    glowstep,
    glowstep_ref,
)
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


def test_gates_kernel_matches_plain(cuda):
    hc = 24
    gates = torch.randn(3, 4, 4, 4 * hc, generator=cuda, device="cuda")
    c = torch.randn(3, 4, 4, hc, generator=cuda, device="cuda")
    peeps = [0.1 * torch.randn(1, 4, 4, hc, generator=cuda, device="cuda")
             for _ in range(3)]
    got = convlstm_gates(gates, c, *peeps)
    torch.cuda.synchronize()
    for a, b in zip(got, convlstm_gates_ref(gates, c, *peeps)):
        _close(a, b, 1e-5)


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


@pytest.mark.parametrize("rows,c", [(30 * 32 * 32, 4), (1000, 8), (120, 64), (7, 2)])
def test_actnorm_invconv_kernel_matches_plain(cuda, rows, c):
    x = torch.randn(rows, c, generator=cuda, device="cuda")
    bias, logs = (0.3 * torch.randn(c, generator=cuda, device="cuda") for _ in range(2))
    w = torch.randn(c, c, generator=cuda, device="cuda")
    n = actnorm_invconv.launches
    y = actnorm_invconv(x, bias, logs, w)
    torch.cuda.synchronize()
    assert actnorm_invconv.launches == n + 1
    _close(y, actnorm_invconv_ref(x, bias, logs, w), 1e-5)
    with pytest.raises(ValueError, match="at most"):
        actnorm_invconv(torch.zeros(4, 66, device="cuda"), torch.zeros(66, device="cuda"),
                        torch.zeros(66, device="cuda"), torch.zeros(66, 66, device="cuda"))


def _grads_match(fn, ref, inputs, tol=1e-4):
    """Gradients of a random projection of every output, through the
    kernel's autograd Function and through autograd of the plain version."""
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


def test_gates_function_gradients(cuda):
    hc = 24
    ins = [torch.randn(3, 4, 4, 4 * hc, generator=cuda, device="cuda"),
           torch.randn(3, 4, 4, hc, generator=cuda, device="cuda")]
    ins += [0.1 * torch.randn(1, 4, 4, hc, generator=cuda, device="cuda") for _ in range(3)]
    _grads_match(lambda i: convlstm_gates(*i), lambda i: convlstm_gates_ref(*i), ins)


def test_actnorm_invconv_function_gradients(cuda):
    c = 16
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
