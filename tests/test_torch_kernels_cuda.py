"""Each kernel of the port against its plain version on an NVIDIA GPU.

Marked ``cuda``: they need a CUDA device with nvcc and triton, and skip
where there is none. On the card the same comparisons, at the serving
path's full shapes, run in ``python3 chip_smoke.py``.

Tolerances as in chip_smoke.py, each element within tol·(1+|ref|): 1e-5 for
the elementwise kernels, 1e-4 for the chain after K steps of three convs
each. The plain side runs with TF32 off.
"""

import pytest
import torch

from recurrent_flows_tpu_torch.ops import (
    GlowStepParams,
    convlstm_gates,
    convlstm_gates_ref,
    coupling_transform,
    coupling_transform_ref,
    glowchain,
    glowchain_ref,
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
