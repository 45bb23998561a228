"""The flow's coupling net channel-major (``flows.modules.AffineCoupling``
off a grid) against the NHWC path it takes on a grid, on the same weights,
on the CPU; and the counter of the two paths.

The NHWC path is reached as on a grid of one rank: ``flows.modules``' view
of the running grid is replaced by one whose log-determinant share is the
sum itself, so the net is the only thing that changes. Each case compares
the forward and the reverse, their logdets, the gradient of every leaf
(parameters, x, condition) and, with ``ddi``, the ActNorm parameters the
pass sets. float32 on both sides; the convolutions' sums may run in
another order in the two layouts, so values are held to 1e-5·(1+|ref|) and
gradients to 1e-5·|ref| plus 1e-5 of the largest |ref| of all leaves (as
``test_torch_mesh.py`` holds them): a conv bias ahead of a batch norm has a
gradient that is zero but for rounding.
"""

import copy

import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from recurrent_flows_tpu_torch.config import GlowConfig
from recurrent_flows_tpu_torch.flows import ListGlow, modules
from recurrent_flows_tpu_torch.flows.modules import AffineCoupling
from recurrent_flows_tpu_torch.utils import NoiseSource

# (B, H, W, C, condition channels): the five scales of rfn_mnist_production
# (x squeezed to 32x32x4 .. 2x2x64, the upscaler's 16 .. 256 channels), and
# an odd height and width
SHAPES = [(2, 32, 32, 4, 16), (2, 16, 16, 8, 32), (2, 8, 8, 16, 64), (2, 4, 4, 32, 128),
          (2, 2, 2, 64, 256), (3, 5, 7, 6, 3)]
HIDDEN = 24


class _OneRankGrid:
    """A grid of one rank, as ``flows.modules`` sees it: the coupling net
    takes its NHWC path, and the share of a log-determinant is all of it."""

    @staticmethod
    def share(v, like):
        return v

    @staticmethod
    def sharded(x):
        return False


def _coupling(c, cc, norm, clamp_type="realnvp"):
    gen = torch.Generator().manual_seed(c + cc)
    m = AffineCoupling(c, cc, HIDDEN, "relu", clamp_type, norm, generator=gen)
    with torch.no_grad():  # every leaf off its init (net2 and the clamp start at 0)
        for p in m.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return m


def _inputs(b, h, w, c, cc, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=gen).requires_grad_(True)
    cond = torch.randn(b, h, w, cc, generator=gen).requires_grad_(True)
    return x, cond


def _run(m, x, cond, reverse, nhwc, monkeypatch):
    """(y, logdet, {leaf: gradient}) of one direction through ``m``."""
    with monkeypatch.context() as mp:
        if nhwc:
            mp.setattr(modules, "grid", lambda: _OneRankGrid)
        if reverse:
            y, ld = m.reverse(x, cond)
        else:
            y, ld = m(x, cond, torch.zeros(x.shape[0]))
    gen = torch.Generator().manual_seed(1)
    loss = (y * torch.randn(y.shape, generator=gen)).sum() + (ld * torch.randn(
        ld.shape, generator=gen)).sum()
    leaves = dict(m.named_parameters(), x=x, cond=cond)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return y, ld, dict(zip(leaves, grads))


def _close(got, ref, msg):
    assert ((got - ref).abs() <= 1e-5 * (1 + ref.abs())).all(), (
        msg, (got - ref).abs().max().item())


def _grads_close(got, ref):
    assert got.keys() == ref.keys()
    g_max = max(g.abs().max() for g in ref.values())
    for name, g in ref.items():
        err = (got[name] - g).abs() - 1e-5 * g.abs()
        assert (err <= 1e-5 * g_max).all(), (name, err.max().item())


@pytest.mark.parametrize("norm", ["actnorm", "batchnorm", "none"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_channel_major_net_equals_the_nhwc_net(shape, norm, monkeypatch):
    b, h, w, c, cc = shape
    m = _coupling(c, cc, norm)
    x, cond = _inputs(b, h, w, c, cc)
    for reverse in (False, True):
        y, ld, grads = _run(m, x, cond, reverse, False, monkeypatch)
        y_ref, ld_ref, grads_ref = _run(m, x, cond, reverse, True, monkeypatch)
        _close(y, y_ref, f"y reverse={reverse}")
        _close(ld, ld_ref, f"logdet reverse={reverse}")
        _grads_close(grads, grads_ref)


@pytest.mark.parametrize("norm", ["actnorm", "batchnorm", "none"])
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[-1]], ids=["32x32x4", "odd"])
def test_channel_major_ddi_pass_equals_the_nhwc_one(shape, norm, monkeypatch):
    """The data-dependent-init pass sets the same ActNorm parameters and
    gives the same output both ways."""
    b, h, w, c, cc = shape
    m = _coupling(c, cc, norm)
    m_ref = copy.deepcopy(m)
    x, cond = _inputs(b, h, w, c, cc, seed=2)
    with torch.no_grad():
        y, ld = m(x, cond, torch.zeros(b), ddi=True)
        with monkeypatch.context() as mp:
            mp.setattr(modules, "grid", lambda: _OneRankGrid)
            y_ref, ld_ref = m_ref(x, cond, torch.zeros(b), ddi=True)
    _close(y, y_ref, "y")
    _close(ld, ld_ref, "logdet")
    ref = dict(m_ref.named_parameters())
    for name, p in m.named_parameters():
        _close(p, ref[name], name)
    if norm == "actnorm":  # the pass moved them
        assert not torch.equal(m.net0.actnorm.logs, torch.zeros(HIDDEN))


class _ConvInputs(TorchFunctionMode):
    """Records, for every ``F.conv2d`` call, whether its input is a
    contiguous NCHW tensor."""

    def __init__(self):
        super().__init__()
        self.contiguous = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is F.conv2d:
            self.contiguous.append(args[0].is_contiguous())
        return func(*args, **(kwargs or {}))


def test_channel_major_net_hands_contiguous_nchw_maps_to_the_convs(monkeypatch):
    m = _coupling(4, 16, "actnorm")
    x, cond = _inputs(2, 8, 8, 4, 16)
    with _ConvInputs() as seen:
        m(x, cond, torch.zeros(2))
    assert seen.contiguous == [True] * 3
    with _ConvInputs() as seen, monkeypatch.context() as mp:
        mp.setattr(modules, "grid", lambda: _OneRankGrid)
        m(x, cond, torch.zeros(2))
    # a grid's NHWC net: the NCHW views of channels-last memory
    assert seen.contiguous == [False] * 3


def _production_flow(chain_impl="sample"):
    """rfn_mnist_production's flow: 64x64x1 frames, L=5, K=10, U=256, the
    upscaler's 16 .. 256 condition channels, the base prior's 256."""
    cfg = GlowConfig(L=5, K=10, n_units_affine=256, n_units_prior=512, flow_norm="actnorm",
                     clamp_type="realnvp", chain_impl=chain_impl)
    return ListGlow(1, 64, cfg, [16, 32, 64, 128, 256], 256,
                    generator=torch.Generator().manual_seed(0))


def _runs():
    return AffineCoupling.channel_major_runs, AffineCoupling.nhwc_runs


@torch.no_grad()
def test_counter_at_the_production_shapes():
    """50 nets channel-major per ``f`` (every scale on the module path) and
    10 per ``g`` (scale 1; the chain kernel takes scales 2-5), none NHWC;
    the recorded condition is made channel-major once per scale."""
    flow = _production_flow()
    gen = torch.Generator().manual_seed(3)
    conds = [torch.randn(1, 64 >> (l + 1), 64 >> (l + 1), c, generator=gen)
             for l, c in enumerate([16, 32, 64, 128, 256])]
    base = torch.randn(1, 2, 2, 256, generator=gen)
    noise = NoiseSource(generator=torch.Generator().manual_seed(4))
    before = _runs()
    flow.log_prob(torch.rand(1, 64, 64, 1, generator=gen), conds, base, noise)
    after_f = _runs()
    assert (after_f[0] - before[0], after_f[1] - before[1]) == (50, 0)
    flow.sample(conds, base, noise)
    after_g = _runs()
    assert (after_g[0] - after_f[0], after_g[1] - after_f[1]) == (10, 0)
    copies = []
    real = modules.to_channel_major

    def counted(x):
        copies.append(tuple(x.shape))
        return real(x)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("recurrent_flows_tpu_torch.flows.glow.to_channel_major", counted)
        flow.log_prob(torch.rand(1, 64, 64, 1, generator=gen), conds, base, noise)
    assert copies == [tuple(cnd.shape) for cnd in conds]


@torch.no_grad()
def test_fused_steps_take_no_channel_major_condition():
    """With ``coupling_impl='fused'`` the kernel's scales make no copy of
    the condition, but for the DDI pass, which takes the module path; a
    scale the kernel does not take (32x32) does."""
    cfg = GlowConfig(L=2, K=2, n_units_affine=16, n_units_prior=16, coupling_impl="fused")
    flow = ListGlow(1, 64, cfg, [4, 8], 8, generator=torch.Generator().manual_seed(0))
    x32, x16 = torch.zeros(2, 32, 32, 4), torch.zeros(2, 16, 16, 8)
    c32, c16 = torch.zeros(2, 32, 32, 4), torch.arange(2 * 16 * 16 * 8.0).reshape(2, 16, 16, 8)
    assert flow.coupling_condition(1, x16, c16) is None
    assert torch.equal(flow.coupling_condition(1, x16, c16, ddi=True),
                       c16.permute(0, 3, 1, 2))
    assert flow.coupling_condition(0, x32, c32).is_contiguous()
