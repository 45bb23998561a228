"""The port's modules against their JAX counterparts, on converted weights
(a JAX init perturbed off its zero inits) and the same numpy inputs.

Tolerances (float32 on both sides, JAX at matmul precision 'highest'):
the two frameworks sum convolutions in another order, so single modules
agree to ~1e-6 relative; atol 1e-5 covers outputs of order 1-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from recurrent_flows_tpu.flows import modules as jmod
from recurrent_flows_tpu.nn import convlstm as jlstm
from recurrent_flows_tpu.nn import layers as jlayers
from recurrent_flows_tpu.nn import vgg as jvgg
from recurrent_flows_tpu.utils import numerics as jnum
from recurrent_flows_tpu_torch.flows import modules as tmod
from recurrent_flows_tpu_torch.nn import convlstm as tlstm
from recurrent_flows_tpu_torch.nn import layers as tlayers
from recurrent_flows_tpu_torch.nn import vgg as tvgg
from recurrent_flows_tpu_torch.utils import NoiseSource
from recurrent_flows_tpu_torch.utils import numerics as tnum

B = 2
RTOL, ATOL = 1e-5, 1e-5


def _x(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _init(module, *args, seed=0):
    v = jax.jit(module.init)(jax.random.key(seed), *args)
    out = {"params": U.perturb(v["params"], seed + 100)}
    if "consts" in v:
        out["consts"] = v["consts"]
    return out


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def test_numerics_match_jax():
    x = _x(B, 8, 8, 12)
    t = torch.tensor(x)
    assert np.array_equal(tnum.squeeze2d(t).numpy(), np.asarray(jnum.squeeze2d(x)))
    sq = np.asarray(jnum.squeeze2d(x))
    assert np.array_equal(tnum.unsqueeze2d(torch.tensor(sq)).numpy(), x)
    for kind in ("split", "cross"):
        for a, b in zip(tnum.split_feature(t, kind), jnum.split_feature(x, kind)):
            assert np.array_equal(a.numpy(), np.asarray(b))
    _close(tnum.batch_reduce(t), jnum.batch_reduce(x))
    with pytest.raises(ValueError):
        tnum.split_feature(t, "zigzag")


@pytest.mark.parametrize("clamp", ["realnvp", "glow", "softclamp", "none"])
def test_affine_coupling_reverse_matches_jax(clamp):
    c, cc, u = 4, 5, 16
    x, cond = _x(B, 32, 32, c, seed=1), _x(B, 32, 32, cc, seed=2)
    jm = jmod.AffineCoupling(c, hidden_units=u, clamp_type=clamp)
    v = _init(jm, x, cond)
    ref, ref_ld = jax.jit(lambda v, x, c: jm.apply(v, x, c, jnp.zeros(B), reverse=True))(
        v, x, cond)
    tm = U.port_from(tmod.AffineCoupling(c, cc, u, clamp_type=clamp), v)
    got, ld = tm.reverse(torch.tensor(x), torch.tensor(cond))
    _close(got, ref)
    _close(-ld, ref_ld, atol=1e-4)  # a sum of B·32·32·2 terms


def test_split2d_reverse_matches_jax():
    c, cc = 8, 6
    z1, cond = _x(B, 16, 16, c // 2, seed=3), _x(B, 16, 16, cc, seed=4)
    jm = jmod.Split2d(c)
    v = _init(jm, _x(B, 16, 16, c, seed=5), cond)
    key = jax.random.key(9)
    ref, _ = jm.apply(v, z1, cond, None, reverse=True, rng=key, temperature=0.7)
    eps = np.asarray(jax.random.normal(key, (B, 16, 16, c // 2)))
    tm = U.port_from(tmod.Split2d(c, cc), v)
    got = tm.reverse(torch.tensor(z1), torch.tensor(cond),
                     NoiseSource(replay=[eps]), temperature=0.7)
    _close(got, ref)


def test_convlstm_cell_and_scan_match_jax():
    cin, hc, hw = 6, 8, 4
    xs = _x(3, B, hw, hw, cin, seed=6)
    h0, c0 = _x(B, hw, hw, hc, seed=7), _x(B, hw, hw, hc, seed=8)
    jm = jlstm.ConvLSTMCell(hc)
    v = _init(jm, xs[0], h0, c0)
    tm = U.port_from(tlstm.ConvLSTMCell(cin, hc, (hw, hw)), v)
    for a, b in zip(tm(*(torch.tensor(a) for a in (xs[0], h0, c0))),
                    jm.apply(v, xs[0], h0, c0)):
        _close(a, b)
    cell = lambda x, h, c: jm.apply(v, x, h, c)
    for reverse in (False, True):
        ref = jlstm.conv_lstm_scan(cell, xs, h0, c0, reverse=reverse)
        got = tlstm.conv_lstm_scan(tm, *(torch.tensor(a) for a in (xs, h0, c0)),
                                   reverse=reverse)
        for a, b in zip(got, ref):
            _close(a, b)


@pytest.mark.parametrize("norm", ["batchnorm", "instancenorm", "none"])
def test_simple_param_net_matches_jax(norm):
    struct = (8, "pool", "conv", 6)
    x = _x(B, 16, 16, 5, seed=10)
    jm = jlayers.SimpleParamNet(struct, 3, norm_type=norm)
    v = _init(jm, x)
    tm = U.port_from(tlayers.SimpleParamNet(struct, 5, 3, norm_type=norm), v)
    for a, b in zip(tm(torch.tensor(x)), jax.jit(jm.apply)(v, x)):
        _close(a, b)


EXT = ((4, "pool", 8), (8, "conv"), (8, "pool", 16))
UP = ((16,), ("upsample", 8), ("upsample", 8, 4))


@pytest.fixture(scope="module")
def vgg_vars():
    """One init for both tanh settings: ``tanh`` changes no parameter."""
    x, hz = _x(B, 32, 32, 1, seed=11), _x(B, 4, 4, 6, seed=12)
    vd = _init(jvgg.VGGDownscaler(EXT, skip_con=True), x)
    skips = jax.jit(jvgg.VGGDownscaler(EXT, skip_con=True).apply)(vd, x)
    vu = _init(jvgg.VGGUpscaler(UP, skips=True), hz, skips)
    return x, hz, vd, vu


@pytest.mark.parametrize("tanh", [False, True])
def test_vgg_downscaler_and_upscaler_match_jax(vgg_vars, tanh):
    x, hz, vd, vu = vgg_vars
    ref_feats = jax.jit(jvgg.VGGDownscaler(EXT, skip_con=True, tanh=tanh).apply)(vd, x)
    td = U.port_from(tvgg.VGGDownscaler(EXT, 1, skip_con=True, tanh=tanh), vd)
    feats = td(torch.tensor(x))
    for a, b in zip(feats, ref_feats):
        _close(a, b)
    sizes = tvgg.downscaler_layer_sizes(EXT, 1, 32)
    assert [tuple(f.shape[1:]) for f in feats] == [tuple(s) for s in sizes]
    skips = [np.asarray(f) for f in ref_feats]
    ju = jvgg.VGGUpscaler(UP, skips=True, tanh=tanh)
    tu = U.port_from(tvgg.VGGUpscaler(UP, 6, [s[2] for s in sizes], tanh=tanh), vu)
    outs = tu(torch.tensor(hz), [torch.tensor(s) for s in skips])
    for a, b in zip(outs, jax.jit(ju.apply)(vu, hz, skips)):
        _close(a, b)
    assert [o.shape[-1] for o in outs] == [4, 8, 16]  # high-res first


def test_vgg_unported_ops_raise():
    # 'squeeze' and 'deconv' are ported (test_torch_vgg_ops.py); an up-op in
    # the extractor and two up-ops in one upscaler block have no meaning in
    # either package
    with pytest.raises(ValueError):
        tvgg.VGGDownscaler(((4, "deconv"),), 1)
    with pytest.raises(ValueError, match="one up-op"):
        tvgg.VGGUpscaler(((8,), ("deconv", "squeeze", 4)), 6)
