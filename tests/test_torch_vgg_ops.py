"""The VGG DSL ops 'squeeze' (extractor and upscaler) and 'deconv'
(upscaler) against ``recurrent_flows_tpu.nn.vgg`` on the CPU, then a tiny
RFN built with them: ``loss`` (pieces and gradients) and ``predict``
against the JAX RFN, on converted weights with JAX's draws replayed.

The extractor's 'squeeze' is space-to-depth + norm + activation with no
conv (``downscaler_layer_sizes``: h/2, 4c); the upscaler's 'deconv' is a
bias-free transposed conv k4 s2 to c/scale + ``b{l}_up_norm`` +
activation, its 'squeeze' depth-to-space + norm + activation; RFN takes
the flow's condition channels from ``VGGUpscaler.out_channels``.

Sizes: 32x32 gray, L=3, B=2, T=3 (the RFN: K=1, 2 context and 2 predicted
frames). Tolerances: module outputs 1e-5·(1+|ref|); the loss pieces
1e-4·(1+|ref|); gradients 1e-4 of each tensor's largest |entry|; the
rollout 2e-4·(1+|ref|) (two predicted frames through the flow each,
as ``test_torch_rfn.py`` holds it)."""

import jax
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from torch_parity_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
from recurrent_flows_tpu.nn import vgg as jvgg
from recurrent_flows_tpu_torch.models import RFN
from recurrent_flows_tpu_torch.nn import vgg as tvgg
from recurrent_flows_tpu_torch.utils import NoiseSource

B, T, IMG = 2, 3, 32
EXT = ((4, "squeeze", 8), (8, "pool", 8), (8, "squeeze"))
UPS = {"deconv": ((16,), ("deconv", 8), ("upsample", 8, 4)),
       "both": ((16,), ("deconv", 8), ("squeeze", 8))}


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _init(module, *args):
    return {k: U.perturb(t, 0) if k == "params" else t
            for k, t in jax.jit(module.init)(jax.random.key(0), *args).items()}


@pytest.mark.parametrize("up,norm", [("both", "batchnorm"), ("deconv", "none")])
def test_downscaler_and_upscaler_ops_match_jax(norm, up):
    x = _x(B, IMG, IMG, 1)
    jd = jvgg.VGGDownscaler(EXT, norm_type=norm, skip_con=True)
    vd = _init(jd, x)
    ref = jax.jit(jd.apply)(vd, x)
    td = U.port_from(tvgg.VGGDownscaler(EXT, 1, norm_type=norm, skip_con=True, device="cpu"),
                     vd)
    feats = td(torch.tensor(x))
    sizes = tvgg.downscaler_layer_sizes(EXT, 1, IMG)
    assert sizes == jvgg.downscaler_layer_sizes(EXT, 1, IMG) == [(16, 16, 8), (8, 8, 8), (4, 4, 32)]
    for a, r, s in zip(feats, ref, sizes):
        assert tuple(a.shape[1:]) == s
        U.assert_close_rel(a.detach(), r, 1e-5, "downscaler")
    hz = _x(B, 8, 8, 6, seed=1)
    ju = jvgg.VGGUpscaler(UPS[up], norm_type=norm)
    vu = _init(ju, hz, None)
    tu = U.port_from(tvgg.VGGUpscaler(UPS[up], 6, norm_type=norm, device="cpu"), vu)
    assert tu.b1_up.bias is None and tu.b1_up.kernel.shape == (16, 8, 4, 4)
    outs = tu(torch.tensor(hz))
    for a, r in zip(outs, jax.jit(ju.apply)(vu, hz, None)):
        U.assert_close_rel(a.detach(), r, 1e-5, "upscaler")
    assert [o.shape[-1] for o in outs] == tu.out_channels


def _rfn_config(up):
    return U.tiny_rfn_config(image_size=IMG, L=3, K=1, extractor_structure=EXT,
                             upscaler_structure=UPS[up], glow=dict(K=1))


def test_rfn_loss_and_predict_with_the_ops_match_jax():
    cfg = _rfn_config("both")
    jm, v = U.jax_rfn_variables(cfg)
    model = U.port_from(RFN(U.to_port(cfg), remat=False, device="cpu"), v)
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (B, T, IMG, IMG, 1)).astype(np.float32)
    key = jax.random.key(3)

    def objective(params):
        out = jm.apply({"params": params, "consts": v["consts"]}, x, key, method="loss")
        return out["nll"] + out["kl_free_bits"], out
    (_, ref), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(v["params"])
    noise = NoiseSource(replay=U.rfn_loss_noise(key, cfg, B, T))
    out = model.loss(torch.tensor(x), noise)
    assert noise.exhausted()
    for k in ref:
        U.assert_close_rel(out[k].detach(), ref[k], 1e-4, k)
    (out["nll"] + out["kl_free_bits"]).backward()
    U.assert_grads_close(model, grads, 1e-4)

    key = jax.random.key(4)
    _, ref = jax.jit(lambda v, x, k: jm.apply(v, x, 2, 2, k, method="predict"))(v, x, key)
    noise = NoiseSource(replay=U.rfn_predict_noise(key, cfg, B, 2, 2))
    with torch.no_grad():
        _, got = model.predict(torch.tensor(x), 2, 2, noise)
    assert noise.exhausted()
    U.assert_close_rel(got, ref, 2e-4, "predict")
