"""The port's ``VRNN1D`` against ``recurrent_flows_tpu.models.vrnn1d`` on
the CPU: ``loss`` (its pieces and the gradients of nll + kl_free_bits),
and ``predict``, on JAX weights (perturbed off the zero
inits) converted by ``convert.from_flax`` (the names ``lstm.gates``,
``phi_x``, ``phi_z``, ``prior``/``enc``/``dec``, ``h_0``/``c_0``/``z_0x``
need no code), with JAX's draws replayed in the order of the port's
docstring.

Sizes: h 16, z 4, feat 8; sinusoids [4, 12, 1]. Tolerances: the loss pieces
1e-4·(1+|ref|), gradients 1e-4 of each tensor's largest |entry|, the
predicted means 1e-5·(1+|ref|)."""

import jax
import numpy as np
import torch

import torch_parity_utils as U
from torch_parity_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
from recurrent_flows_tpu.data import SinusWithNoise as JSinus
from recurrent_flows_tpu.models.vrnn1d import VRNN1D as JVRNN1D
from recurrent_flows_tpu_torch.convert import from_flax
from recurrent_flows_tpu_torch.models import VRNN1D
from recurrent_flows_tpu_torch.utils import NoiseSource

H, Z, FEAT, B, T = 16, 4, 8, 4, 12


def _pair():
    x = np.asarray(JSinus(seq_len=T).sample(jax.random.key(0), B))
    jm = JVRNN1D(h_dim=H, z_dim=Z, feat_dim=FEAT)
    v = jax.jit(jm.init)(jax.random.key(1), x, jax.random.key(2))
    v = {"params": U.perturb(v["params"], 1)}
    pm = VRNN1D(H, Z, FEAT, device="cpu")
    names = set(from_flax(v["params"], None, pm))
    assert {"lstm.gates.kernel", "phi_x.fc1.bias", "phi_z.fc0.kernel", "prior.std.kernel",
            "enc.mean.bias", "dec.fc0.kernel", "h_0", "c_0", "z_0x"} <= names
    return x, jm, v, U.port_from(pm, v)


def _normals(keys, shape):
    return [np.asarray(jax.random.normal(k, shape)) for k in keys]


def test_loss_and_gradients_match_jax():
    x, jm, v, pm = _pair()
    key = jax.random.key(3)

    def objective(p):
        out = jm.apply({"params": p}, x, key, method="loss")
        return out["nll"] + out["kl_free_bits"], out
    (_, ref), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(v["params"])
    noise = NoiseSource(replay=_normals(jax.random.split(key, T - 1), (B, Z)))
    out = pm.loss(torch.tensor(x), noise)
    assert noise.exhausted() and set(out) == set(ref)
    for k in ref:
        U.assert_close_rel(out[k].detach(), ref[k], 1e-4, k)
    (out["nll"] + out["kl_free_bits"]).backward()
    U.assert_grads_close(pm, grads, 1e-4)
    assert pm.h_0.grad.abs().sum() > 0  # the learned initial state is trained


def test_predict_matches_jax():
    x, jm, v, pm = _pair()
    key = jax.random.key(4)
    n_pred, n_cond = 5, 4
    true_x, ref = jm.apply(v, x, n_pred, n_cond, key, method="predict")
    kw, kr = jax.random.split(key)
    noise = NoiseSource(replay=_normals(jax.random.split(kw, n_cond - 1), (B, Z))
                        + _normals(jax.random.split(kr, n_pred), (B, Z)))
    with torch.no_grad():
        got_x, got = pm.predict(torch.tensor(x), n_pred, n_cond, noise)
    assert noise.exhausted() and got.shape == (n_pred, B, 1)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(true_x))
    U.assert_close_rel(got, ref, 1e-5, "predict")
