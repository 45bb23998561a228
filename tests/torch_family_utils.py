"""Holding the port's SRNN, VRNN and SVG against the JAX package.

Both sides get the same weights (a JAX init, perturbed off its zero
inits, converted by ``recurrent_flows_tpu_torch.convert.from_flax``) and
the same noise: these helpers replicate the JAX package's key splits and
list its draws in the order the port consumes them (the orders in the
docstrings of ``recurrent_flows_tpu_torch/models/{srnn,vrnn,svg}.py``).

Sizes of ``tests/test_srnn_vrnn.py`` and ``tests/test_svg.py``: B=2, T=4,
16x16 gray frames, h=8, z=4 (SVG: g=16, rnn 16, z=4).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_parity_utils as U
from torch_parity_utils import _two_torch_threads  # noqa: F401 (the modules import it from here)
from recurrent_flows_tpu.config import SRNNConfig, SVGConfig, VRNNConfig
from recurrent_flows_tpu.models.srnn import SRNN as JSRNN
from recurrent_flows_tpu.models.svg import SVG as JSVG
from recurrent_flows_tpu.models.vrnn import VRNN as JVRNN
from recurrent_flows_tpu_torch import models as port_models

B, T, IMG = 2, 4, 16


JAX_MODELS = {"SRNN": JSRNN, "VRNN": JVRNN, "SVG": JSVG}


def config(family: str, **kw):
    """The family's small JAX config (``norm_type`` batchnorm unless given)."""
    if family == "SRNN":
        base = dict(x_channels=1, image_size=IMG, h_dim=8, z_dim=4, a_dim=8)
        return SRNNConfig(**{**base, **kw})
    if family == "VRNN":
        return VRNNConfig(**{**dict(x_channels=1, image_size=IMG, h_dim=8, z_dim=4), **kw})
    base = dict(x_channels=1, image_size=IMG, z_dim=4, c_features=16, h_dim=16)
    return SVGConfig(**{**base, **kw})


def family_of(cfg) -> str:
    return type(cfg).__name__[:-len("Config")]


@functools.lru_cache(maxsize=None)
def _init(cfg, seed: int, scale: float):
    model = JAX_MODELS[family_of(cfg)](cfg, remat=False)
    x0 = jnp.zeros((B, 2, cfg.image_size, cfg.image_size, cfg.x_channels))
    v = jax.jit(model.init)(jax.random.key(seed), x0, jax.random.key(seed + 1))
    out = {"params": U.perturb(v["params"], seed, scale)}
    if "batch_stats" in v:
        out["batch_stats"] = jax.tree.map(np.asarray, v["batch_stats"])
    return model, out


def jax_variables(cfg, seed: int = 0, scale: float = 0.01):
    """The JAX model (remat off) and its variables: the init's parameters
    perturbed by scale·N(0,1) (the peepholes and initial states start at
    zero), and its running statistics where it tracks them. Made once per
    configuration in a process (the jitted init takes ~9 s on the CPU); the
    caller gets its own dict."""
    model, v = _init(cfg, seed, scale)
    return model, dict(v)


def port_model(cfg, variables, **kw):
    """The port's model of the same family on the JAX weights (CPU)."""
    cls = getattr(port_models, family_of(cfg))
    return U.port_from(cls(U.to_port(cfg), device="cpu", **kw), variables)


def pair(cfg, seed: int = 0, **kw):
    """(JAX model, its variables, the port's model on them)."""
    jm, v = jax_variables(cfg, seed)
    return jm, v, port_model(cfg, v, **kw)


def frames(cfg, seed: int = 0, t: int = T, batch: int = B):
    """Inputs in the model space of ``cfg``'s loss: [-1, 1] for 'mol', else
    [0, 1]."""
    x = np.random.default_rng(seed).uniform(
        0, 1, (batch, t, cfg.image_size, cfg.image_size, cfg.x_channels)).astype(np.float32)
    return 2 * x - 1 if cfg.loss_type == "mol" else x


# --- JAX's draws in the port's order ------------------------------------------


def _normal(key, shape, dtype=jnp.float32):
    return np.asarray(jax.random.normal(key, shape, dtype))


def _xshape(cfg, batch):
    return (batch, cfg.image_size, cfg.image_size, cfg.x_channels)


def _dequant(key, cfg, batch, dtype=jnp.float32):
    """The likelihood's dequantization uniform, where it draws one."""
    if family_of(cfg) == "SVG" or cfg.loss_type != "gaussian" or not cfg.dequantize:
        return []
    return [np.asarray(jax.random.uniform(key, _xshape(cfg, batch), dtype, 0.0,
                                          1.0 / 2.0 ** cfg.n_bits))]


def _decode(key, cfg, batch, dtype=jnp.float32):
    """``LikelihoodHead.decode``'s draws: the mixture's Gumbel uniform, then
    its logistic uniform, for 'mol'."""
    if family_of(cfg) == "SVG" or cfg.loss_type != "mol":
        return []
    n_mix = cfg.n_logistics
    k1, k2 = jax.random.split(key)
    shape = _xshape(cfg, batch)
    return [np.asarray(jax.random.uniform(k1, shape[:-1] + (n_mix,), dtype, 1e-5,
                                          1.0 - 1e-5)),
            np.asarray(jax.random.uniform(k2, shape, dtype, 1e-5, 1.0 - 1e-5))]


def loss_noise(key, cfg, batch: int = B, t: int = T, dtype=jnp.float32):
    z = (batch, cfg.z_dim)
    fam, eps = family_of(cfg), []
    for k in jax.random.split(key, t - 1):
        if fam == "SVG":
            eps.append(_normal(k, z, dtype))
        elif fam == "VRNN":
            k1, k2 = jax.random.split(k)
            eps += [_normal(k1, z, dtype)] + _dequant(k2, cfg, batch, dtype)
        else:
            k1, k2, k3 = jax.random.split(k, 3)
            eps += [_normal(k1, z, dtype), _normal(k2, z, dtype)] + _dequant(k3, cfg, batch,
                                                                              dtype)
    if fam == "SRNN" and cfg.D > 0:
        for d in range(min(cfg.D + 1, t - 1)):
            eps.append(_normal(jax.random.fold_in(key, 2000 + d), (t - 1 - d,) + z, dtype))
    return eps


def _rollout(keys, cfg, batch, dtype):
    eps = []
    for k in keys:
        if family_of(cfg) == "SVG":
            eps.append(_normal(k, (batch, cfg.z_dim), dtype))
        else:
            k1, k2 = jax.random.split(k)
            eps += [_normal(k1, (batch, cfg.z_dim), dtype)] + _decode(k2, cfg, batch, dtype)
    return eps


def predict_noise(key, cfg, n_conditions: int, n_predictions: int, batch: int = B,
                  dtype=jnp.float32):
    z = (batch, cfg.z_dim)
    kw, kr = jax.random.split(key)
    eps = []
    for k in jax.random.split(kw, n_conditions - 1):
        if family_of(cfg) == "VRNN":
            k1, k2 = jax.random.split(k)
            eps += [_normal(k1, z, dtype), _normal(k2, z, dtype)]
        else:
            eps.append(_normal(k, z, dtype))
    return eps + _rollout(jax.random.split(kr, n_predictions), cfg, batch, dtype)


def reconstruct_noise(key, cfg, batch: int = B, t: int = T, dtype=jnp.float32):
    return _rollout(jax.random.split(key, t - 1), cfg, batch, dtype)


def sample_noise(key, cfg, n: int, batch: int = B, dtype=jnp.float32):
    return _rollout(jax.random.split(key, n), cfg, batch, dtype)


def iw_noise(key, cfg, k_samples: int, batch: int = B, t: int = T, dtype=jnp.float32):
    z = (batch, cfg.z_dim)
    fam, eps = family_of(cfg), []
    for key_t in jax.random.split(key, t - 1):
        if fam == "SVG":
            eps.append(_normal(key_t, z, dtype))
        for k in jax.random.split(key_t, k_samples):
            if fam == "SVG":
                eps.append(_normal(k, z, dtype))
            else:
                k1, k2 = jax.random.split(k)
                eps += [_normal(k1, z, dtype)] + _dequant(k2, cfg, batch, dtype)
        if fam == "SRNN":
            eps.append(_normal(jax.random.fold_in(key_t, 7), z, dtype))
    return eps


def refresh_noise(key, cfg, batch: int = B):
    """The init-only pass's draws (``stats_refresh``)."""
    if family_of(cfg) == "SVG":
        return [_normal(key, (batch, cfg.z_dim))]
    return _dequant(key, cfg, batch) + _decode(key, cfg, batch)


# --- the parity checks each family's test file runs ---------------------------

# tolerances: float32 on both sides, each loss piece and each output element
# within 1e-5·(1+|ref|), each parameter's gradient within rtol 1e-4 and atol
# 1e-4 of the tensor's largest entry (the RFN tests' limits; measured with
# norm_type 'none': 1e-8 to 2e-7 on the losses and outputs, up to 1.5e-6
# on the gradients). A batch norm over B=2 samples of a 1x1 map (the Gaussian
# heads' trunk at 16x16 frames) is ill-conditioned in float32: JAX's own
# float32 gradients differ from its float64 ones by up to 10 times the
# tensor's largest entry. So the batch-norm cases run in float64 on both
# sides (JAX under enable_x64). JAX's ConvLSTMCell still computes its gates
# and states in float32 there, so the port's gates do too in these cases
# (``_gates_as_jax``), and the batch norm amplifies those roundings: the
# losses agree within 1.2e-6·(1+|ref|) and the gradients within 4.9e-4 of
# the tensor's largest entry beyond rtol 1e-4 (SRNN; VRNN 8e-7; SVG, with
# no ConvLSTM, 1e-15). There the limits are 1e-5 on the losses and outputs
# and an atol of 1e-3 of the tensor's largest entry on the gradients. A
# gradient that is zero by construction (a conv bias in front of a batch
# norm) is float noise on both sides, so the atol never goes below 1e-6 of
# the model's largest gradient entry.
TOL = {False: dict(out=1e-5, rtol=1e-4, atol=1e-4), True: dict(out=1e-5, rtol=1e-4, atol=1e-3)}
BETA = 0.5


def _gates_as_jax(gates, c, *peepholes):
    """The ConvLSTM update as the JAX package computes it under enable_x64:
    the gates cast to float32, the new states stored in float32."""
    from recurrent_flows_tpu_torch.ops import convlstm_gates_ref

    h, c = convlstm_gates_ref(gates.float().to(c.dtype), c, *peepholes)
    return h.float().to(c.dtype), c.float().to(c.dtype)


def _setup(cfg, monkeypatch, f64: bool, eval_norm: bool, remat: bool = False):
    """(JAX model, variables in the working dtype, the port's model, the
    dtype): ``eval_norm`` with running statistics off 0/1."""
    jm, v = jax_variables(cfg)
    if eval_norm:
        v["batch_stats"] = U.running_stats_like(v["batch_stats"], 6)
        jm = JAX_MODELS[family_of(cfg)](cfg, remat=False, eval_norm=True)
    pm = port_model(cfg, v, remat=remat, eval_norm=eval_norm)
    dtype = np.float64 if f64 else np.float32
    if f64:
        from recurrent_flows_tpu_torch.nn import convlstm

        monkeypatch.setattr(convlstm, "convlstm_gates", _gates_as_jax)
        pm = pm.double()
    return jm, jax.tree.map(lambda a: np.asarray(a, dtype), v), pm, dtype


def _close(got, ref, tol, what):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    U.assert_close_rel(got, np.asarray(ref), tol, what)


def check_loss_and_grads(cfg, monkeypatch, f64=False, remat=False, eval_norm=False):
    """``loss``'s pieces and the gradients of nll + BETA·kl_free_bits
    against the JAX package, every JAX draw replayed and consumed."""
    from recurrent_flows_tpu_torch.convert import tree_from_flax
    from recurrent_flows_tpu_torch.utils import NoiseSource

    jm, v, pm, dtype = _setup(cfg, monkeypatch, f64, eval_norm, remat)
    x, key = frames(cfg).astype(dtype), jax.random.key(3)
    with jax.enable_x64(f64):
        def objective(params):
            out = jm.apply({**v, "params": params}, x, key, method="loss")
            return out["nll"] + BETA * out["kl_free_bits"], out

        (_, ref), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(v["params"])
        draws = loss_noise(key, cfg, dtype=dtype)
    noise = NoiseSource(replay=draws)
    out = pm.loss(torch.tensor(x), noise)
    assert noise.exhausted()  # every JAX draw consumed, in JAX's order
    assert set(out) == {"kl_free_bits", "kl", "nll"}
    for k, r in ref.items():
        _close(out[k], r, TOL[f64]["out"], k)
    (out["nll"] + BETA * out["kl_free_bits"]).backward()
    want = tree_from_flax(grads, pm)
    floor = 1e-6 * max(r.abs().max().item() for r in want.values())
    for name, p in pm.named_parameters():
        r = want[name].double().numpy()
        if p.grad is None:  # a parameter this configuration does not use
            assert not r.any(), name
            continue
        np.testing.assert_allclose(p.grad.double().numpy(), r, rtol=TOL[f64]["rtol"],
                                   atol=max(TOL[f64]["atol"] * np.abs(r).max(), floor),
                                   err_msg=name)
    return pm


def check_methods(cfg, monkeypatch, f64=False, eval_norm=False, n_cond=2, n_pred=3,
                  k_samples=3):
    """``predict``, ``reconstruct``, ``sample`` and
    ``elbo_importance_weighting`` against the JAX package."""
    from recurrent_flows_tpu_torch.utils import NoiseSource

    jm, v, pm, dtype = _setup(cfg, monkeypatch, f64, eval_norm)
    x = frames(cfg, seed=1).astype(dtype)
    xt = torch.tensor(x)
    calls = {
        "predict": (lambda v, k: jm.apply(v, x, n_pred, n_cond, k, method="predict")[1],
                    lambda n: pm.predict(xt, n_pred, n_cond, n)[1],
                    lambda k: predict_noise(k, cfg, n_cond, n_pred, dtype=dtype)),
        "reconstruct": (lambda v, k: jm.apply(v, x, k, method="reconstruct"),
                        lambda n: pm.reconstruct(xt, n),
                        lambda k: reconstruct_noise(k, cfg, dtype=dtype)),
        "sample": (lambda v, k: jm.apply(v, x, n_pred, k, method="sample"),
                   lambda n: pm.sample(xt, n_pred, n),
                   lambda k: sample_noise(k, cfg, n_pred, dtype=dtype)),
        "elbo_importance_weighting": (
            lambda v, k: jm.apply(v, x, k_samples, k, method="elbo_importance_weighting"),
            lambda n: pm.elbo_importance_weighting(xt, k_samples, n),
            lambda k: iw_noise(k, cfg, k_samples, dtype=dtype)),
    }
    for i, (name, (ref_fn, port_fn, draws_fn)) in enumerate(calls.items()):
        key = jax.random.key(10 + i)
        with jax.enable_x64(f64):  # jitted: its compile is shorter than eager dispatch
            ref, draws = jax.jit(ref_fn)(v, key), draws_fn(key)
        noise = NoiseSource(replay=draws)
        got = port_fn(noise)
        assert noise.exhausted(), name
        assert got.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype, name
        _close(got, ref, TOL[f64]["out"], name)


def check_stats_refresh(cfg, n_norms: int):
    """``stats_refresh`` moves every running statistic of the ``n_norms``
    tracking batch norms as the JAX package's init-only pass applied with
    ``mutable=['batch_stats']`` does, and returns its nll."""
    from recurrent_flows_tpu_torch.utils import NoiseSource

    jm, v, pm = pair(cfg)
    x, key = frames(cfg), jax.random.key(4)
    nll, upd = jm.apply(v, x, key, method="stats_refresh", mutable=["batch_stats"])
    noise = NoiseSource(replay=refresh_noise(key, cfg))
    got = pm.stats_refresh(torch.tensor(x), noise)
    assert noise.exhausted()
    _close(got, nll, TOL[False]["out"], "nll")
    want = dict(port_model(cfg, {"params": v["params"],
                                 "batch_stats": upd["batch_stats"]}).named_buffers())
    assert len(want) == 2 * n_norms
    for n, b in pm.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[n].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
        init = torch.zeros_like(b) if n.endswith("running_mean") else torch.ones_like(b)
        assert not torch.equal(b, init), n
