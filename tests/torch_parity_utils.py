"""Shared machinery for holding the PyTorch port against the JAX package.

Both sides get the same weights (a JAX init, perturbed off its zero inits,
converted with ``recurrent_flows_tpu_torch.convert.from_flax``) and the
same noise: the two frameworks cannot share a PRNG, so these helpers
replicate the JAX package's key splits and draw its eps in the order the
port consumes them.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_flows_tpu.config import GlowConfig, RFNConfig, TrainConfig
from recurrent_flows_tpu_torch import config as port_config
from recurrent_flows_tpu_torch.convert import from_flax

# the slice at a small size: image 64 with L=3, so scale 0 (32x32) takes
# the module path and scales 1-2 (16x16, 8x8) the chain kernel
IMG, CIN, L, K = 64, 1, 3, 2
HD, ZD, U = 8, 4, 16


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Under pytest-xdist several workers share the host's cores; torch
    ops this small lose more to contention between their threads than
    they gain, so a module that imports this fixture runs torch on two."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def tiny_rfn_config(**overrides) -> RFNConfig:
    glow = dict(L=L, K=K, n_units_affine=U, n_units_prior=16,
                chain_impl="sample")
    glow.update(overrides.pop("glow", {}))
    base = dict(
        x_channels=CIN, image_size=IMG, h_dim=HD, z_dim=ZD, a_dim=4, L=L, K=K,
        extractor_structure=((4, "pool", 8), (8, "pool", 8), (8, "pool", 16)),
        upscaler_structure=((16,), ("upsample", 8), ("upsample", 8)),
        prior_structure=(8,), encoder_structure=(8,), norm_type="none",
        norm_type_features="batchnorm", skip_connection_flow="with_skip",
        skip_connection_features=True, temperature=0.7,
        glow=GlowConfig(**glow),
    )
    base.update(overrides)
    return RFNConfig(**base)


def tiny_train_config() -> TrainConfig:
    return TrainConfig(batch_size=2, n_frames=6)


def to_port(cfg):
    """The port's own config dataclass from a JAX-package one (the port
    imports nothing of the JAX package; the field names are the same)."""
    cls = getattr(port_config, type(cfg).__name__)
    return port_config.config_from_dict(cls, dataclasses.asdict(cfg))


def perturb(tree, seed: int, scale: float = 0.05):
    """Add scale·N(0,1) to every leaf: moves the zero-initialised leaves
    (Conv2dZeros, realnvp scales, actnorms, peepholes, initial states) off
    zero so that every coupling net matters."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + scale * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


def jax_rfn_variables(cfg: RFNConfig, seed: int = 0, batch: int = 2,
                      remat: bool = False):
    """JAX RFN and its perturbed variables (init under jit)."""
    from recurrent_flows_tpu.models import RFN

    model = RFN(cfg, remat=remat)
    x0 = jnp.zeros((batch, 2, cfg.image_size, cfg.image_size, cfg.x_channels))
    v = jax.jit(model.init)(jax.random.key(seed), x0, jax.random.key(seed + 1))
    out = {"params": perturb(v["params"], seed), "consts": v.get("consts", {})}
    if "batch_stats" in v:  # running statistics as init leaves them
        out["batch_stats"] = v["batch_stats"]
    return model, out


def running_stats_like(tree, seed: int):
    """A batch_stats tree of the same shapes with running means N(0, 0.1²)
    and running variances e^{N(0, 0.2²)}: off 0/1 and off what an init pass
    leaves, so that normalising with them differs from normalising with a
    batch's statistics."""
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(a) if isinstance(a, dict) else
                (0.1 * rng.standard_normal(np.shape(a)) if k == "running_mean" else
                 np.exp(0.2 * rng.standard_normal(np.shape(a)))).astype(np.float32)
                for k, a in sorted(t.items())}
    return walk(tree)


def rfn_pair(cfg: RFNConfig, seed: int = 0):
    """(cfg, JAX RFN, its perturbed variables, the port's RFN on them)."""
    from recurrent_flows_tpu_torch.models import RFN as PortRFN

    jm, v = jax_rfn_variables(cfg, seed)
    return cfg, jm, v, port_from(PortRFN(to_port(cfg)), v)


def port_from(module: torch.nn.Module, variables) -> torch.nn.Module:
    module.load_state_dict(from_flax(variables["params"],
                                     variables.get("consts"), module,
                                     variables.get("batch_stats")))
    return module


# --- noise in the JAX package's order ----------------------------------------


def _normal(key, shape, dtype=jnp.float32):
    return np.asarray(jax.random.normal(key, shape, dtype))


def scale_shapes(gcfg: GlowConfig, x_channels: int, image_size: int):
    """Per flow scale l: (hw, channels of x in that scale)."""
    out, c, hw = [], x_channels, image_size
    for l in range(gcfg.L):
        c, hw = c * 4, hw // 2
        out.append((hw, c))
        if l < gcfg.L - 1:
            c //= 2
    return out


def flow_sample_noise(key, gcfg: GlowConfig, x_channels: int, image_size: int,
                      batch: int, base: bool = True, dtype=jnp.float32):
    """The eps ``ListGlow.sample(None, ..., key)`` draws: the base eps, then
    one per split, scale L-2 first (glow.py:622-627, :575-577,
    modules.py:566). ``base=False``: the draws of ``sample(z, ...)``, which
    splits off the base key and never uses it."""
    shapes = scale_shapes(gcfg, x_channels, image_size)
    rng_base, rng = jax.random.split(key)
    hw, c = shapes[-1]
    eps = [_normal(rng_base, (batch, hw, hw, c), dtype)] if base else []
    for l in reversed(range(gcfg.L - 1)):
        rng, sub = jax.random.split(rng)
        hw, c = shapes[l]
        eps.append(_normal(sub, (batch, hw, hw, c // 2), dtype))
    return eps


def rfn_predict_noise(key, cfg: RFNConfig, batch: int, n_conditions: int,
                      n_predictions: int):
    """The eps ``RFN.predict(..., key)`` draws, in the port's order
    (rfn.py:485-489, :466-468, :501-505)."""
    hu = cfg.image_size // (2 ** cfg.L)
    zshape = (batch, hu, hu, cfg.z_dim)
    rng_w, rng_r = jax.random.split(key)
    eps = []
    for k in jax.random.split(rng_w, n_conditions - 1):
        k1, k2 = jax.random.split(k)
        eps += [_normal(k1, zshape), _normal(k2, zshape)]
    for k in jax.random.split(rng_r, n_predictions):
        k1, k2 = jax.random.split(k)
        eps.append(_normal(k1, zshape))
        eps += flow_sample_noise(k2, cfg.glow, cfg.x_channels, cfg.image_size,
                                 batch)
    return eps


def _uniform(key, shape, n_bits: int, dtype=jnp.float32):
    return np.asarray(jax.random.uniform(key, shape, dtype, 0.0,
                                         1.0 / 2 ** n_bits))


def rfn_loss_noise(key, cfg: RFNConfig, batch: int, t: int, dtype=jnp.float32):
    """The draws ``RFN.loss(x, key)`` makes, in the port's order: per frame
    the prior eps, the encoder eps and the dequantization uniform
    (rfn.py:288, :308-310, glow.py:611), then one eps per overshoot depth
    (rfn.py:424-425). ``dtype`` float64 gives the draws of a run under
    ``jax.experimental.enable_x64``."""
    hu = cfg.image_size // (2 ** cfg.L)
    zshape = (batch, hu, hu, cfg.z_dim)
    xshape = (batch, cfg.image_size, cfg.image_size, cfg.x_channels)
    draws = []
    for k in jax.random.split(key, t - 1):
        k1, k2, k3 = jax.random.split(k, 3)
        draws += [_normal(k1, zshape, dtype), _normal(k2, zshape, dtype),
                  _uniform(k3, xshape, cfg.glow.n_bits, dtype)]
    if cfg.D > 0:
        for d in range(min(cfg.D + 1, t - 1)):
            draws.append(_normal(jax.random.fold_in(key, 1000 + d),
                                 (t - 1 - d,) + zshape, dtype))
    return draws


def rfn_ddi_noise(key, cfg: RFNConfig, batch: int):
    """The draws ``RFN.ddi(x, key)`` makes: the encoder eps, then the
    dequantization uniform (rfn.py:226-230)."""
    hu = cfg.image_size // (2 ** cfg.L)
    rng, k = jax.random.split(key)
    return [_normal(k, (batch, hu, hu, cfg.z_dim)),
            _uniform(rng, (batch, cfg.image_size, cfg.image_size,
                           cfg.x_channels), cfg.glow.n_bits)]


def assert_close_rel(got, ref, tol: float, what: str = ""):
    """Same shape, finite, and every element within tol·(1+|ref|)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - ref) / (1.0 + np.abs(ref))
    assert err.max() <= tol, (what, float(err.max()))


def with_glow(cfg: RFNConfig, **glow) -> RFNConfig:
    return dataclasses.replace(cfg, glow=dataclasses.replace(cfg.glow, **glow))


# --- the draws of RFN's other methods (rfn.py:514-747) ------------------------


def _shapes(cfg: RFNConfig, batch: int):
    hu = cfg.image_size // (2 ** cfg.L)
    return ((batch, hu, hu, cfg.z_dim),
            (batch, cfg.image_size, cfg.image_size, cfg.x_channels))


def _flow(key, cfg, batch, base=True, dtype=jnp.float32):
    return flow_sample_noise(key, cfg.glow, cfg.x_channels, cfg.image_size, batch, base,
                             dtype)


def posterior_scan_noise(key, cfg: RFNConfig, batch: int, t: int):
    """``RFN._posterior_scan(x [B, t, ...], key)``: per step the prior eps,
    then the encoder eps (rfn.py:572, :590-592)."""
    zshape, _ = _shapes(cfg, batch)
    eps = []
    for k in jax.random.split(key, t - 1):
        k1, k2 = jax.random.split(k)
        eps += [_normal(k1, zshape), _normal(k2, zshape)]
    return eps


def rfn_reconstruct_noise(key, cfg: RFNConfig, batch: int, t: int, dtype=jnp.float32):
    """``RFN.reconstruct``: per frame the encoder eps, the dequantization
    uniform, recons_flow's split eps, recons' base and split eps
    (rfn.py:545-552). ``dtype`` as in ``rfn_loss_noise``."""
    zshape, xshape = _shapes(cfg, batch)
    eps = []
    for k in jax.random.split(key, t - 1):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        eps += [_normal(k1, zshape, dtype), _uniform(k2, xshape, cfg.glow.n_bits, dtype)]
        eps += _flow(k3, cfg, batch, False, dtype) + _flow(k4, cfg, batch, True, dtype)
    return eps


def rfn_sample_noise(key, cfg: RFNConfig, batch: int, n: int):
    """``RFN.sample``: per frame the prior eps, then a flow sample
    (rfn.py:737, :749-752)."""
    zshape, _ = _shapes(cfg, batch)
    eps = []
    for k in jax.random.split(key, n):
        k1, k2 = jax.random.split(k)
        eps += [_normal(k1, zshape)] + _flow(k2, cfg, batch)
    return eps


def rfn_param_analysis_noise(key, cfg: RFNConfig, batch: int, t: int):
    """The scan, then a flow sample per frame (rfn.py:609-623)."""
    eps = posterior_scan_noise(key, cfg, batch, t)
    for k in jax.random.split(jax.random.fold_in(key, 1), t - 1):
        eps += _flow(k, cfg, batch)
    return eps


def rfn_probability_future_noise(key, cfg: RFNConfig, batch: int, t: int,
                                 n_conditions: int):
    """The scan over the context, then one uniform per future frame; the
    JAX package uses the same keys for both latents (rfn.py:648-661)."""
    _, xshape = _shapes(cfg, batch)
    eps = posterior_scan_noise(key, cfg, batch, n_conditions)
    for k in jax.random.split(jax.random.fold_in(key, 2), t - n_conditions):
        eps.append(_uniform(k, xshape, cfg.glow.n_bits))
    return eps


def rfn_elbo_gap_noise(key, cfg: RFNConfig, batch: int, t: int, sample: bool = True):
    """The scan, then per frame and latent (prior, posterior) the uniform
    and, with ``sample``, recons_flow's split eps and a flow sample
    (rfn.py:676-700)."""
    _, xshape = _shapes(cfg, batch)
    eps = posterior_scan_noise(key, cfg, batch, t)
    for k in jax.random.split(jax.random.fold_in(key, 3), t - 1):
        for kk in (0, 1):
            k1, k2, k3 = jax.random.split(jax.random.fold_in(k, kk), 3)
            eps.append(_uniform(k1, xshape, cfg.glow.n_bits))
            if sample:
                eps += _flow(k2, cfg, batch, base=False) + _flow(k3, cfg, batch)
    return eps


def assert_grads_close(model: torch.nn.Module, jax_grads, tol: float = 1e-4):
    """Every parameter's ``.grad`` within tol of the largest |entry| of the
    JAX gradient of the same tensor (converted by ``tree_from_flax``)."""
    from recurrent_flows_tpu_torch.convert import tree_from_flax

    want = tree_from_flax(jax_grads, model)
    floor = 1e-7 * max(w.abs().max().item() for w in want.values())
    for name, p in model.named_parameters():
        ref = want[name].double().numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.double().numpy()
        err = np.abs(got - ref).max()
        assert err <= max(tol * np.abs(ref).max(), floor), (name, float(err),
                                                              float(np.abs(ref).max()))
